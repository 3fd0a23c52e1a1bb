"""Device selection and the cv2-parity image primitives the flow path uses
(reference ``core/``): filters, resizes, warps, pyramids and colour, on
float tensors with trailing spatial dims ``[..., H, W]`` (gray) or
``[..., H, W, C]`` (colour)."""
from .color import bgr_to_gray, bgr_to_rgb, flow_to_hsv_rgb, normalize_image, rgb_to_gray
from .filters import (
    bilateral_filter,
    box_filter,
    clahe,
    gaussian_blur,
    gaussian_kernel_1d,
    median_filter,
    scharr_deriv,
    sobel,
)
from .pyramid import gaussian_pyramid, image_pyramid_resize, pyr_down
from .resize import resize_area, resize_bilinear
from .warp import (
    flow_grid_sample,
    warp_align_corners,
    warp_bilinear,
    warp_half_pixel,
    warp_with_mask,
)

__all__ = [
    "gaussian_kernel_1d",
    "gaussian_blur",
    "box_filter",
    "median_filter",
    "bilateral_filter",
    "clahe",
    "sobel",
    "scharr_deriv",
    "resize_bilinear",
    "resize_area",
    "warp_bilinear",
    "warp_align_corners",
    "warp_half_pixel",
    "warp_with_mask",
    "flow_grid_sample",
    "pyr_down",
    "gaussian_pyramid",
    "image_pyramid_resize",
    "bgr_to_rgb",
    "rgb_to_gray",
    "bgr_to_gray",
    "flow_to_hsv_rgb",
    "normalize_image",
]
