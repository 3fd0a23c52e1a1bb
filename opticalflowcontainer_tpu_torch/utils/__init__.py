"""Host-side file IO of the port: Middlebury ``.flo`` flow files and PNG
images, on numpy and the standard library (the card's machine has no cv2
and no PIL)."""
from .flo import read_flo, write_flo
from .png import imread, imwrite

__all__ = ["imread", "imwrite", "read_flo", "write_flo"]
