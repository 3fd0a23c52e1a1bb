"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions: K1 ``farneback_update``, K2 ``blur_solve``, K3
``warp_bilinear`` and K4 ``correlation``."""
