"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions: K1 ``farneback_update`` and K2 ``blur_solve``."""
