"""PyTorch/CUDA port of ``opticalflowcontainer_tpu`` for NVIDIA Hopper (H100).

The JAX package beside this one stays the reference; this package keeps its
own copy of everything it needs and imports neither JAX nor cv2.  Layout
mirrors the reference (``core``, ``ops``, ``classical``, ``models``,
``runtime``) so each module's counterpart is found under the same name.

Entry points run on CUDA unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit CPU request they raise.  The reference's four
TPU kernels are hand-written CUDA kernels here (``ops/csrc``): the Farneback
update and blur+solve, the bilinear warp and the local correlation, built
with one ``nvcc`` call at first use and loaded with ``ctypes``.
"""

__version__ = "0.1.0"
