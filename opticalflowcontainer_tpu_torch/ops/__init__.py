"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions: K1 ``farneback_update``, K2 ``blur_solve``, K3
``warp_bilinear`` and K4 ``correlation``; and the flow ops of the
reference's ``ops/``:

- :func:`local_correlation`, the local cost volume of every correlation
  configuration in the zoo (K4 on the card), and
  :func:`correlation_plain`, its plain version (the reference's
  ``correlation_lax``);
- :func:`all_pairs_correlation`, :func:`corr_pyramid`,
  :func:`corr_lookup`, RAFT's volume path;
- :func:`unfold`, patch extraction for LiteFlowNet's regularization.

``from .unfold import unfold`` binds the function over the submodule's
name here, as in the reference: import the module's other names with
``from ...ops.unfold import ...``.
"""
from .allpairs import all_pairs_correlation, corr_lookup, corr_pyramid
from .correlation import correlation_plain, local_correlation
from .unfold import unfold

__all__ = [
    "local_correlation",
    "correlation_plain",
    "all_pairs_correlation",
    "corr_pyramid",
    "corr_lookup",
    "unfold",
]
