"""The backward of a kernel that has none of its own: the autograd of its
plain PyTorch version, recomputed from the saved inputs.  The reference
does the same for its correlation kernel (a ``jax.custom_vjp`` whose
backward is ``jax.vjp`` of the XLA form); K3 and K4 use it."""
from __future__ import annotations

import torch


def plain_vjp(plain, inputs, needs, grad, *args) -> tuple:
    """The gradients of ``plain(*inputs, *args)`` with respect to the
    ``inputs`` that ``needs`` marks, for the output gradient ``grad``: the
    plain version recomputed under autograd.  None for the rest, and for
    each of ``args``."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
        out = plain(*leaves, *args)
        wanted = [t for t in leaves if t.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(got) if t.requires_grad else None for t in leaves) + (
        None,) * len(args)

