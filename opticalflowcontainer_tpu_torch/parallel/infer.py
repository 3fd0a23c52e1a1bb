"""Sharded inference over a ``("data", "model")`` mesh (reference
``parallel/infer.py``).

The reference wraps a flow function in ``shard_map`` over the global batch.
The port is SPMD with one process per rank (``mesh.py``), so each callable
returned here takes **this rank's block** and returns this rank's block;
a caller that wants the global array gathers the blocks.  The flow stays
local (no communication on the hot path); what crosses ranks is the
scalar velocity aggregate and, in the spatial form, the height bands.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .mesh import all_gather_cat, mesh_device


def make_sharded_flow_fn(flow_fn: Callable, mesh: DeviceMesh) -> Callable:
    """``flow_fn``: (prev [b, H, W], cur [b, H, W]) -> flow [b, H, W, 2]
    on this rank's batch rows.  Returns ``(prev, cur) -> (flow, mean_u)``:
    the local flow and the global mean of u, the sum of u over the
    ``data`` group divided by the count over it (the reference's two
    ``psum``s)."""
    group = mesh.get_group("data")

    def run(prev, cur):
        flow = flow_fn(prev, cur)
        u = flow[..., 0]
        stats = torch.stack([u.sum(), torch.tensor(
            float(u.numel()), dtype=u.dtype, device=u.device)])
        dist.all_reduce(stats, group=group)
        return flow, stats[0] / stats[1]

    return run


def make_sharded_stream_fn(mesh: DeviceMesh, share: str = "all",
                           **fb_kwargs) -> Callable:
    """Multi-stream scale-out: this rank's live camera streams, each
    running the stateful Farneback stream step
    (:func:`~..classical.farneback.farneback_stream_step`: every frame
    expanded once, the planes carried as state) on the mesh's device.  No
    communication: each stream's scalar stays on its rank.  The sharded
    twin of the multi-stream batcher's steady program.

    Returns ``(state, gray [n, H, W]) -> (du [n], state2)``, ``du`` the
    mean u of each stream.  Seed the state with ``farneback_stream_planes``
    on the rank's [n, H, W] frames."""
    from ..classical import farneback as fb

    device = mesh_device(mesh)

    def run(state, gray):
        flow, state2 = fb.farneback_stream_step(state, gray, share=share,
                                                device=device, **fb_kwargs)
        return flow[..., 0].mean(dim=(1, 2)), state2

    return run


def make_spatial_sharded_flow_fn(flow_fn: Callable, mesh: DeviceMesh) -> Callable:
    """Big-frame form: the batch rows on ``data`` and a band of the image
    height (dim 1 of [b, h, W] frames or [b, h, W, C] images) on ``model``.

    This form all-gathers the bands over the ``model`` group and runs
    ``flow_fn`` on the full height, so it returns the rank's batch rows at
    full height: what the reference's ``out_shardings=None`` returns
    replicated.  Each rank of a ``model`` group computes the same rows.
    Unlike the reference, whose SPMD partitioning cannot split the TPU
    Farneback kernel, it is exact for every ``flow_fn``, K1/K2 included.
    Exchanging only the halo each stage needs, and computing only the
    band, is later speed work (ROADMAP)."""
    group = mesh.get_group("model")

    def run(prev, cur):
        return flow_fn(all_gather_cat(torch.as_tensor(prev), group, 1),
                       all_gather_cat(torch.as_tensor(cur), group, 1))

    return run
