"""Device mesh, sharding rules and the collectives of the port's scale-out
(reference ``parallel/mesh.py``), on ``torch.distributed``.

The reference is SPMD inside one program: a ``jax.sharding.Mesh`` over the
chips and ``NamedSharding`` specs that XLA partitions.  The port is SPMD
with one process per rank: each process calls :func:`init_distributed`,
builds the same :func:`make_mesh`, takes its own block of a global array
(:func:`local_shard`) and runs the sharded callables of ``infer`` and
``train`` on it.

- **Layout.** The mesh's dims are named ``("data", "model")`` and rank
  ``r`` sits at ``(r // model, r % model)``: the JAX grid's row-major
  ``reshape(data, model)``.  On a 2x2 mesh the ``data`` groups are {0, 2}
  and {1, 3}, the ``model`` groups {0, 1} and {2, 3}.
- **Devices.** The card unless the caller asks for the CPU: ``"cuda"``
  runs NCCL with one rank per card, ``"cpu"`` runs gloo.  Asking for CUDA
  without a card raises; nothing falls back to gloo on the CPU.  Two ranks
  may share one card only over gloo (NCCL refuses two ranks on one device),
  whose ``all_reduce`` and ``all_gather`` take CUDA tensors.
"""
from __future__ import annotations

import datetime

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "model")
# a collective that waits longer than this raises instead of hanging
TIMEOUT_S = 120.0


def init_distributed(rank: int, world_size: int, init_method: str, *,
                     device_type: str = "cuda", backend: str | None = None,
                     timeout_s: float = TIMEOUT_S) -> None:
    """``torch.distributed.init_process_group`` for this rank.

    ``init_method`` is explicit: a ``file://`` store lets concurrent jobs
    (test workers) meet without racing for a TCP port; ``tcp://host:port``
    works too.  ``device_type="cuda"`` (the default) needs a card, selects
    card ``rank % device_count`` and defaults to NCCL; ``"cpu"`` defaults
    to gloo.  A collective that waits ``timeout_s`` raises."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device_type='cpu' to run gloo on the CPU")
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = backend or "nccl"
    elif device_type == "cpu":
        backend = backend or "gloo"
        if backend != "gloo":
            raise ValueError(f"backend {backend!r} on the CPU: only gloo")
    else:
        raise ValueError(f"device_type {device_type!r}: use 'cuda' or 'cpu'")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int = 1, *, device_type: str = "cuda") -> DeviceMesh:
    """``("data", "model")`` mesh over the first ``data * model`` ranks of
    the process group (module docstring for the layout).

    Defaults, as the reference's: every rank (or the first ``n_devices``)
    on the data axis.  Raises when the group is not initialised, when
    ``data * model`` exceeds the ranks, or when CUDA is asked for without
    a card."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device_type='cpu' for a mesh on the CPU")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type {device_type!r}: use 'cuda' or 'cpu'")
    n = dist.get_world_size()
    if n_devices is not None:
        n = min(n, n_devices)
    if data is None:
        data = n // model
    if data < 1 or model < 1 or data * model > n:
        raise ValueError(f"need {data * model} ranks for a {data}x{model} "
                         f"mesh, have {n}")
    grid = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=AXES)


def batch_sharding(mesh: DeviceMesh, spatial_dim: int | None = None) -> tuple:
    """Placements over ``mesh``'s (data, model) dims: the batch (dim 0) on
    ``data``, and ``spatial_dim`` on ``model`` where given."""
    _check_mesh(mesh)
    if spatial_dim is None:
        return (Shard(0), Replicate())
    if spatial_dim < 1:
        raise ValueError(f"spatial_dim {spatial_dim}: dim 0 is the batch")
    return (Shard(0), Shard(spatial_dim))


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements of a tensor every rank holds whole."""
    _check_mesh(mesh)
    return (Replicate(), Replicate())


def _check_mesh(mesh: DeviceMesh) -> None:
    if tuple(mesh.mesh_dim_names or ()) != AXES:
        raise ValueError(f"mesh dims {mesh.mesh_dim_names}, expected {AXES}")


def local_shard(x, mesh: DeviceMesh, placements: tuple):
    """This rank's block of the global ``x`` (a tensor or a numpy array,
    returned as the same kind): along each ``Shard(d)`` placement, the
    slice of dim ``d`` at the rank's coordinate on that mesh dim.  Raises
    where the mesh dim does not divide dim ``d`` (the reference's
    ``NamedSharding`` refuses such a batch too)."""
    _check_mesh(mesh)
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    for axis, p in enumerate(placements):
        if not isinstance(p, Shard):
            continue
        n = mesh.size(axis)
        size = x.shape[p.dim]
        if size % n:
            raise ValueError(f"dim {p.dim} of {tuple(x.shape)} ({size}) does "
                             f"not divide over the {AXES[axis]} axis of {n}")
        step = size // n
        index = [slice(None)] * x.ndim
        index[p.dim] = slice(coord[axis] * step, (coord[axis] + 1) * step)
        x = x[tuple(index)]
    return np.ascontiguousarray(x) if isinstance(x, np.ndarray) else x.contiguous()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's tensors live on: the CPU, or the current
    card."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along ``dim`` in the
    order of their coordinates (the group's ranks ascend with the
    coordinate on either mesh dim)."""
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim)
