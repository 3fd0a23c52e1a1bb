"""The multi-rank dry run (the reference's ``__graft_entry__.py``
``dryrun_multichip``) and the rank worker that spawns it.

    python -m opticalflowcontainer_tpu_torch.parallel.dryrun --ranks 4 --cpu

spawns 4 ranks (gloo on the CPU; without ``--cpu`` NCCL, one rank per
card), builds the reference's mesh (``model=2`` where the rank count is
even and at least 4) and runs the sharded RAFT-small train step and the
three inference legs, each held against the unsharded program on the same
ranks, printing the reference's four "OK" lines.

:func:`spawn` runs any task of :data:`TASKS` on N ranks and returns each
rank's result; the tests and ``chip_smoke.py`` use it with the ``infer``
and ``train`` tasks.  The worker lives here so that a spawned rank imports
only torch and this package.  Every rank's process group has a timeout,
and :func:`spawn` waits for the ranks with one: a hung collective fails
with a message instead of hanging its caller.
"""
from __future__ import annotations

import argparse
import functools
import multiprocessing
import queue
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (AXES, TIMEOUT_S, all_gather_cat, batch_sharding,
                   init_distributed, local_shard, make_mesh, mesh_device)

# the reference dry run's Farneback settings: the flow leg, the stream leg
FB_FLOW = dict(levels=2, winsize=9, iterations=2)
FB_STREAM = dict(levels=2, winsize=9, iterations=1)
SPAWN_TIMEOUT_S = 600.0


# ------------------------------------------------------------ spawning

def spawn(world: int, task: str, payload=None, *, cpu: bool = True,
          backend: str | None = None, threads: int | None = 1,
          timeout_s: float = SPAWN_TIMEOUT_S) -> list:
    """``TASKS[task](payload, device_type)`` on ``world`` spawned
    ranks of one process group (a ``file://`` store in a temporary
    directory); returns the ranks' results in rank order.

    ``cpu`` selects gloo on the CPU, else the card (NCCL by default;
    ``backend="gloo"`` lets ranks share one card).  ``threads`` sets each
    rank's torch threads.  Raises with the rank's traceback when a rank
    fails, and when the ranks have not all answered within ``timeout_s``;
    every rank is joined or killed before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results: dict[int, object] = {}
    with tempfile.TemporaryDirectory() as tmp:
        q = ctx.Queue()
        procs = [ctx.Process(target=_worker, daemon=True, args=(
            rank, world, f"file://{tmp}/store", task, payload, cpu, backend,
            threads, q)) for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{task}: ranks {sorted(set(range(world)) - set(results))} "
                        f"gave no result within {timeout_s:.0f} s")
                try:
                    rank, ok, value = q.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f"{task}: rank {dead[0][0]} exited "
                                           f"with code {dead[0][1]} before "
                                           f"giving a result") from None
                    continue
                if not ok:
                    raise RuntimeError(f"{task}: rank {rank} failed:\n{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            q.close()
    return [results[r] for r in range(world)]


def _worker(rank, world, init_method, task, payload, cpu, backend, threads, q):
    try:
        if threads:
            torch.set_num_threads(threads)
        init_distributed(rank, world, init_method, backend=backend,
                         device_type="cpu" if cpu else "cuda",
                         timeout_s=TIMEOUT_S)
        try:
            value = TASKS[task](payload, "cpu" if cpu else "cuda")
        finally:
            dist.destroy_process_group()
        q.put((rank, True, value))
    except Exception:
        q.put((rank, False, traceback.format_exc()))


# --------------------------------------------------------------- legs

def _dev(x, device) -> torch.Tensor:
    return torch.as_tensor(x).to(device)


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host: on the CPU ``.numpy()`` would share the
    tensor's memory, which later in-place updates change."""
    return t.detach().cpu().numpy().copy()


def _ms(fn, reps: int) -> float:
    """Median host ms of ``reps`` calls, each ended by a synchronize."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def farneback_fn(device, **kw):
    """``farneback_batched`` on ``device`` with the keywords ``kw``."""
    from ..classical.farneback import farneback_batched

    return functools.partial(farneback_batched, device=device, **kw)


def raft_fn(model, iters: int):
    """(img1, img2 [b, H, W, 3]) -> the last flow [b, H, W, 2] of ``model``
    (the reference dry run's spatial model forward)."""
    def fwd(i1, i2):
        return model(i1.permute(0, 3, 1, 2), i2.permute(0, 3, 1, 2), iters,
                     final_only=True).permute(0, 2, 3, 1)
    return fwd


def raft_small(state: dict | None, device):
    """RAFT-small on ``device`` with the numpy state dict ``state``, or with
    the reference's init from seed 0 (the same on every rank)."""
    from ..models.common import flax_init
    from ..models.raft import RAFTSmall

    model = RAFTSmall()
    if state is None:
        flax_init(model, torch.Generator().manual_seed(0))
    else:
        model.load_state_dict({k: torch.from_numpy(np.asarray(v))
                               for k, v in state.items()})
    return model.to(device)


def infer_legs(mesh, payload: dict, device, reps: int = 0) -> dict:
    """This rank's blocks of the three inference legs on ``mesh``.

    ``payload`` holds global inputs (numpy or tensors) under ``flow``
    (``kw``, ``prev``, ``cur``: the data-parallel Farneback leg),
    ``spatial`` (the same keys: Farneback with the height on ``model``),
    ``raft`` (``state``, ``img1``, ``img2`` [B, H, W, 3], ``iters``: the
    spatial RAFT-small forward) and ``stream`` (``kw``, ``g0``, ``g1``:
    the stream leg seeded on ``g0``); each is optional.  Returns the
    blocks as numpy arrays, ``mean_u``, the K1/K2 launches of each leg
    and, with ``reps``, the median ms of each sharded call and of its
    collectives alone."""
    from ..classical.farneback import farneback_stream_planes
    from ..ops.farneback_update import farneback_update
    from ..ops.solve2x2 import blur_solve
    from .infer import (make_sharded_flow_fn, make_sharded_stream_fn,
                        make_spatial_sharded_flow_fn)

    rows, band = batch_sharding(mesh), batch_sharding(mesh, spatial_dim=1)
    out: dict = {"launches": {}, "ms": {}, "collective_ms": {}}

    def launches(leg, fn):
        farneback_update.launches = blur_solve.launches = 0
        result = fn()
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        out["launches"][leg] = {"farneback_update": farneback_update.launches,
                                "blur_solve": blur_solve.launches}
        return result

    if "flow" in payload:
        p = payload["flow"]
        prev, cur = (_dev(local_shard(p[k], mesh, rows), device)
                     for k in ("prev", "cur"))
        sharded = make_sharded_flow_fn(farneback_fn(device, **p["kw"]), mesh)
        flow, mean_u = launches("flow", lambda: sharded(prev, cur))
        out["flow"], out["mean_u"] = _host(flow), float(mean_u)
        if reps:
            out["ms"]["flow"] = _ms(lambda: sharded(prev, cur), reps)
            stats = torch.zeros(2, device=device)
            out["collective_ms"]["flow"] = _ms(lambda: dist.all_reduce(
                stats, group=mesh.get_group("data")), reps)
    if "spatial" in payload:
        p = payload["spatial"]
        prev, cur = (_dev(local_shard(p[k], mesh, band), device)
                     for k in ("prev", "cur"))
        sharded = make_spatial_sharded_flow_fn(farneback_fn(device, **p["kw"]),
                                               mesh)
        out["spatial"] = _host(launches("spatial", lambda: sharded(prev, cur)))
        if reps:
            out["ms"]["spatial"] = _ms(lambda: sharded(prev, cur), reps)
            group = mesh.get_group("model")
            out["collective_ms"]["spatial"] = _ms(lambda: (
                all_gather_cat(prev, group, 1), all_gather_cat(cur, group, 1)),
                reps)
    if "raft" in payload:
        p = payload["raft"]
        model = raft_small(p["state"], device)
        i1, i2 = (_dev(local_shard(p[k], mesh, band), device)
                  for k in ("img1", "img2"))
        sharded = make_spatial_sharded_flow_fn(raft_fn(model, p["iters"]), mesh)
        with torch.no_grad():
            out["raft"] = _host(sharded(i1, i2))
    if "stream" in payload:
        p = payload["stream"]
        g0, g1 = (_dev(local_shard(p[k], mesh, rows), device)
                  for k in ("g0", "g1"))
        state = farneback_stream_planes(g0, device=device, **p["kw"])
        sharded = make_sharded_stream_fn(mesh, **p["kw"])
        du, state2 = launches("stream", lambda: sharded(state, g1))
        out["du"] = _host(du)
        out["state_shapes"] = [tuple(s.shape) for s in state2]
        if reps:
            out["ms"]["stream"] = _ms(lambda: sharded(state, g1), reps)
    return out


def infer_task(payload: dict, device_type: str) -> list:
    """:func:`infer_legs` on each mesh (data, model) of ``payload["meshes"]``
    in turn, on the same ranks, with the rank's mesh coordinate and the
    ranks of its two groups."""
    results = []
    for data, model in payload["meshes"]:
        mesh = make_mesh(data=data, model=model, device_type=device_type)
        res = infer_legs(mesh, payload, mesh_device(mesh), payload.get("reps", 0))
        res["coordinate"] = list(mesh.get_coordinate())
        res["groups"] = {ax: dist.get_process_group_ranks(mesh.get_group(ax))
                         for ax in AXES}
        results.append(res)
    return results


def _state_numpy(model) -> dict:
    return {k: _host(v) for k, v in model.state_dict().items()}


def train_task(payload: dict, device_type: str) -> list:
    """For each run of ``payload["runs"]`` (``mesh`` (data, model),
    ``state`` (numpy state dict), ``batches`` (global batches in the
    reference layout), ``iters``, ``shard_spatial``): the
    sharded step's losses on this rank, and on rank 0 its parameters and
    averaged gradients after each step, beside the unsharded
    ``train_step``'s losses, parameters and gradient norms on the full
    batches from the same parameters."""
    from .train import TrainState, make_optimizer, make_sharded_train_step, train_step

    results = []
    for run in payload["runs"]:
        mesh = make_mesh(data=run["mesh"][0], model=run["mesh"][1],
                         device_type=device_type)
        device = mesh_device(mesh)
        shard_spatial = run["shard_spatial"]
        place = batch_sharding(mesh, spatial_dim=1 if shard_spatial else None)

        def fresh():
            model = raft_small(run["state"], device)
            return TrainState(model, make_optimizer(dict(model.named_parameters())))

        state = fresh()
        # built over a state of its own: the step must take the parameters
        # from the state it is passed
        step = make_sharded_train_step(fresh(), mesh, iters=run["iters"],
                                       shard_spatial=shard_spatial)
        res = {"losses": [], "params": [], "grads": []}
        for batch in run["batches"]:
            state, loss = step(state, {k: local_shard(v, mesh, place)
                                       for k, v in batch.items()})
            res["losses"].append(float(loss))
            if dist.get_rank() == 0:
                res["params"].append(_state_numpy(state.model))
                res["grads"].append({k: _host(p.grad) for k, p in
                                     state.model.named_parameters()})
        if dist.get_rank() == 0:
            plain = fresh()
            res.update(plain_losses=[], plain_params=[], plain_grad_norms=[])
            for batch in run["batches"]:
                plain, loss = train_step(plain, batch, iters=run["iters"])
                res["plain_losses"].append(float(loss))
                res["plain_params"].append(_state_numpy(plain.model))
                res["plain_grad_norms"].append(float(torch.linalg.vector_norm(
                    torch.stack([p.grad.norm() for p in plain.model.parameters()
                                 if p.grad is not None]))))
        results.append(res)
    return results


# ------------------------------------------------------------ dry run

def _max_over_ranks(x: float) -> float:
    t = torch.tensor([x], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t)


def dryrun_task(payload, device_type: str) -> list[str]:
    """The reference dry run on this rank; returns its four lines (every
    rank returns them)."""
    from ..classical.farneback import farneback_stream_planes, farneback_stream_step
    from .train import TrainState, make_optimizer, make_sharded_train_step, train_step

    world = dist.get_world_size()
    model_axis = 2 if world % 2 == 0 and world >= 4 else 1
    mesh = make_mesh(world, data=world // model_axis, model=model_axis,
                     device_type=device_type)
    device = mesh_device(mesh)
    nd = mesh.size(0)
    shape = {"data": nd, "model": mesh.size(1)}
    rows, band = batch_sharding(mesh), batch_sharding(mesh, spatial_dim=1)
    rng = np.random.default_rng(0)
    lines = []

    def err_over_ranks(block: np.ndarray, ref: torch.Tensor) -> float:
        return _max_over_ranks(float(np.abs(
            block - _host(local_shard(ref, mesh, rows))).max()))

    # the sharded RAFT-small train step, against the unsharded one
    def fresh():
        model = raft_small(None, device)
        return TrainState(model, make_optimizer(dict(model.named_parameters())))

    B, H, W = nd * 2, 32, 32
    batch = {"img1": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             "img2": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
             "flow": np.zeros((B, H, W, 2), np.float32)}
    state = fresh()
    step = make_sharded_train_step(state, mesh, iters=2)
    state, loss = step(state, {k: local_shard(v, mesh, band)
                               for k, v in batch.items()})
    _, plain_loss = train_step(fresh(), batch, iters=2)
    loss = float(loss)
    if not np.isfinite(loss):
        raise RuntimeError(f"non-finite loss {loss}")
    rel = _max_over_ranks(abs(loss - float(plain_loss)) / abs(float(plain_loss)))
    if rel > 1e-5:
        raise RuntimeError(f"sharded loss {loss} vs unsharded "
                           f"{float(plain_loss)}: {rel:.2e} relative")
    lines.append(f"dryrun_multichip OK: mesh={shape} batch={B} "
                 f"loss={loss:.4f} step={state.step}")

    # the three inference legs on this mesh: data-parallel Farneback with
    # the all-reduced mean u; RAFT-small with the stepped parameters, the
    # batch on data and the height on model (at 64x64: at 32x32 the
    # coarsest correlation level is 1x1, the reference's note); live
    # streams on data, each rank stepping its own
    Bi, Ns = nd * 2, nd * 2
    prev = rng.uniform(0, 255, (Bi, 48, 64)).astype(np.float32)
    cur = np.roll(prev, 1, axis=-1)
    img1 = rng.uniform(0, 1, (nd, 64, 64, 3)).astype(np.float32)
    img2 = rng.uniform(0, 1, (nd, 64, 64, 3)).astype(np.float32)
    g0 = rng.uniform(0, 255, (Ns, 48, 64)).astype(np.float32)
    g1 = np.roll(g0, 1, axis=-1)
    got = infer_legs(mesh, {
        "flow": {"kw": FB_FLOW, "prev": prev, "cur": cur},
        "raft": {"state": _state_numpy(state.model), "img1": img1,
                 "img2": img2, "iters": 2},
        "stream": {"kw": FB_STREAM, "g0": g0, "g1": g1}}, device)

    flow_ref = farneback_fn(device, **FB_FLOW)(prev, cur)
    err = err_over_ranks(got["flow"], flow_ref)
    if err >= 1e-4:
        raise RuntimeError(f"DP-sharded flow mismatch: max |d| = {err}")
    mean_ref = float(flow_ref[..., 0].mean())
    if not abs(got["mean_u"] - mean_ref) <= 1e-5 * max(abs(mean_ref), 1e-6):
        raise RuntimeError(f"mean_u {got['mean_u']} vs the flow's mean {mean_ref}")
    lines.append(f"dryrun infer DP OK: batch={Bi} sharded-vs-unsharded "
                 f"max|d|={err:.2e} mean_u={got['mean_u']:.4f}")

    with torch.no_grad():
        out_ref = raft_fn(state.model, 2)(_dev(img1, device), _dev(img2, device))
    err2 = err_over_ranks(got["raft"], out_ref)
    if err2 >= 1e-3:
        raise RuntimeError(f"spatial-sharded forward mismatch: max |d| = {err2}")
    lines.append(f"dryrun infer spatial OK: sharded-vs-unsharded "
                 f"max|d|={err2:.2e}")

    state_all = farneback_stream_planes(g0, device=device, **FB_STREAM)
    flow_all, _ = farneback_stream_step(state_all, g1, device=device, **FB_STREAM)
    err3 = err_over_ranks(got["du"], flow_all[..., 0].mean(dim=(1, 2)))
    if err3 >= 1e-5:
        raise RuntimeError(f"sharded stream du mismatch: max |d| = {err3}")
    if got["state_shapes"] != [(s.shape[0] // nd, *s.shape[1:]) for s in state_all]:
        raise RuntimeError("the stream state changed shape")
    lines.append(f"dryrun stream DP OK: streams={Ns} sharded-vs-unsharded "
                 f"max|d|={err3:.2e}")
    return lines


TASKS = {"dryrun": dryrun_task, "infer": infer_task, "train": train_task}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (default: NCCL, one rank a card)")
    ap.add_argument("--timeout", type=float, default=SPAWN_TIMEOUT_S,
                    help="seconds the ranks have to finish")
    args = ap.parse_args(argv)
    if not args.cpu:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is available; pass --cpu")
        if args.ranks > torch.cuda.device_count():
            raise SystemExit(f"{args.ranks} ranks need as many cards; this "
                             f"machine has {torch.cuda.device_count()}")
    lines = spawn(args.ranks, "dryrun", cpu=args.cpu, timeout_s=args.timeout)[0]
    print("\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
