"""The port's sharded inference (``parallel/mesh.py``, ``parallel/infer.py``)
against the JAX package's on the CPU.

The JAX functions run on ``make_mesh(4, data=2, model=2)`` and on
``data=4, model=1`` over the first 4 of the 8 virtual devices
(``tests/conftest.py``).  The port runs the same inputs, made with numpy
from a seed, on 4 spawned gloo ranks (``parallel/dryrun.py``'s worker, one
torch thread each), all legs and both meshes in one spawn per module;
each rank returns its block and the test rebuilds the global arrays.

Bars:

- the data-parallel Farneback flow within 1e-4 px of JAX's (the reference
  dry run's bar; equal in practice: the port's Farneback equals the JAX
  exact path bit for bit on the CPU), ``mean_u`` to rtol 1e-5;
- the spatial form: Farneback within 1e-4 px (``test_parallel_infer.py``'s
  bar), a RAFT-small forward at 64x64 within 1e-3 px (the dry run's);
- the stream leg's du within 1e-5 px of the port's unsharded step.
  Against JAX the stream differs by more, and for a reason outside the
  sharding: the JAX stream carries bf16 planes in its TPU layout (block
  warp, bf16 normal equations) where the port carries fp32, so the du are
  held to ``test_torch_fused_stream.py``'s bf16 bar, 5e-3 px;
- every sharded result against the port's own unsharded call at the same
  bars.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import opticalflowcontainer_tpu.models as jmodels
from _torch_train import jax_init, port_model
from opticalflowcontainer_tpu.classical import farneback as jfb
from opticalflowcontainer_tpu.classical import farneback_batched as jfarneback_batched
from opticalflowcontainer_tpu.parallel import make_mesh as jmake_mesh
from opticalflowcontainer_tpu.parallel.infer import (
    make_sharded_flow_fn as jsharded_flow, make_sharded_stream_fn as jsharded_stream,
    make_spatial_sharded_flow_fn as jspatial)
from opticalflowcontainer_tpu_torch import parallel as tpar
from opticalflowcontainer_tpu_torch.classical import farneback as tfb
from opticalflowcontainer_tpu_torch.parallel import dryrun, mesh as tmesh
from test_torch_threads import one_torch_thread  # noqa: F401

MESHES = [(2, 2), (4, 1)]
FB_SPATIAL = dict(levels=1, winsize=11, iterations=1)
RAFT_ITERS = 2


def _blur(x: np.ndarray) -> np.ndarray:
    """A separable Gaussian blur (sigma 2) of [..., H, W] frames, wrap
    border: textures Farneback can follow."""
    k = np.exp(-0.5 * (np.arange(-6, 7) / 2.0) ** 2)
    k /= k.sum()
    for axis in (-2, -1):
        x = sum(w * np.roll(x, s, axis=axis) for s, w in zip(range(-6, 7), k))
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    prev = rng.uniform(0, 255, (8, 48, 64)).astype(np.float32)
    base = _blur(rng.uniform(0, 255, (4, 64, 80)).astype(np.float32))
    g0 = rng.uniform(0, 255, (8, 48, 64)).astype(np.float32)
    model, params = jax_init(jmodels.RAFTSmall, 64, 64, RAFT_ITERS)
    state = {k: v.numpy() for k, v in port_model("raft_small", params).state_dict().items()}
    return {
        "flow": {"kw": dryrun.FB_FLOW, "prev": prev, "cur": np.roll(prev, 1, axis=-1)},
        "spatial": {"kw": FB_SPATIAL, "prev": base, "cur": np.roll(base, 2, axis=2)},
        "raft": {"state": state, "iters": RAFT_ITERS,
                 "img1": rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32),
                 "img2": rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32)},
        "stream": {"kw": dryrun.FB_STREAM, "g0": g0, "g1": np.roll(g0, 1, axis=-1)},
        "jax_raft": (model, params),
    }


@pytest.fixture(scope="module")
def port(inputs):
    """Each mesh's per-rank results from one spawn of 4 gloo ranks."""
    payload = {k: v for k, v in inputs.items() if k != "jax_raft"}
    payload["meshes"] = MESHES
    ranks = dryrun.spawn(4, "infer", payload, cpu=True, timeout_s=300)
    return {mesh: [r[i] for r in ranks] for i, mesh in enumerate(MESHES)}


@pytest.fixture(scope="module")
def jax_out(inputs):
    """The JAX sharded functions' outputs on each mesh."""
    model, params = inputs["jax_raft"]
    f, s, st = inputs["flow"], inputs["spatial"], inputs["stream"]
    flow_fn = functools.partial(jfb.calc_optical_flow_farneback, **f["kw"])
    spatial_fn = functools.partial(jfarneback_batched, **s["kw"])

    def raft_fwd(i1, i2):
        return jax.vmap(lambda a, b: model.apply(params, a, b, RAFT_ITERS)[-1])(i1, i2)

    seed = jax.jit(functools.partial(jfb.farneback_stream_planes, share="all",
                                     **st["kw"]))
    out = {}
    for data, mdl in MESHES:
        mesh = jmake_mesh(4, data=data, model=mdl)
        flow, mean_u = jsharded_flow(flow_fn, mesh)(jnp.asarray(f["prev"]),
                                                    jnp.asarray(f["cur"]))
        du, _ = jsharded_stream(mesh, share="all", **st["kw"])(
            seed(jnp.asarray(st["g0"])), jnp.asarray(st["g1"]))
        r = inputs["raft"]
        out[(data, mdl)] = {
            "flow": np.asarray(flow), "mean_u": float(mean_u),
            "spatial": np.asarray(jspatial(spatial_fn, mesh)(
                jnp.asarray(s["prev"]), jnp.asarray(s["cur"]))),
            "raft": np.asarray(jspatial(raft_fwd, mesh)(
                jnp.asarray(r["img1"]), jnp.asarray(r["img2"]))),
            "du": np.asarray(du)}
    return out


@pytest.fixture(scope="module")
def unsharded(inputs):
    """The port's unsharded calls on the CPU."""
    f, s, st, r = (inputs[k] for k in ("flow", "spatial", "stream", "raft"))
    flow = tfb.farneback_batched(f["prev"], f["cur"], device="cpu", **f["kw"]).numpy()
    state = tfb.farneback_stream_planes(st["g0"], device="cpu", **st["kw"])
    sflow, _ = tfb.farneback_stream_step(state, st["g1"], device="cpu", **st["kw"])
    model = dryrun.raft_small(r["state"], "cpu")
    with torch.no_grad():
        raft = dryrun.raft_fn(model, RAFT_ITERS)(torch.from_numpy(r["img1"]),
                                                 torch.from_numpy(r["img2"]))
    return {"flow": flow, "mean_u": float(flow[..., 0].mean()),
            "state_shapes": [tuple(p.shape[1:]) for p in state],
            "spatial": tfb.farneback_batched(s["prev"], s["cur"], device="cpu",
                                             **s["kw"]).numpy(),
            "raft": raft.numpy(), "du": sflow[..., 0].mean(dim=(1, 2)).numpy()}


def _global(per_rank: list, key: str, mesh) -> np.ndarray:
    """The global array of a leg from the ranks' blocks: rows on data, the
    ranks of a model group holding the same rows."""
    data, model = mesh
    blocks = [per_rank[d * model][key] for d in range(data)]
    for d in range(data):
        for m in range(1, model):
            np.testing.assert_array_equal(per_rank[d * model + m][key], blocks[d])
    return np.concatenate(blocks)


BARS = {"flow": 1e-4, "spatial": 1e-4, "raft": 1e-3}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("leg", ["flow", "spatial", "raft"])
def test_sharded_flow_matches_jax_and_unsharded(leg, mesh, port, jax_out, unsharded):
    got = _global(port[mesh], leg, mesh)
    assert got.shape == jax_out[mesh][leg].shape == unsharded[leg].shape
    assert np.isfinite(got).all()
    assert np.abs(got - jax_out[mesh][leg]).max() <= BARS[leg]
    assert np.abs(got - unsharded[leg]).max() <= BARS[leg]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_mean_u_is_the_global_mean(mesh, port, jax_out, unsharded):
    for rank in port[mesh]:
        assert rank["mean_u"] == pytest.approx(jax_out[mesh]["mean_u"], rel=1e-5)
        assert rank["mean_u"] == pytest.approx(unsharded["mean_u"], rel=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_sharded_stream_du(mesh, port, jax_out, unsharded):
    got = _global(port[mesh], "du", mesh)
    assert got.shape == (8,)
    assert np.abs(got - unsharded["du"]).max() <= 1e-5
    assert np.abs(got - jax_out[mesh]["du"]).max() <= 5e-3
    rows = 8 // mesh[0]
    for rank in port[mesh]:
        assert rank["state_shapes"] == [(rows,) + s for s in unsharded["state_shapes"]]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_k1_k2_run_inside_each_rank(mesh, port):
    """On the CPU the wrappers take their plain versions and count no
    launch; the counts are there for the card (chip_smoke phase 25)."""
    for rank in port[mesh]:
        assert set(rank["launches"]) == {"flow", "spatial", "stream"}


def test_mesh_layout_is_the_jax_row_major_grid(port):
    """rank r at (r // model, r % model): on 2x2 the data groups {0, 2} and
    {1, 3}, the model groups {0, 1} and {2, 3}, as JAX's
    ``reshape(data, model)`` grid lays the devices out."""
    jgrid = np.asarray(jmake_mesh(4, data=2, model=2).devices)
    ids = np.vectorize(lambda d: d.id)(jgrid)
    want_data = {r: sorted(ids[:, c].tolist()) for r in range(4)
                 for c in [int(np.argwhere(ids == r)[0][1])]}
    want_model = {r: sorted(ids[int(np.argwhere(ids == r)[0][0])].tolist())
                  for r in range(4)}
    for r, rank in enumerate(port[(2, 2)]):
        assert rank["coordinate"] == [r // 2, r % 2]
        assert rank["groups"]["data"] == want_data[r] == [r % 2, r % 2 + 2]
        assert rank["groups"]["model"] == want_model[r] == [r - r % 2, r - r % 2 + 1]
    for r, rank in enumerate(port[(4, 1)]):
        assert rank["groups"] == {"data": [0, 1, 2, 3], "model": [r]}


class _Mesh:
    """The three things ``local_shard`` asks of a DeviceMesh."""

    mesh_dim_names = ("data", "model")

    def __init__(self, sizes, coordinate):
        self._sizes, self._coordinate = sizes, coordinate

    def size(self, axis):
        return self._sizes[axis]

    def get_coordinate(self):
        return self._coordinate


def test_local_shard_blocks_and_the_indivisible_batch():
    x = np.arange(8 * 6 * 4, dtype=np.float32).reshape(8, 6, 4)
    mesh = _Mesh((4, 2), [2, 1])
    np.testing.assert_array_equal(
        tmesh.local_shard(x, mesh, (Shard(0), Shard(1))), x[4:6, 3:6])
    np.testing.assert_array_equal(
        tmesh.local_shard(x, mesh, tpar.batch_sharding(mesh)), x[4:6])
    t = torch.from_numpy(x)
    assert torch.equal(tmesh.local_shard(t, mesh, tpar.replicated(mesh)), t)
    assert tpar.batch_sharding(mesh, 2) == (Shard(0), Shard(2))
    assert tpar.replicated(mesh) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="does not divide over the data axis of 4"):
        tmesh.local_shard(x[:6], mesh, tpar.batch_sharding(mesh))
    with pytest.raises(ValueError, match="model axis of 2"):
        tmesh.local_shard(x[:, :5], mesh, (Shard(0), Shard(1)))


def test_make_mesh_checks(tmp_path):
    """No group, too many ranks, CUDA without a card: each raises, as the
    reference's assert does; nothing falls back to gloo."""
    with pytest.raises(RuntimeError, match="init_distributed"):
        tpar.make_mesh(device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.init_distributed(0, 1, f"file://{tmp_path}/s0")
    tpar.init_distributed(0, 1, f"file://{tmp_path}/s1", device_type="cpu",
                          timeout_s=30)
    try:
        with pytest.raises(ValueError, match="need 2 ranks"):
            tpar.make_mesh(data=2, device_type="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                tpar.make_mesh()
        mesh = tpar.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == ("data", "model") and mesh.shape == (1, 1)
    finally:
        torch.distributed.destroy_process_group()


def test_a_failing_rank_fails_the_spawn():
    """A rank's error reaches the caller with its traceback; every rank is
    joined."""
    with pytest.raises(RuntimeError, match="rank [01] failed"):
        dryrun.spawn(2, "infer", {"meshes": [(3, 1)]}, cpu=True, timeout_s=60)


def test_parallel_exports_every_jax_name():
    from opticalflowcontainer_tpu import parallel as jpar

    assert set(jpar.__all__) <= set(tpar.__all__)
    assert all(getattr(tpar, name) is not None for name in tpar.__all__)
