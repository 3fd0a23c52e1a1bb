"""The port's ``RAFTSmall`` on the packaged ``raft_small_synth.npz``
against the independent torch-ops oracle ``tests/_torch_raft.py``
``TorchRAFTSmall`` (``F.grid_sample`` lookup, ``F.avg_pool2d`` pyramid,
``F.interpolate`` upsampling, ``F.instance_norm``), the same weights
carried over by ``models/convert.py``'s RAFT-small table and
``invert_entry``.  The JAX package is not involved: this holds the port's
own wiring (its all-pairs volume, packed lookup and upsampling) against
torch's implementations at 64x64.

Tolerance: the JAX parity test's bars on the same oracle
(``tests/test_reference_parity.py``), endpoint error mean 1e-3 px and max
2e-2 px.  Both sides run fp32 on the CPU; they differ by the order of the
sums in the bmm volume against the oracle's matmul, and in the lookup's
index arithmetic against grid_sample's, carried through the recurrent
steps (the packaged weights read ~1e-6 px apart)."""
import numpy as np
import pytest
import torch

from _torch_raft import TorchRAFTSmall
from opticalflowcontainer_tpu_torch.models import convert
from test_torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def nets():
    port = convert.load_raft_small_synth(device="cpu")
    sd = port.state_dict()
    ref = {}
    for e in convert.raft_small_table():
        name = ".".join(e.flax_path)
        ref.update(convert.invert_entry(e, sd[f"{name}.weight"].numpy(),
                                        sd[f"{name}.bias"].numpy()))
    oracle = TorchRAFTSmall()
    oracle.load_state_dict({k: torch.from_numpy(v) for k, v in ref.items()}, strict=True)
    return port, oracle.eval()


def _pair(seed: int, H: int = 64, W: int = 64):
    """A textured pair moved by a coherent shift of 2 px plus noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, (H + 8, W + 8, 3)).astype(np.float32)
    i1 = base[4:4 + H, 4:4 + W]
    i2 = np.clip(base[4:4 + H, 2:2 + W] + rng.normal(0, 0.02, (H, W, 3)), 0, 1)
    return (torch.from_numpy(np.ascontiguousarray(x.transpose(2, 0, 1), np.float32))[None]
            for x in (i1, i2))


@pytest.mark.parametrize("seed,iters", [(4, 3), (5, 12)])
def test_port_raft_small_matches_the_torch_oracle_on_packaged_weights(nets, seed, iters):
    port, oracle = nets
    x1, x2 = _pair(seed)
    with torch.no_grad():
        got = port(x1, x2, iters=iters, final_only=True)
        want = oracle(x1, x2, iters=iters)
    assert got.shape == want.shape == (1, 2, 64, 64)
    assert float(want.std()) > 1e-2, "the oracle's flow is degenerate"
    epe = (got - want).square().sum(1).sqrt()
    assert float(epe.mean()) < 1e-3 and float(epe.max()) < 2e-2


def test_the_oracle_takes_every_packaged_parameter(nets):
    """Every parameter of the port's RAFT-small has its oracle counterpart
    (the table covers the whole model) and the two hold the same numbers."""
    port, oracle = nets
    got, want = port.state_dict(), oracle.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], want[k]) for k in got)
    assert sum(p.numel() for p in port.parameters()) == 990162
