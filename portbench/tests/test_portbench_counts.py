"""The operation and byte counts against hand counts at small shapes, and
PWC-Net's against ``torch.utils.flop_counter`` over the reference net."""
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.counts import farneback as cf
from portbench.counts import least_seconds, peaks
from portbench.counts import pwcnet as cp
from portbench.reference import pwcnet as rp

FB = {"params": {"pyr_scale": 0.5, "levels": 3, "winsize": 15, "iterations": 3,
                 "poly_n": 5, "poly_sigma": 1.2, "flags": 0}}


def test_pwcnet_first_and_last_layers_by_hand():
    L = cp.layers(64, 128)
    # level 1, conv0: 3 -> 16 at 32 x 64, once a frame
    assert L[0] == L[1] == ("conv", 3, 16, 3, 32, 64)
    # the refiner's last convolution: 32 -> 2 at a quarter of the input
    assert L[-1] == ("conv", 32, 2, 3, 16, 32)
    # level 5's upflow takes level 6's flow (1 x 2)
    assert ("deconv", 2, 2, 4, 1, 2) in L
    assert cp.conv_flops(64, 128) == sum(2 * a * b * k * k * h * w
                                         for _, a, b, k, h, w in L)


def test_pwcnet_k3_k4_by_hand():
    c = cp.counts({}, {"height": 64, "width": 64})
    # 64 x 64: levels 6..2 are 1, 2, 4, 8, 16 pixels across
    sizes = {6: 1, 5: 2, 4: 4, 3: 8, 2: 16}
    ch = dict(zip(range(1, 7), cp.EXTRACTOR))
    k4 = sum(4 * (2 * ch[lv] + 81) * n * n for lv, n in sizes.items())
    k3 = sum(4 * (2 * ch[lv] + 2) * n * n for lv, n in sizes.items() if lv < 6)
    assert c["k4"]["bytes"] == k4 and c["k3"]["bytes"] == k3
    assert c["k4"]["flops"] == sum(2 * ch[lv] * 81 * n * n for lv, n in sizes.items())


@pytest.mark.parametrize("hw", [(64, 64), (50, 70)])
def test_pwcnet_flops_match_flop_counter(hw):
    """flop_counter counts the convolutions (not the correlation) of the
    reference's forward at the padded size."""
    H, W = cp.padded(hw[0]), cp.padded(hw[1])
    shapes = {}
    with np.load(rp_weights()) as d:
        for k in d.files:
            shapes[k] = d[k].shape
    g = torch.Generator().manual_seed(0)
    w = {}
    for k, s in shapes.items():
        if k.endswith("kernel") and ("upflow" in k or "upfeat" in k):
            s = (s[2], s[3], s[0], s[1])
        elif k.endswith("kernel"):
            s = (s[3], s[2], s[0], s[1])
        w[k] = torch.randn(s, generator=g) * 0.05
    net = rp.PWCNetRef(w)
    x = torch.rand(1, 3, H, W, generator=g)
    with FlopCounterMode(display=False) as fc:
        net.forward(x, x.flip(-1))
    assert fc.get_total_flops() == cp.conv_flops(*hw)


def rp_weights():
    from portbench.systems.pwcnet import ROOT
    import json
    cfg = json.loads((ROOT / "portbench" / "configs" / "pwcnet.json").read_text())
    return ROOT / cfg["weights"]


def test_pwcnet_at_640x480_is_120_gflop():
    assert cp.counts({}, {"height": 480, "width": 640})["flops"] == pytest.approx(
        120.36e9, rel=1e-3)


def test_farneback_by_hand():
    tr = {"height": 64, "width": 64, "frames_per_call": 3, "streams": 2}
    c = cf.counts(FB, tr)
    # 64 x 64: two levels, 32 x 32 and 64 x 64 (16 px would be under 32)
    px = 32 * 32 + 64 * 64
    assert c["k1"]["bytes"] == 3 * 68 * px
    assert c["k2"]["bytes"] == 3 * 28 * px
    assert c["k2"]["flops"] == 3 * (20 * 15 + 13) * px
    # 6 frames expanded once per level for 4 fields
    assert c["prep"]["bytes"] == pytest.approx(6 * (2 * 64 * 64 + 20 * px) / 4)
    # frames in (uint8) and flow out (fp32 u, v) per field
    assert c["bytes"] == pytest.approx((6 * 64 * 64 + 4 * 64 * 64 * 8) / 4)


def test_peaks_and_least_time():
    p = peaks("NVIDIA H100 80GB HBM3")
    assert p == {"fp32_flop_per_s": 67e12, "hbm_byte_per_s": 3.35e12}
    assert peaks("some other card") is None
    assert least_seconds(67e12, 0.0, p) == 1.0
    assert least_seconds(0.0, 6.7e12, p) == 2.0
