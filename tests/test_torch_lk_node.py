"""The port's ``LKVelocityNode`` held against the JAX package's node on the
CPU (the JAX node tracks cv2's corners with the JAX tracker), and its
failure count and depth-driven scale.  The JAX node's velocities are
computed once, in a module-scoped fixture."""
import cv2
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.runtime import nodes as jnodes
from opticalflowcontainer_tpu.runtime.bus import Bus as JBus
from opticalflowcontainer_tpu.runtime.messages import Header as JHeader
from opticalflowcontainer_tpu.runtime.messages import ImageMsg as JImageMsg
from opticalflowcontainer_tpu_torch.runtime import LKVelocityNode, NodeParams
from opticalflowcontainer_tpu_torch.runtime.bus import Bus
from opticalflowcontainer_tpu_torch.runtime.messages import Header, ImageMsg
from test_torch_threads import one_torch_thread  # noqa: F401

# The tracker against JAX: the same float algorithm with reductions summed
# in another order.  Measured <= 2e-4 px (640x480, 500 points); the bar
# leaves 5x room and stays 250x below cv2's 0.05 px bar.
LK_PX = 1e-3



def _frames(rng, n, dx=2):
    base = cv2.GaussianBlur(rng.uniform(0, 255, (160, 260)).astype(np.float32), (0, 0), 1.5)
    return [np.repeat(base[10:150, 40 - f * dx:240 - f * dx, None], 3, -1).astype(np.uint8)
            for f in range(n)]


def _run_node(name, frames):
    """(velocities, smoothed velocities, frames processed) of the JAX
    (``"jax"``) or the port's (``"torch"``) node over ``frames``: content
    moving +2 px a frame, a re-detection every 3 frames."""
    bus, node_cls, header, msg = (
        (JBus(), jnodes.LKVelocityNode, JHeader, JImageMsg) if name == "jax"
        else (Bus(), LKVelocityNode, Header, ImageMsg))
    kw = {"device": "cpu"} if name == "torch" else {}
    node = node_cls(bus, jnodes.NodeParams(name="LK", pixel_to_meter=1.0,
                                           aggregate="median")
                    if name == "jax" else NodeParams(name="LK", pixel_to_meter=1.0,
                                                     aggregate="median"),
                    max_corners=100, redetect_every=3, **kw)
    vels, smooth = [], []
    bus.subscribe("/optical_flow/LK_velocity", lambda m, v=vels: v.append(m.x))
    bus.subscribe("/optical_flow/LK_smooth_velocity", lambda m, v=smooth: v.append(m.x))
    for f, frame in enumerate(frames):
        bus.publish("/camera/color/image_raw", msg(header(float(f)), frame))
    return np.array(vels), np.array(smooth), node.frames_processed


@pytest.fixture(scope="module")
def node_frames():
    """The frames, from the ``rng`` fixture's seed."""
    return _frames(np.random.default_rng(0), 8)


@pytest.fixture(scope="module")
def jax_node(node_frames):
    return _run_node("jax", node_frames)


def test_lk_node_matches_jax_node(node_frames, jax_node):
    """The same frames (content moving +2 px a frame, a re-detection every
    3 frames) through the JAX node (cv2 corners, JAX tracker) and the
    port's: the same published velocities, to the tracker's bound."""
    frames = node_frames
    out = {"jax": jax_node, "torch": _run_node("torch", frames)}
    assert out["torch"][2] == out["jax"][2] == len(frames) - 1
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=0, atol=LK_PX)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=0, atol=LK_PX)
    assert abs(out["torch"][0].mean() - 2.0) < 0.3


def test_lk_node_counts_failures_and_follows_depth(capsys):
    """A frame that cannot be processed is counted in ``frames_failed``
    (its traceback printed), and the node goes on; camera_info and depth
    set the metres per pixel."""
    from opticalflowcontainer_tpu_torch.runtime.messages import CameraInfoMsg, RangeMsg

    bus = Bus()
    node = LKVelocityNode(bus, NodeParams(name="LK", pixel_to_meter=1.0), device="cpu",
                          max_corners=50)
    try:
        vels = []
        bus.subscribe("/optical_flow/LK_velocity", lambda m: vels.append(m.x))
        frames = _frames(np.random.default_rng(3), 3)
        bus.publish("/camera/color/image_raw", ImageMsg(Header(0.0), frames[0]))
        # two channels: the gray conversion raises before the frame is kept
        bus.publish("/camera/color/image_raw", ImageMsg(Header(0.5), frames[1][..., :2]))
        assert node.frames_failed == 1 and "Traceback" in capsys.readouterr().err
        bus.publish("/camera/color/camera_info", CameraInfoMsg(Header(0.5), fx=500.0))
        bus.publish("/camera/depth/median_distance", RangeMsg(Header(0.5), 2.0))
        bus.publish("/camera/color/image_raw", ImageMsg(Header(1.0), frames[1]))
        bus.publish("/camera/color/image_raw", ImageMsg(Header(2.0), frames[2]))
        assert node.frames_processed == 2 and node.frames_failed == 1
        # 2 px a second at 2 m / 500 px
        assert abs(vels[-1] - 2.0 * 2.0 / 500.0) < 0.3 * 2.0 / 500.0
    finally:
        node.stop()
    assert not bus._subs.get("/camera/color/image_raw")
