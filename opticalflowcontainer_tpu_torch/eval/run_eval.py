"""Flow eval harness CLI (the port's copy of the reference's
``eval/run_eval.py``): EPE tables for any method over Sintel, KITTI, the
synthetic pairs or the fishnet pairs, one JSON row per method.

    python -m opticalflowcontainer_tpu_torch.eval.run_eval --method farneback --fishnet --cpu
    python -m opticalflowcontainer_tpu_torch.eval.run_eval --method raft,neuflow --hard

Runs on the card unless ``--cpu`` is given, and raises without one.  The
learned methods serve the packaged npz weights
(``opticalflowcontainer_tpu/models/weights/``), a flat-npz candidate
(``--ckpt x.npz``) or a reference torch checkpoint (``--ckpt x.pytorch``,
where a converter exists); where the packaged npz is absent the model is
initialized from ``torch.Generator().manual_seed(0)`` (:func:`seeded_init`),
and its EPE then measures nothing but the path.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _learned_spec(name: str):
    """(model class, packaged-weight loader, estimate, torch-checkpoint
    converter or None, estimate kwargs from ``quick``) of a learned method.
    A converter takes (state_dict, model) and fills the model."""
    from ..models import convert

    def table(conv):
        def load(sd, model):
            model.load_state_dict(conv(sd))
        return load

    no_kw = lambda quick: {}  # noqa: E731
    if name in ("raft", "raft_large"):
        from ..models import RAFT, RAFTSmall
        from ..models.raft import estimate

        def kw(quick):
            return {"iters": 4 if quick else 12}

        if name == "raft":
            return (RAFTSmall, convert.load_raft_small_synth, estimate,
                    table(convert.convert_raft_small), kw)
        return RAFT, convert.load_raft_synth, estimate, None, kw
    if name == "neuflow":
        from ..models import NeuFlowLite
        from ..models.neuflow import estimate

        return NeuFlowLite, convert.load_neuflow_lite_synth, estimate, None, no_kw
    if name == "neuflow_v2":
        from ..models.neuflow_v2 import NeuFlowV2, convert_neuflow_v2, estimate

        def v2_kw(quick):
            return {"iters_s8": 2 if quick else 8}

        def v2_load(sd, model):
            convert_neuflow_v2({k: torch.as_tensor(v) for k, v in sd.items()},
                               model)

        return NeuFlowV2, convert.load_neuflow_v2_synth, estimate, v2_load, v2_kw
    if name == "pwcnet":
        from ..models import PWCNet
        from ..models.pwcnet import estimate

        return (PWCNet, convert.load_pwcnet_synth, estimate,
                table(convert.convert_pwcnet), no_kw)
    if name == "liteflownet3":
        from ..models import LiteFlowNet3
        from ..models.liteflownet3 import estimate

        return (LiteFlowNet3, convert.load_liteflownet3_synth, estimate,
                table(convert.convert_liteflownet3), no_kw)
    if name == "liteflownet":
        from ..models import LiteFlowNet
        from ..models.liteflownet import estimate

        return (LiteFlowNet, convert.load_liteflownet_synth, estimate,
                table(convert.convert_liteflownet), no_kw)
    return None


def seeded_init(model: torch.nn.Module) -> torch.nn.Module:
    """Fill ``model``'s convolutions He-normal (std sqrt(2 / fan_in)) and its
    linear layers LeCun-normal (std sqrt(1 / fan_in)) from
    ``torch.Generator().manual_seed(0)``, biases 0; other parameters keep
    their constructor values.  In place; returns ``model``."""
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.ConvTranspose2d):
                fan_in = m.weight.shape[0] * 4 // m.groups  # 2x2 taps of 4x4/s2
                std = (2.0 / fan_in) ** 0.5
            elif isinstance(m, torch.nn.Conv2d):
                std = (2.0 / m.weight[0].numel()) ** 0.5
            elif isinstance(m, torch.nn.Linear):
                std = (1.0 / m.weight.shape[1]) ** 0.5
            else:
                continue
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * std)
            if m.bias is not None:
                m.bias.zero_()
    return model


def _frames(img, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(device)


def _make_method(name: str, ckpt: str | None, quick: bool, bf16: bool = False,
                 device=None):
    """A runner ``run(img1, img2) -> flow`` for method ``name``: RGB float
    images [H, W, 3] in [0, 1] to the flow [H, W, 2] float32 on the host.
    ``run.flow_fn(i1, i2)`` takes the images as float32 tensors on
    ``run.device`` and returns the flow there (what timing calls);
    ``run.learned`` tells the learned methods from the classical one."""
    from ..core.device import resolve_device

    dev = resolve_device(device)
    if name == "farneback":
        from ..classical import calc_optical_flow_farneback
        from ..core.color import rgb_to_gray

        def flow_fn(i1, i2):
            # BT.601 luma of the RGB [0, 1] images, at the uint8 range
            return calc_optical_flow_farneback(
                rgb_to_gray(i1[..., :3]) * 255.0, rgb_to_gray(i2[..., :3]) * 255.0,
                device=dev)

        learned = False
    else:
        spec = _learned_spec(name)
        if spec is None:
            raise SystemExit(f"unknown method {name}")
        cls, load_packaged, est, torch_conv, kw_fn = spec
        est_kw = kw_fn(quick)
        model = None if ckpt else load_packaged("cpu")
        if model is None:
            model = seeded_init(cls()).eval()
        if ckpt and ckpt.endswith(".npz"):
            from ..models.convert import flax_to_torch_state_dict, load_flat_npz

            model.load_state_dict(flax_to_torch_state_dict(load_flat_npz(ckpt),
                                                           model))
        elif ckpt:
            if torch_conv is None:
                raise SystemExit(
                    f"--ckpt {ckpt}: method {name} accepts only flat-npz "
                    "checkpoints (no torch-checkpoint converter exists for it)")
            sd = torch.load(ckpt, map_location="cpu")
            if isinstance(sd, dict) and "model" in sd:
                sd = sd["model"]
            torch_conv(sd, model)
        model = model.to(dev)
        if bf16:
            from ..models.common import cast_params

            cast_params(model, torch.bfloat16)
        # a reference torch checkpoint was trained on BGR frames, the eval
        # pairs are RGB: flip for those only (the packaged weights and npz
        # candidates were trained on this pipeline's RGB)
        to_bgr = bool(ckpt) and not ckpt.endswith(".npz")

        def flow_fn(i1, i2):
            if to_bgr:
                i1, i2 = i1.flip(-1), i2.flip(-1)
            return est(model, i1, i2, **est_kw)

        learned = True

    def run(img1, img2) -> np.ndarray:
        with torch.inference_mode():
            flow = flow_fn(_frames(img1, dev), _frames(img2, dev))
        return flow.float().cpu().numpy()

    run.flow_fn = flow_fn
    run.device = dev
    run.learned = learned
    return run


def _graph_ms(fn, reps: int, rounds: int) -> float:
    """Device ms per call: ``reps`` calls of ``fn`` captured in one CUDA
    graph, replayed ``rounds`` times between CUDA events (best replay)."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _events_ms(fn, reps: int, rounds: int) -> float:
    """ms per call by CUDA events around ``reps`` back-to-back calls (best
    of ``rounds``): the device's time plus any gaps in which it waited for
    the host to launch."""
    best = float("inf")
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _wall_ms(fn, reps: int, rounds: int) -> float:
    best = float("inf")
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        best = min(best, (time.perf_counter() - t0) / reps * 1e3)
    return best


def time_call(fn, device: torch.device, reps: int, rounds: int = 3) -> dict:
    """Time ``fn()`` after two warm-up calls: {"ms", "timer", "unreliable"}.

    On the card the calls are replayed from a CUDA graph (timer
    ``cuda_graph``, device time alone).  A call that cannot be captured is
    timed by CUDA events around back-to-back calls instead (timer
    ``cuda_events``); that time includes the device's waits for the host,
    so the row is flagged unreliable.  On the CPU it is the wall clock
    (timer ``wall``)."""
    with torch.inference_mode():
        for _ in range(2):
            fn()
        if device.type != "cuda":
            return {"ms": _wall_ms(fn, reps, rounds), "timer": "wall",
                    "unreliable": False}
        torch.cuda.synchronize(device)
        try:
            return {"ms": _graph_ms(fn, reps, rounds), "timer": "cuda_graph",
                    "unreliable": False}
        except RuntimeError:
            torch.cuda.synchronize(device)
            return {"ms": _events_ms(fn, reps, rounds), "timer": "cuda_events",
                    "unreliable": True}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--method", default="farneback",
                    help="a method or a comma list: farneback, raft, "
                         "raft_large, pwcnet, liteflownet, liteflownet3, "
                         "neuflow, neuflow_v2")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--sintel", default=None, help="MPI-Sintel root")
    ap.add_argument("--kitti", default=None, help="KITTI-2015 root")
    ap.add_argument("--n", type=int, default=None,
                    help="pairs to evaluate (default 8; 32 for --fishnet)")
    ap.add_argument("--hard", action="store_true",
                    help="hard suite: large motion, an illumination change "
                         "and noise")
    ap.add_argument("--fishnet", action="store_true",
                    help="deployment-domain suite: affine warps of the "
                         "fishnet golden image and procedural textures at "
                         "640x480 (n defaults to 32; combine with --hard)")
    ap.add_argument("--time-device", action="store_true",
                    help="also time one call at the eval's operating point "
                         "(first pair): CUDA-graph replay on the card, CUDA "
                         "events where the call cannot be captured, the wall "
                         "clock with --cpu")
    ap.add_argument("--bf16", action="store_true",
                    help="serve the learned methods in bfloat16 (parameters "
                         "and inputs; the flow stays fp32); classical rows "
                         "stay fp32")
    ap.add_argument("--quick", action="store_true",
                    help="fewer iterations (RAFT 4, NeuFlow-v2 iters_s8 2) "
                         "and timing reps")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    from .datasets import (
        KittiFlowDataset,
        SintelDataset,
        fishnet_eval_pairs,
        synthetic_eval_pairs,
    )
    from .epe import epe_stats, outlier_rate

    if args.sintel:
        data = SintelDataset(args.sintel)
        pairs = [data[i] for i in range(min(len(data), args.n or 8))]
        src = "sintel"
    elif args.kitti:
        data = KittiFlowDataset(args.kitti)
        pairs = [data[i] for i in range(min(len(data), args.n or 8))]
        src = "kitti"
    elif args.fishnet:
        pairs = fishnet_eval_pairs(args.n or 32, hard=args.hard)
        src = "fishnet-hard" if args.hard else "fishnet"
    else:
        pairs = synthetic_eval_pairs(args.n or 8, hard=args.hard)
        src = "synthetic-hard" if args.hard else "synthetic"
    if not pairs:
        raise SystemExit(f"no eval pairs found for {src}")

    for method in args.method.split(","):
        run = _make_method(method, args.ckpt, args.quick, bf16=args.bf16,
                           device=device)
        all_stats = []
        t_total = 0.0
        for img1, img2, gt, valid in pairs:
            t0 = time.perf_counter()
            flow = run(img1, img2)
            t_total += time.perf_counter() - t0
            s = epe_stats(flow, gt, valid)
            s["fl_all"] = outlier_rate(flow, gt, valid)
            all_stats.append(s)
        # a frame with an empty valid mask gives NaN stats: left out
        agg = {k: float(np.nanmean([s[k] for s in all_stats]))
               for k in all_stats[0]}
        agg.update(method=method, dataset=src, n=len(pairs),
                   sec_per_pair=t_total / len(pairs),
                   dtype="bf16" if args.bf16 and run.learned else "fp32")
        if args.time_device:
            i1, i2 = _frames(pairs[0][0], run.device), _frames(pairs[0][1], run.device)
            t = time_call(lambda: run.flow_fn(i1, i2), run.device,
                          reps=4 if args.quick else 24)
            agg["device_ms_per_frame"] = round(t["ms"], 3)
            agg["timer"] = t["timer"]
            agg["unreliable"] = t["unreliable"]
        print(json.dumps(agg), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
