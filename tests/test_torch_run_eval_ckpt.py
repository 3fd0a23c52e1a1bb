"""The port's eval harness with ``--ckpt`` and ``--bf16`` against the JAX
package's ``main()`` (the rest is in ``test_torch_run_eval.py``).

- ``--ckpt x.npz``: the packaged NeuFlowLite npz as a candidate; EPE
  within 1e-3 px of JAX's.
- ``--ckpt x.pytorch``: a sniklaus-format PWC-Net checkpoint built from
  the packaged npz with the JAX package's ``invert_entry`` and saved with
  ``torch.save``; both harnesses convert it and flip the RGB pairs to BGR;
  on colour pairs of a small Sintel tree written here, so that the flip
  shows; EPE within 1e-3 px of JAX's.
- ``--bf16``: NeuFlowLite's bf16 row within ``tests/test_bf16_serving.py``'s
  NeuFlowLite bar (mean |bf16 - fp32| flow < 0.05 px, so the EPEs differ by
  less) of the port's fp32 row, labelled bf16; a classical method in the
  same run stays fp32."""
import cv2
import numpy as np
import pytest
import torch

from opticalflowcontainer_tpu.models import convert as jconvert
from opticalflowcontainer_tpu.utils.flo import write_flo
from opticalflowcontainer_tpu_torch.eval import run_eval as prun_eval
from opticalflowcontainer_tpu_torch.models import convert as pconvert
from test_torch_run_eval import check_rows, rows

from test_torch_threads import one_torch_thread  # noqa: F401


def test_npz_candidate_rows_match_jax():
    npz = str(pconvert.WEIGHTS_DIR / "neuflow_lite_synth.npz")
    check_rows(["--method", "neuflow", "--ckpt", npz, "--n", "2", "--cpu"])


def test_torch_checkpoint_rows_match_jax(tmp_path):
    flat = pconvert.load_flat_npz(pconvert.WEIGHTS_DIR / "pwcnet_synth.npz")
    sd = {}
    for e in jconvert.pwcnet_table():
        prefix = "/".join(e.flax_path + (("Conv_0",) if e.kind == "conv" else ()))
        sd.update(jconvert.invert_entry(e, flat[f"{prefix}/kernel"],
                                        flat.get(f"{prefix}/bias")))
    path = tmp_path / "pwc.pytorch"
    torch.save({"model": {k.replace("net", "module"): torch.from_numpy(v)
                          for k, v in sd.items()}}, path)
    rng = np.random.default_rng(0)
    root = tmp_path / "sintel" / "training"
    scene, flows = root / "clean" / "s", root / "flow" / "s"
    scene.mkdir(parents=True)
    flows.mkdir(parents=True)
    base = cv2.GaussianBlur(rng.uniform(0, 255, (80, 100, 3)).astype(np.float32), (0, 0), 2)
    for i in range(3):
        cv2.imwrite(str(scene / f"frame_{i:04d}.png"),
                    base[8:72, 8 - i:92 - i].astype(np.uint8))
        write_flo(str(flows / f"frame_{i:04d}.flo"),
                  np.tile(np.float32([1.0, 0.0]), (64, 84, 1)))
    argv = ["--sintel", str(tmp_path / "sintel"), "--n", "2", "--cpu", "--method", "pwcnet"]
    want, got = check_rows(argv + ["--ckpt", str(path)])
    (plain,) = rows(prun_eval.main, argv)
    assert got[0]["dataset"] == "sintel" and got[0]["n"] == 2
    assert got[0]["epe"] != plain["epe"]  # the BGR flip took effect


def test_ckpt_without_a_converter_exits(tmp_path):
    path = tmp_path / "x.pytorch"
    torch.save({}, path)
    with pytest.raises(SystemExit, match="accepts only flat-npz"):
        prun_eval.main(["--method", "neuflow", "--ckpt", str(path), "--n", "1", "--cpu"])


def test_bf16_row_within_the_bf16_bar_of_fp32():
    fp32, far = rows(prun_eval.main, ["--method", "neuflow,farneback", "--n", "2", "--cpu"])
    bf16, far16 = rows(prun_eval.main, ["--method", "neuflow,farneback", "--n", "2",
                                        "--cpu", "--bf16"])
    assert (fp32["dtype"], bf16["dtype"], far16["dtype"]) == ("fp32", "bf16", "fp32")
    assert abs(bf16["epe"] - fp32["epe"]) < 0.05
    assert far16["epe"] == far["epe"]
