"""The port's CUDA image (``deploy/cuda/``), checked without docker: every
path its Dockerfile copies or runs exists in the repository, the image
names no JAX, libtpu, cv2 or PIL package, and its build check compiles
the kernels and runs the hygiene test."""
import pathlib
import re
import shlex

import yaml

ROOT = pathlib.Path(__file__).resolve().parent.parent
CUDA = ROOT / "deploy" / "cuda"


def _instructions() -> list[tuple[str, str]]:
    """(instruction, arguments) of the Dockerfile, continuations joined."""
    text = re.sub(r"\\\n", " ", (CUDA / "Dockerfile").read_text())
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not line.startswith("#"):
            word, _, rest = line.partition(" ")
            out.append((word.upper(), rest.strip()))
    return out


def test_the_files_exist():
    for name in ("Dockerfile", "compose.yaml", "env.sh", "requirements.txt"):
        assert (CUDA / name).is_file(), name


def test_every_copied_and_run_path_exists():
    steps = _instructions()
    assert steps[0][0] == "FROM" and "nvidia/cuda" in steps[0][1] and "devel" in steps[0][1]
    copied = [src for word, args in steps if word == "COPY"
              for src in shlex.split(args)[:-1]]
    assert copied, "the Dockerfile copies nothing"
    for src in copied:
        assert (ROOT / src).exists(), src
    run_paths = [tok for word, args in steps if word == "RUN"
                 for tok in shlex.split(args) if re.match(r"^(tests|deploy)/\S+$", tok)]
    assert run_paths
    for path in run_paths:
        assert (ROOT / path).exists(), path
        assert any(path == src or path.startswith(src.rstrip("/") + "/")
                   for src in copied), f"{path} is run but not copied"


def test_the_image_names_no_jax_tpu_cv2_or_pil_package():
    banned = re.compile(r"\b(jax|jaxlib|libtpu|cv2|opencv\S*|pil|pillow)\b", re.I)
    reqs = [ln.split("#")[0].strip() for ln in
            (CUDA / "requirements.txt").read_text().splitlines()]
    pkgs = [ln for ln in reqs if ln and not ln.startswith("-")]
    assert {re.split(r"[=<>]", p)[0] for p in pkgs} >= {"torch", "numpy", "pytest"}
    assert all("==" in p for p in pkgs), "every package pinned"
    assert not [p for p in pkgs if banned.search(p)]
    for word, args in _instructions():
        if word in ("RUN", "FROM"):
            assert not banned.search(args), args


def test_the_build_check_builds_the_kernels_and_runs_the_hygiene_test():
    runs = [args for word, args in _instructions() if word == "RUN"]
    check = [r for r in runs if "_build.build()" in r]
    assert len(check) == 1
    assert "tests/test_torch_hygiene.py" in check[0] and "--noconftest" in check[0]
    assert "|| true" not in check[0]


def test_compose_reserves_the_gpu_and_passes_the_camera_through():
    svc = yaml.safe_load((CUDA / "compose.yaml").read_text())["services"]["ofc_cuda"]
    assert svc["runtime"] == "nvidia" and svc["network_mode"] == "host"
    assert svc["build"]["dockerfile"] == "deploy/cuda/Dockerfile"
    assert (CUDA / svc["build"]["context"]).resolve() == ROOT
    gpu = svc["deploy"]["resources"]["reservations"]["devices"][0]
    assert gpu["driver"] == "nvidia" and "gpu" in gpu["capabilities"]
    assert "/dev/video0:/dev/video0" in svc["devices"]
    assert "/dev/bus/usb:/dev/bus/usb" in svc["volumes"]
    assert any(e.startswith("OFC_BUS_NAMESPACE=") for e in svc["environment"])
    assert "OFC_BUS_NAMESPACE" in (CUDA / "env.sh").read_text()
