"""Device selection: the counterpart of the reference's ``core/backend.py``.

The reference routes between a TPU form and a CPU form of each stage by
probing the JAX backend.  Here the caller names the device: entry points run
on CUDA unless ``device="cpu"`` is passed, and they raise when no CUDA device
exists rather than quietly running on the CPU.
"""
from __future__ import annotations

import os
import shutil

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device and raises when there is none;
    ``"cpu"`` (or a CPU ``torch.device``) is honoured only when asked for.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def find_nvcc() -> str | None:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install prefix."""
    for var in ("CUDA_HOME", "CUDA_PATH"):
        base = os.environ.get(var)
        if base and os.path.isfile(os.path.join(base, "bin", "nvcc")):
            return os.path.join(base, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.path.isfile(default) else None


def capabilities() -> dict:
    """What this process can run: torch and CUDA versions, the card's name
    and compute capability, and the compiler that builds the kernels."""
    report = {
        "torch": torch.__version__,
        "cuda_runtime": torch.version.cuda,
        "cuda_available": torch.cuda.is_available(),
        "device_count": torch.cuda.device_count() if torch.cuda.is_available() else 0,
        "nvcc": find_nvcc(),
    }
    if report["cuda_available"]:
        major, minor = torch.cuda.get_device_capability(0)
        report["name"] = torch.cuda.get_device_name(0)
        report["sm"] = f"sm_{major}{minor}"
    return report
