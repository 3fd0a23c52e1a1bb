"""Device selection: the counterpart of the reference's ``core/backend.py``.

The reference routes between a TPU form and a CPU form of each stage by
probing the JAX backend.  Here the caller names the device: entry points run
on CUDA unless ``device="cpu"`` is passed, and they raise when no CUDA device
exists rather than quietly running on the CPU.

:func:`upload` moves host arrays to the card through pinned memory, so the
copy is a DMA the host does not wait on.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import shutil
import threading

import numpy as np
import torch

from . import spans

# streaming multiprocessors of an H100 SXM: the default the kernels' launch
# configurations assume where no card is asked (the CPU tests)
H100_SMS = 132

# threads of the pool that help the caller copy a host array into pinned
# memory (ops/csrc/host_gather.cpp): one core of an H100 machine's host
# copies ~5 GB/s, the caller and 3 helpers ~16, with 7 ~26 (chip_smoke.py
# --upload); in the 1080p clip cell 7 helpers beat 3 by 3-9% a run
UPLOAD_HELPERS = 7


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


def device_scope(device: torch.device):
    """Make ``device`` the calling thread's current CUDA device for a block
    (a no-op for the CPU).  The current device is per thread: a node's or a
    batcher's worker thread enters it before running a backend that was
    built, and bound to its device, on another thread."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


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


def cached_tensors(maxsize: int):
    """``functools.lru_cache(maxsize)`` for a function that builds constant
    tensors, which builds them outside inference mode.  The cache hands the
    same tensors to every later caller: one made under
    ``torch.inference_mode()`` (a serving call) could not be saved for
    backward by a later training call.  A miss runs inside the
    ``ofc.build`` span (:data:`.spans.BUILD`)."""
    def wrap(fn):
        @functools.lru_cache(maxsize=maxsize)
        @functools.wraps(fn)
        def cached(*args, **kwargs):
            with spans.annotate(spans.BUILD), torch.inference_mode(False):
                return fn(*args, **kwargs)
        return cached
    return wrap


@functools.lru_cache(maxsize=8)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of CUDA device ``device_index``."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def host_gather(dst: torch.Tensor, src: torch.Tensor,
                helpers: int = UPLOAD_HELPERS) -> None:
    """Copy the CPU tensor ``src`` (any strides) into the contiguous CPU
    tensor ``dst`` of its shape and dtype, in C order, with the caller's
    thread and up to ``helpers`` threads of the native pool (the GIL is
    released meanwhile)."""
    from ..ops._build import load_kernels  # ops imports this module

    if (dst.shape != src.shape or dst.dtype != src.dtype or not dst.is_contiguous()
            or dst.device.type != "cpu" or src.device.type != "cpu"):
        raise ValueError(f"host_gather: dst {tuple(dst.shape)} {dst.dtype} on "
                         f"{dst.device} for src {tuple(src.shape)} {src.dtype} "
                         f"on {src.device}")
    n, size = src.dim(), src.element_size()
    shape = (ctypes.c_int64 * max(n, 1))(*src.shape)
    strides = (ctypes.c_int64 * max(n, 1))(*(st * size for st in src.stride()))
    err = load_kernels().ofc_host_gather(dst.data_ptr(), src.data_ptr(), n,
                                         shape, strides, size, helpers)
    if err:
        raise ValueError(f"host_gather: {n} dims over the native copy's limit")


def upload(x, device: torch.device) -> torch.Tensor:
    """``x`` (a numpy array or a tensor) on ``device``, its dtype kept.

    Routed by what ``x`` is: to the CPU as before (a contiguous copy of a
    numpy array's view); a CUDA tensor as it is (or copied to ``device``);
    any host array, pinned or not, is gathered by :func:`host_gather` into
    a pinned block of PyTorch's caching host allocator and sent from there
    by one asynchronous copy on the current stream, counted in
    ``upload.staged`` (uploads) and ``upload.staged_bytes``.  It returns
    once the caller's bytes are in the block, so the caller may overwrite
    them; nothing here synchronises a stream.  The allocator hands the
    block out again only after the copy's event has passed."""
    if device.type != "cuda":
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(device)
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x)
        if any(st < 0 for st in x.strides):  # torch.from_numpy takes none
            x = np.ascontiguousarray(x)
        x = torch.from_numpy(x)
    if x.is_cuda:
        return x.to(device)
    staged = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host_gather(staged, x)
    out = staged.to(device, non_blocking=True)
    with _count_lock:
        upload.staged += 1
        upload.staged_bytes += x.numel() * x.element_size()
    return out


_count_lock = threading.Lock()
upload.staged = 0
upload.staged_bytes = 0
