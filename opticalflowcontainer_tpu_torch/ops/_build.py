"""Build and load the port's CUDA kernels.

All ``csrc/*.cu`` sources, and the host-only ``csrc/*.cpp`` (the junction
detector, the JPEG/PNG decoders and the frame upload's host copy, which
nvcc hands to the host compiler), go through ONE ``nvcc``
call into a shared library with a plain C interface (each kernel has an
``extern "C"`` launcher that returns ``cudaGetLastError()``), loaded with
``ctypes``.  Host code is built with ``-ffp-contract=off``: a fused
multiply-add happens only where the source writes one.  No source includes
PyTorch's headers, so the build takes seconds; there is no lock file and no
fallback: a failed build raises with nvcc's output.

The library lands in ``opticalflowcontainer_tpu_torch/build/`` under a name
that carries a hash of the sources and flags, so an edited source is never
served by a stale library.  It is built at first use (``load_kernels``), or
explicitly with ``build()``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import subprocess
import time

from ..core.device import find_nvcc

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC,-ffp-contract=off", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# C interface of every launcher: name -> (restype, argtypes).  Pointers and
# the stream are c_void_p: a bare Python int would be cut to 32 bits.
_SIGNATURES = {
    "ofc_error_string": (ctypes.c_char_p, [_I]),
    "ofc_max_dynamic_smem": (_I, [_I]),
    # R0, R1, u, v, M, B, H, W, stream (on the current device)
    "ofc_farneback_update": (_I, [_P, _P, _P, _P, _P, _I, _I, _I, _P]),
    # M, taps (device), u, v, B, H, W, r, tile_h, tile_w, smem_bytes, stream
    "ofc_blur_solve": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    # M, taps (host, 2r+1 floats), u, v, B, H, W, r, tile_w, stream
    "ofc_blur_solve_reg": (_I, [_P, ctypes.POINTER(ctypes.c_float), _P, _P,
                                _I, _I, _I, _I, _I, _P]),
    # src, u, v, out, B, C, H, W, edge, use_mask, threshold, groups, wide,
    # stream
    "ofc_warp_bilinear": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               ctypes.c_float, _I, _I, _P]),
    # f1, f2, out, work, B, C, H, W, max_disp, disp_stride, out_stride,
    # tile_w, tile_h, taps, splits, chunk, window stride, 16-byte copies,
    # stages, smem, stream
    "ofc_correlation": (_I, [_P, _P, _P, _P] + [_I] * 16 + [_P]),
    # img, out, frames, H, W, lh, lw, row_pad, col_pad, row_lo, row_hi,
    # row_w, col_lo, col_hi, col_w, blur, p, poly_n, poly taps (host),
    # tile, span_h, span_w, strip_rows, smem, stream
    "ofc_farneback_prep": (_I, [_P, _P, _I, _I, _I, _I, _I] + [_P] * 9
                           + [_I, _I, ctypes.POINTER(ctypes.c_float)]
                           + [_I] * 5 + [_P]),
    # flat, flow, out, B, H, W, K, radius, levels, sizes (host: levels x
    # (first column, h, w)), stream
    "ofc_allpairs_lookup": (_I, [_P, _P, _P] + [_I] * 6
                            + [ctypes.POINTER(ctypes.c_int), _P]),
    # host code: bgr, H, W, grid_area, area_tol, cluster_eps,
    # min_cluster_pts, rb_lo, rb_hi, rotated, out_xy, max_out
    "ofc_detect_junctions": (_I, [_P, _I, _I, _D, _D, _D, _I, _D, _D, _I,
                                  _P, _I]),
    # host code: data, size, out (H x W x 3 BGR), H, W
    "ofc_jpeg_decode": (_I, [_P, ctypes.c_int64, _P, _I, _I]),
    # host code: raw (H rows of a filter byte + W * bpp), out, H, W, bpp
    "ofc_png_unfilter": (_I, [_P, _P, _I, _I, _I]),
    # host code: dst, src, ndim, shape, strides (bytes), element bytes,
    # helper threads
    "ofc_host_gather": (_I, [_P, _P, _I, ctypes.POINTER(ctypes.c_int64),
                             ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, _I]),
}


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    path: pathlib.Path
    seconds: float
    ptxas: tuple[str, ...]  # the "ptxas info" lines of -Xptxas -v
    cached: bool            # True when the library for these sources existed


_lib: ctypes.CDLL | None = None


def _sources() -> list[pathlib.Path]:
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cpp")])


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libofc_kernels_{h.hexdigest()[:16]}.so"


def build() -> BuildInfo:
    """Compile every ``csrc/*.cu`` and ``csrc/*.cpp`` with one nvcc call
    (no-op when the library for the current sources already exists)."""
    out = library_path()
    if out.exists():
        return BuildInfo(out, 0.0, (), cached=True)
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, PATH and the CUDA "
            "toolkit's default prefix): the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in _sources())]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s: "
                           f"{' '.join(cmd)}") from e
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    ptxas = tuple(ln.strip() for ln in proc.stderr.splitlines()
                  if "ptxas info" in ln)
    return BuildInfo(out, seconds, ptxas, cached=False)


def load_kernels() -> ctypes.CDLL:
    """The kernel library, built on first use and loaded once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build().path))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
    return _lib


def check_launch(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if err != 0:
        msg = load_kernels().ofc_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
