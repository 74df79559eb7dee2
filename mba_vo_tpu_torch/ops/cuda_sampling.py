"""Build, bind and launch kernel K1, the windowed bilinear sampler.

The CUDA source is ``mba_vo_tpu_torch/csrc/window_bilinear.cu`` (it replaces
the Pallas kernel ``mba_vo_tpu/ops/pallas_sampling.py::
pallas_window_bilinear``). At first use it is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface under
``build/mba_vo_tpu_torch/`` at the root of the checkout, keyed by a hash of
the source and flags, and loaded with ``ctypes``. Nothing here runs when the
module is imported, so CPU-only installs import it freely.

:func:`window_bilinear_cuda` takes CUDA tensors only and raises on anything
else; it never falls back to the plain version. ``LAUNCHES`` counts its
launches so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import torch

# launches of K1 since the process started (or since a caller reset it)
LAUNCHES = 0
# nvcc's output (with -Xptxas -v: registers, shared memory, spills) when
# this process built the library rather than finding it in the build directory
BUILD_LOG = ""

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "window_bilinear.cu"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mba_vo_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build() -> Path:
    """Compile the kernel library unless this source was built already;
    returns the library's path."""
    global BUILD_LOG
    src = _SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = _BUILD_DIR / f"window_bilinear_{key}.so"
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
        capture_output=True, text=True,
    )
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{BUILD_LOG}")
    os.replace(tmp, lib_path)
    return lib_path


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        for name in ("window_bilinear_f32", "window_bilinear_f64"):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def window_bilinear_cuda(windows: torch.Tensor, local_xy: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """[N, C, S] bilinear samples of [N, C, win_h, win_w] windows at
    window-relative [N, S, 2] coordinates, times a float [N, S] mask.

    All three tensors must be contiguous CUDA tensors of one dtype (float32
    or float64) on one device.
    """
    global LAUNCHES
    for name, x in (("windows", windows), ("local_xy", local_xy), ("valid", valid)):
        if not x.is_cuda:
            raise ValueError(f"window_bilinear_cuda: {name} is on {x.device}, not CUDA")
        if x.device != windows.device:
            raise ValueError(f"window_bilinear_cuda: {name} is on {x.device}, "
                             f"windows on {windows.device}")
        if x.dtype != windows.dtype:
            raise ValueError(f"window_bilinear_cuda: {name} is {x.dtype}, "
                             f"windows {windows.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"window_bilinear_cuda: {name} is not contiguous")
    if windows.dtype == torch.float32:
        name = "window_bilinear_f32"
    elif windows.dtype == torch.float64:
        name = "window_bilinear_f64"
    else:
        raise ValueError(f"window_bilinear_cuda: unsupported dtype {windows.dtype}")
    if windows.dim() != 4:
        raise ValueError(f"windows must be [N, C, win_h, win_w], got {tuple(windows.shape)}")
    N, C, win_h, win_w = windows.shape
    if local_xy.dim() != 3 or local_xy.shape[0] != N or local_xy.shape[2] != 2:
        raise ValueError(f"local_xy must be [{N}, S, 2], got {tuple(local_xy.shape)}")
    S = local_xy.shape[1]
    if tuple(valid.shape) != (N, S):
        raise ValueError(f"valid must be [{N}, {S}], got {tuple(valid.shape)}")
    if N * S >= 2 ** 31 or N * C * win_h * win_w >= 2 ** 31:
        raise ValueError("window_bilinear_cuda: sizes exceed 32-bit indexing")

    fn = getattr(_load(), name)
    out = torch.empty((N, C, S), dtype=windows.dtype, device=windows.device)
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(windows.data_ptr(), local_xy.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), N, C, win_h, win_w, S, stream)
    if err != 0:
        raise RuntimeError(f"window_bilinear kernel launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out
