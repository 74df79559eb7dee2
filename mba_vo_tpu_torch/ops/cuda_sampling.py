"""Build, bind and launch the windowed bilinear samplers K1 and K1-v.

Two CUDA sources under ``mba_vo_tpu_torch/csrc/``:

  * ``window_bilinear.cu`` (K1) replaces the Pallas kernel
    ``mba_vo_tpu/ops/pallas_sampling.py::pallas_window_bilinear``: one thread
    per sample gathers its 2x2 taps from device memory. The tracker runs it.
  * ``window_bilinear_tiled.cu`` (K1-v) replaces the tile sweep
    ``experiments/kernel_variants_r04.py::run_v0_tile``: a thread block
    stages the windows of ``tile`` keypoints in shared memory first. The
    sweep harness ``mba_vo_tpu_torch.experiments.kernel_variants`` runs it.

At first use each source is compiled with ``nvcc`` for ``sm_90a`` (both at
once, one process each) into a shared library with a plain C interface under
``build/mba_vo_tpu_torch/`` at the root of the checkout, keyed by a hash of
the source and flags, and loaded with ``ctypes``. Nothing here runs when the
module is imported, so CPU-only installs import it freely.

:func:`window_bilinear_cuda` and :func:`window_bilinear_tiled_cuda` take
CUDA tensors only and raise on anything else; neither falls back to the
plain version. ``LAUNCHES`` and ``LAUNCHES_TILED`` count their launches so a
run can show that it went through each kernel; a call recorded into a CUDA
graph is not a launch and is not counted.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict

import torch

# launches of K1 / K1-v since the process started (or since a caller reset them)
LAUNCHES = 0
LAUNCHES_TILED = 0
# nvcc's output per source (with -Xptxas -v: registers, shared memory, spills)
# when this process built the library rather than finding it in the build
# directory
BUILD_LOG: Dict[str, str] = {}

# dynamic shared memory a block may use on sm_90
MAX_SHARED_BYTES = 232448

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = {
    "window_bilinear": _CSRC / "window_bilinear.cu",
    "window_bilinear_tiled": _CSRC / "window_bilinear_tiled.cu",
}
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mba_vo_tpu_torch"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def build() -> Dict[str, Path]:
    """Compile every kernel library whose source was not built already, all
    compilers started together; returns the libraries' paths by name."""
    paths, running = {}, []
    for name, source in _SOURCES.items():
        key = hashlib.sha256(
            source.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        paths[name] = _BUILD_DIR / f"{name}_{key}.so"
        if paths[name].exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        running.append((name, tmp, proc))
    failed = []
    for name, tmp, proc in running:
        BUILD_LOG[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{BUILD_LOG[name]}")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def _load(name: str) -> ctypes.CDLL:
    if name not in _libs:
        lib = ctypes.CDLL(str(build()[name]))
        extra = 1 if name == "window_bilinear" else 2   # threads | tile, threads
        args = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (5 + extra) + [ctypes.c_void_p]
        for fn_name in (f"{name}_f32", f"{name}_f64"):
            fn = getattr(lib, fn_name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _libs[name] = lib
    return _libs[name]


def _check(who: str, windows: torch.Tensor, local_xy: torch.Tensor,
           valid: torch.Tensor, threads: int):
    """The checks both wrappers share; returns (suffix, N, C, win_h, win_w, S)."""
    for name, x in (("windows", windows), ("local_xy", local_xy), ("valid", valid)):
        if not x.is_cuda:
            raise ValueError(f"{who}: {name} is on {x.device}, not CUDA")
        if x.device != windows.device:
            raise ValueError(f"{who}: {name} is on {x.device}, "
                             f"windows on {windows.device}")
        if x.dtype != windows.dtype:
            raise ValueError(f"{who}: {name} is {x.dtype}, "
                             f"windows {windows.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    if windows.dtype == torch.float32:
        suffix = "f32"
    elif windows.dtype == torch.float64:
        suffix = "f64"
    else:
        raise ValueError(f"{who}: unsupported dtype {windows.dtype}")
    if windows.dim() != 4:
        raise ValueError(f"windows must be [N, C, win_h, win_w], got {tuple(windows.shape)}")
    N, C, win_h, win_w = windows.shape
    if local_xy.dim() != 3 or local_xy.shape[0] != N or local_xy.shape[2] != 2:
        raise ValueError(f"local_xy must be [{N}, S, 2], got {tuple(local_xy.shape)}")
    S = local_xy.shape[1]
    if tuple(valid.shape) != (N, S):
        raise ValueError(f"valid must be [{N}, {S}], got {tuple(valid.shape)}")
    if N * S >= 2 ** 31 or N * C * win_h * win_w >= 2 ** 31:
        raise ValueError(f"{who}: sizes exceed 32-bit indexing")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"{who}: threads must be a multiple of 32 in [32, 1024], "
                         f"got {threads}")
    return suffix, N, C, win_h, win_w, S


def _launch(fn, windows, local_xy, valid, out, *ints) -> int:
    """Launch on the current stream; returns the launches made: 1, or 0 when
    the stream is capturing a CUDA graph, where the call is only recorded
    (the graph's replays launch it, unseen from here)."""
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream().cuda_stream
        recorded = torch.cuda.is_current_stream_capturing()
        err = fn(windows.data_ptr(), local_xy.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return 0 if recorded else 1


def window_bilinear_cuda(windows: torch.Tensor, local_xy: torch.Tensor,
                         valid: torch.Tensor, threads: int = 128) -> torch.Tensor:
    """K1: [N, C, S] bilinear samples of [N, C, win_h, win_w] windows at
    window-relative [N, S, 2] coordinates, times a float [N, S] mask.

    All three tensors must be contiguous CUDA tensors of one dtype (float32
    or float64) on one device. ``threads``: threads per block.
    """
    global LAUNCHES
    suffix, N, C, win_h, win_w, S = _check(
        "window_bilinear_cuda", windows, local_xy, valid, threads)
    fn = getattr(_load("window_bilinear"), f"window_bilinear_{suffix}")
    out = torch.empty((N, C, S), dtype=windows.dtype, device=windows.device)
    LAUNCHES += _launch(fn, windows, local_xy, valid, out, N, C, win_h, win_w, S, threads)
    return out


def window_bilinear_tiled_cuda(windows: torch.Tensor, local_xy: torch.Tensor,
                               valid: torch.Tensor, tile: int,
                               threads: int) -> torch.Tensor:
    """K1-v: the function of :func:`window_bilinear_cuda`, computed by thread
    blocks that each stage the windows of ``tile`` consecutive keypoints in
    shared memory and sample them with ``threads`` threads.

    Raises (and does not shrink the tile) when
    tile * C * win_h * win_w * itemsize exceeds the 232,448 bytes of shared
    memory a block may use.
    """
    global LAUNCHES_TILED
    who = "window_bilinear_tiled_cuda"
    suffix, N, C, win_h, win_w, S = _check(who, windows, local_xy, valid, threads)
    if tile < 1:
        raise ValueError(f"{who}: tile must be at least 1, got {tile}")
    need = tile * C * win_h * win_w * windows.element_size()
    if need > MAX_SHARED_BYTES:
        raise ValueError(
            f"{who}: a tile of {tile} windows of [{C}, {win_h}, {win_w}] "
            f"{windows.dtype} needs {need} bytes of shared memory; a block may "
            f"use {MAX_SHARED_BYTES}")
    fn = getattr(_load("window_bilinear_tiled"), f"window_bilinear_tiled_{suffix}")
    out = torch.empty((N, C, S), dtype=windows.dtype, device=windows.device)
    LAUNCHES_TILED += _launch(
        fn, windows, local_xy, valid, out, N, C, win_h, win_w, S, tile, threads)
    return out
