"""Build, bind and launch the windowed bilinear samplers K1 and K1-v.

Two CUDA sources under ``mba_vo_tpu_torch/csrc/``:

  * ``window_bilinear.cu`` (K1) replaces the Pallas kernel
    ``mba_vo_tpu/ops/pallas_sampling.py::pallas_window_bilinear``. The
    tracker runs :func:`window_bilinear_cuda`: one thread per sample loads
    its coordinates, then its 2x2 taps. :func:`window_bilinear_band_cuda`
    is a redesign for Hopper that the sampler sweep measures and the tracker
    does not launch (slower on the tracker's own inputs): one warp per
    keypoint issues bulk asynchronous copies of two bands of window rows
    (``TOP_ROWS`` from row 0, ``BAND_ROWS`` around the keypoint) together
    with its samples' coordinate loads, waits once, and reads the taps from
    shared memory (device memory for a tap on another row).
  * ``window_bilinear_tiled.cu`` (K1-v) replaces the tile sweep
    ``experiments/kernel_variants_r04.py::run_v0_tile``.
    :func:`window_bilinear_tiled_cuda` stages whole windows through a ring
    of 2 shared-memory stages, one producer warp copying keypoint k + 1
    while the other warps sample keypoint k;
    :func:`window_bilinear_staged_cuda` is its first design, which staged a
    tile's windows, synchronised, then sampled. The sweep harness
    ``mba_vo_tpu_torch.experiments.kernel_variants`` runs both.

The libraries are built and loaded by ``ops/cuda_build.py`` (all of the
port's sources at once, at first use). Nothing here runs when the module is
imported, so CPU-only installs import it freely.

The wrappers take CUDA tensors only and raise on anything else; none falls
back to the plain version. Windows may have any keypoint stride as long as
each keypoint's [C, win_h, win_w] block is contiguous, so the C = 1 slice
``windows[:, :1]`` of a C = 3 cache is read in place. ``LAUNCHES``,
``LAUNCHES_BAND``, ``LAUNCHES_TILED`` and ``LAUNCHES_STAGED`` count each
wrapper's launches so a run can show that it went through each kernel; a
call recorded into a CUDA graph is not a launch and is not counted.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cuda_build

# launches of each kernel since the process started (or since a caller reset
# them): K1 as the tracker runs it, K1's band design, K1-v, K1-v's first
# design
LAUNCHES = 0
LAUNCHES_BAND = 0
LAUNCHES_TILED = 0
LAUNCHES_STAGED = 0
# dynamic shared memory a block may use on sm_90
MAX_SHARED_BYTES = 232448
# window rows K1's band design stages per channel plane: BAND_ROWS centred
# on the keypoint's own two tap rows and TOP_ROWS from row 0 (the rows of
# padded keypoint slots and of taps outside the window), compiled into
# window_bilinear.cu (-DWB_BAND, -DWB_TOP). Chosen from the histogram of the
# tracker's tap rows (experiments/kernel_variants.py, tap_row_histogram):
# together they hold 95 % of the tracker's taps at S = 40 and 96 % at
# S = 160
BAND_ROWS = 8
TOP_ROWS = 4

_loaded: Dict[str, ctypes.CDLL] = {}


# entry points of each library; the tiled ones take a tile before threads
_ENTRIES = {
    "window_bilinear": ("window_bilinear", "window_bilinear_band"),
    "window_bilinear_tiled": ("window_bilinear_tiled", "window_bilinear_staged"),
}


def _load(name: str) -> ctypes.CDLL:
    if name not in _loaded:
        lib = cuda_build.load(name)
        extra = 1 if name == "window_bilinear" else 2   # threads | tile, threads
        # win, kp_stride, xy, valid, out, N, C, win_h, win_w, S, [tile,] threads, stream
        args = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * (5 + extra) + [ctypes.c_void_p])
        for entry in _ENTRIES[name]:
            for fn_name in (f"{entry}_f32", f"{entry}_f64"):
                fn = getattr(lib, fn_name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
        if name == "window_bilinear":
            for query in (lib.window_bilinear_band_rows, lib.window_bilinear_top_rows):
                query.argtypes = []
                query.restype = ctypes.c_int
            built = (lib.window_bilinear_band_rows(), lib.window_bilinear_top_rows())
            if built != (BAND_ROWS, TOP_ROWS):
                raise RuntimeError(f"window_bilinear.cu was built with bands {built}, "
                                   f"not (BAND_ROWS, TOP_ROWS) = {(BAND_ROWS, TOP_ROWS)}")
        _loaded[name] = lib
    return _loaded[name]


def keypoint_stride(windows: torch.Tensor) -> int:
    """Elements between consecutive keypoints of [N, C, win_h, win_w]
    windows whose every keypoint block [C, win_h, win_w] is contiguous (a
    contiguous tensor, or a slice along C such as ``windows[:, :1]``);
    raises ValueError for any other layout."""
    if windows.dim() != 4:
        raise ValueError(f"windows must be [N, C, win_h, win_w], got {tuple(windows.shape)}")
    n, c, h, w = windows.shape
    expected = 1
    for size, stride in zip((w, h, c), reversed(windows.stride()[1:])):
        if size != 1 and stride != expected:
            raise ValueError("windows: each keypoint's [C, win_h, win_w] block must be "
                             f"contiguous, got strides {windows.stride()}")
        expected *= size
    return windows.stride(0) if n > 1 else c * h * w


def kernel_windows(windows: torch.Tensor) -> torch.Tensor:
    """``windows`` as the kernels take them: the tensor itself where each
    keypoint's block is contiguous (no copy), else a contiguous copy."""
    try:
        keypoint_stride(windows)
        return windows
    except ValueError:
        return windows.contiguous()


def band_shared_bytes(threads: int, C: int, win_h: int, win_w: int, itemsize: int) -> int:
    """Dynamic shared memory of a K1 block (window_bilinear.cu's
    band_shared_bytes): an mbarrier per warp, then per warp C planes of
    min(TOP_ROWS, win_h) + min(BAND_ROWS, win_h) rows, each padded to 16
    bytes."""
    warps = threads // 32
    per16 = 16 // itemsize
    rows = min(TOP_ROWS, win_h) + min(BAND_ROWS, win_h)
    plane = -(-rows * win_w // per16) * per16
    return -(-8 * warps // 16) * 16 + warps * C * plane * itemsize


def ring_shared_bytes(C: int, win_h: int, win_w: int, S: int, itemsize: int) -> int:
    """Dynamic shared memory of a K1-v block (window_bilinear_tiled.cu): a
    128-byte header of mbarriers and 2 stages of one keypoint's window
    planes, coordinate row and mask row, each padded to 16 bytes."""
    def pad(b):
        return -(-b // 16) * 16
    return 128 + 2 * (pad(C * win_h * win_w * itemsize) + pad(2 * S * itemsize)
                      + pad(S * itemsize))


def _check(who: str, windows: torch.Tensor, local_xy: torch.Tensor,
           valid: torch.Tensor, threads: int, min_threads: int = 32):
    """The checks every wrapper shares; returns
    (suffix, kp_stride, N, C, win_h, win_w, S)."""
    for name, x in (("windows", windows), ("local_xy", local_xy), ("valid", valid)):
        if not x.is_cuda:
            raise ValueError(f"{who}: {name} is on {x.device}, not CUDA")
        if x.device != windows.device:
            raise ValueError(f"{who}: {name} is on {x.device}, "
                             f"windows on {windows.device}")
        if x.dtype != windows.dtype:
            raise ValueError(f"{who}: {name} is {x.dtype}, "
                             f"windows {windows.dtype}")
    for name, x in (("local_xy", local_xy), ("valid", valid)):
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
    if windows.dtype == torch.float32:
        suffix = "f32"
    elif windows.dtype == torch.float64:
        suffix = "f64"
    else:
        raise ValueError(f"{who}: unsupported dtype {windows.dtype}")
    try:
        kp_stride = keypoint_stride(windows)
    except ValueError as e:
        raise ValueError(f"{who}: {e}: not contiguous per keypoint") from None
    N, C, win_h, win_w = windows.shape
    if local_xy.dim() != 3 or local_xy.shape[0] != N or local_xy.shape[2] != 2:
        raise ValueError(f"local_xy must be [{N}, S, 2], got {tuple(local_xy.shape)}")
    if local_xy.data_ptr() % (2 * local_xy.element_size()):
        raise ValueError(f"{who}: local_xy must start on a multiple of "
                         f"{2 * local_xy.element_size()} bytes (one (x, y) load per sample)")
    S = local_xy.shape[1]
    if tuple(valid.shape) != (N, S):
        raise ValueError(f"valid must be [{N}, {S}], got {tuple(valid.shape)}")
    if N * S >= 2 ** 31 or max(N - 1, 0) * kp_stride + C * win_h * win_w >= 2 ** 31:
        raise ValueError(f"{who}: sizes exceed 32-bit indexing")
    if threads % 32 or not min_threads <= threads <= 1024:
        raise ValueError(f"{who}: threads must be a multiple of 32 in "
                         f"[{min_threads}, 1024], got {threads}")
    return suffix, kp_stride, N, C, win_h, win_w, S


def _launch(fn, windows, kp_stride, local_xy, valid, out, *ints) -> int:
    """Launch on the current stream; returns the launches made: 1, or 0 when
    the stream is capturing a CUDA graph, where the call is only recorded
    (the graph's replays launch it, unseen from here)."""
    with torch.cuda.device(windows.device):
        stream = torch.cuda.current_stream().cuda_stream
        recorded = torch.cuda.is_current_stream_capturing()
        err = fn(windows.data_ptr(), kp_stride, local_xy.data_ptr(), valid.data_ptr(),
                 out.data_ptr(), *ints, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return 0 if recorded else 1


def _shared_limit(who: str, need: int, what: str):
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"{who}: {what} needs {need} bytes of shared memory; a "
                         f"block may use {MAX_SHARED_BYTES}")


def _k1(entry: str, who: str, windows, local_xy, valid, threads):
    suffix, kp_stride, N, C, win_h, win_w, S = _check(who, windows, local_xy, valid, threads)
    fn = getattr(_load("window_bilinear"), f"{entry}_{suffix}")
    out = torch.empty((N, C, S), dtype=windows.dtype, device=windows.device)
    return out, _launch(fn, windows, kp_stride, local_xy, valid, out,
                        N, C, win_h, win_w, S, threads)


def window_bilinear_cuda(windows: torch.Tensor, local_xy: torch.Tensor,
                         valid: torch.Tensor, threads: int = 128) -> torch.Tensor:
    """K1: [N, C, S] bilinear samples of [N, C, win_h, win_w] windows at
    window-relative [N, S, 2] coordinates, times a float [N, S] mask; one
    thread per sample.

    All three tensors must be CUDA tensors of one dtype (float32 or float64)
    on one device; ``local_xy`` and ``valid`` contiguous, ``windows``
    contiguous per keypoint. ``threads``: threads per block.
    """
    global LAUNCHES
    out, n = _k1("window_bilinear", "window_bilinear_cuda", windows, local_xy, valid, threads)
    LAUNCHES += n
    return out


def window_bilinear_band_cuda(windows: torch.Tensor, local_xy: torch.Tensor,
                              valid: torch.Tensor, threads: int = 128) -> torch.Tensor:
    """K1's band design: the function of :func:`window_bilinear_cuda`, a
    warp per keypoint reading its taps from bands of window rows that bulk
    asynchronous copies stage in shared memory. A row of the sampler sweep;
    the tracker does not launch it. Raises when a block's bands exceed a
    block's shared memory."""
    global LAUNCHES_BAND
    who = "window_bilinear_band_cuda"
    if windows.dim() == 4:
        C, win_h, win_w = windows.shape[1:]
        _shared_limit(who, band_shared_bytes(threads, C, win_h, win_w,
                                             windows.element_size()),
                      f"a block of {threads // 32} bands of [{C}, "
                      f"{min(TOP_ROWS, win_h) + min(BAND_ROWS, win_h)}, {win_w}] "
                      f"{windows.dtype}")
    out, n = _k1("window_bilinear_band", who, windows, local_xy, valid, threads)
    LAUNCHES_BAND += n
    return out


def window_bilinear_tiled_cuda(windows: torch.Tensor, local_xy: torch.Tensor,
                               valid: torch.Tensor, tile: int,
                               threads: int) -> torch.Tensor:
    """K1-v: the function of :func:`window_bilinear_cuda`, computed by
    persistent thread blocks that each walk tiles of ``tile`` consecutive
    keypoints, staging one keypoint's whole window at a time through a ring
    of 2 shared-memory stages; ``threads`` threads a block, one warp of them
    the producer.

    Raises when the ring (:func:`ring_shared_bytes`) exceeds the 232,448
    bytes of shared memory a block may use.
    """
    global LAUNCHES_TILED
    who = "window_bilinear_tiled_cuda"
    suffix, kp_stride, N, C, win_h, win_w, S = _check(
        who, windows, local_xy, valid, threads, min_threads=64)
    if tile < 1:
        raise ValueError(f"{who}: tile must be at least 1, got {tile}")
    _shared_limit(who, ring_shared_bytes(C, win_h, win_w, S, windows.element_size()),
                  f"a ring of 2 stages of a [{C}, {win_h}, {win_w}] window and {S} "
                  f"samples in {windows.dtype}")
    fn = getattr(_load("window_bilinear_tiled"), f"window_bilinear_tiled_{suffix}")
    out = torch.empty((N, C, S), dtype=windows.dtype, device=windows.device)
    LAUNCHES_TILED += _launch(fn, windows, kp_stride, local_xy, valid, out,
                              N, C, win_h, win_w, S, tile, threads)
    return out


def window_bilinear_staged_cuda(windows: torch.Tensor, local_xy: torch.Tensor,
                                valid: torch.Tensor, tile: int,
                                threads: int) -> torch.Tensor:
    """K1-v's first design: a block stages the windows of ``tile``
    consecutive keypoints in shared memory, synchronises, then samples them.
    A baseline for the sampler sweep. Takes contiguous windows only, and
    raises when tile * C * win_h * win_w * itemsize exceeds a block's
    shared memory."""
    global LAUNCHES_STAGED
    who = "window_bilinear_staged_cuda"
    suffix, kp_stride, N, C, win_h, win_w, S = _check(who, windows, local_xy, valid, threads)
    if not windows.is_contiguous():
        raise ValueError(f"{who}: windows is not contiguous")
    if tile < 1:
        raise ValueError(f"{who}: tile must be at least 1, got {tile}")
    _shared_limit(who, tile * C * win_h * win_w * windows.element_size(),
                  f"a tile of {tile} windows of [{C}, {win_h}, {win_w}] {windows.dtype}")
    fn = getattr(_load("window_bilinear_tiled"), f"window_bilinear_staged_{suffix}")
    out = torch.empty((N, C, S), dtype=windows.dtype, device=windows.device)
    LAUNCHES_STAGED += _launch(fn, windows, C * win_h * win_w, local_xy, valid, out,
                               N, C, win_h, win_w, S, tile, threads)
    return out
