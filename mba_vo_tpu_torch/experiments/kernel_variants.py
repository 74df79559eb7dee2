"""Sampler kernel variant sweep on one NVIDIA GPU.

Counterpart of ``experiments/kernel_variants_r04.py::main``, which timed the
TPU sampler and its fixed-tile variant ``run_v0_tile``. Run from the root of
the repository on a machine with the card:

    python3 -m mba_vo_tpu_torch.experiments.kernel_variants

Inputs follow that sweep's recipe (``make_inputs``: standard-normal windows,
coordinates uniform in [-2, win + 1], a 0/1 mask, seed 0) at N = 512
keypoints, 32x32 windows, float32, for S in {40, 160, 320} samples per
keypoint (one frame of 8 patch pixels x 5 virtual poses, a joint chunk of 4
frames, one of 8) and C in {3, 1} channels. Rows per shape:

  * K1 (``window_bilinear_cuda``) at 64, 128 and 256 threads per block;
  * K1-v (``window_bilinear_tiled_cuda``) at every (tile, threads) of
    TILES x THREADS;
  * the plain PyTorch version (``window_bilinear_plain``);
  * ``torch.nn.functional.grid_sample`` (bilinear, zero padding,
    ``align_corners=True``) times the mask: the one library call that
    computes the same function. It is a yardstick here and the port calls it
    nowhere else.

Each row has max |out - plain|, three times per call and the least time the
card could take. ``ms`` is the median over ``reps`` of the mean of ``inner``
back-to-back calls between two CUDA events: what a caller in Python waits,
which for kernels this small is the host's cost of a launch. ``device_ms`` is
the same call captured ``inner`` times into a CUDA graph and replayed, so
that the host is out of the way and the kernels run back to back on the
device; every call reads the same inputs, which therefore stay in the L2
cache. ``device_cold_ms`` is a graph whose calls walk through enough input
sets (seeds 0, 1, ...) to hold twice the L2 cache's size, each call writing
an output buffer of its own, so that every call finds its inputs in device
memory only: the time to hold against the bound.

The bound is the larger of bytes over the published 3.35 TB/s of an H100 and
operations over its float32 rate. The function is a gather, so the bytes are
what these inputs need: the distinct window elements under a tap of non-zero
weight of a sample whose mask is not 0, over all channels, plus the
coordinates, the mask and the output once each. ``staged_bound_ms`` counts
the whole windows instead: the least for a kernel that, like K1-v, stages
every window before it samples. The card's name and power limit are printed
with the table. Requires CUDA and raises without it.
"""

from __future__ import annotations

import math
import statistics
import subprocess
from typing import Callable, List, Sequence

import numpy as np
import torch

N, WIN = 512, 32
SAMPLES = (40, 160, 320)
CHANNELS = (3, 1)
TILES = (1, 2, 4, 8)
THREADS = (64, 128, 256)
HBM_BYTES_PER_S = 3.35e12     # published peak of one H100 SXM
F32_FLOPS_PER_S = 67e12       # float32 outside the tensor cores
WARMUP = 5                    # untimed calls before each timing


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_inputs(S: int, C: int = 3, seed: int = 0, n: int = N, win: int = WIN,
                dtype=torch.float32, device="cuda"):
    rng = np.random.default_rng(seed)
    windows = rng.normal(0, 1, (n, C, win, win))
    xy = rng.uniform(-2, win + 1, (n, S, 2))
    valid = rng.integers(0, 2, (n, S))
    return tuple(torch.tensor(a, dtype=dtype, device=device) for a in (windows, xy, valid))


def time_ms(fn: Callable[[], object], reps: int = 60, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    in milliseconds, measured with CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def device_ms(calls: Sequence[Callable[[], object]], reps: int = 20,
              inner: int = 50) -> float:
    """Median over ``reps`` replays of a CUDA graph of ``inner`` calls, call i
    being ``calls[i % len(calls)]``, per call, in milliseconds: the device's
    time without the host's launch cost. The outputs of a replay stay
    allocated, so each call writes a buffer of its own. A call recorded
    during the capture launches nothing; a replay launches ``inner``
    times."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(WARMUP):
            calls[i % len(calls)]()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    outs = []
    with torch.cuda.graph(graph):
        for i in range(inner):
            outs.append(calls[i % len(calls)]())
    graph.replay()
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


def needed_window_elements(windows: torch.Tensor, local_xy: torch.Tensor,
                           valid: torch.Tensor) -> int:
    """Window elements the function has to read for these inputs: per
    keypoint the distinct pixels under a tap of non-zero hat weight of a
    sample whose mask is not 0 (a NaN coordinate needs none), times the
    channels."""
    n, c, win_h, win_w = windows.shape
    x, y = local_xy[..., 0], local_xy[..., 1]
    touched = torch.zeros((n, win_h * win_w), dtype=torch.bool, device=windows.device)
    rows = torch.arange(n, device=windows.device)[:, None].expand_as(x)
    for dy in (0, 1):
        for dx in (0, 1):
            tx, ty = torch.floor(x) + dx, torch.floor(y) + dy
            need = ((valid != 0) & (tx >= 0) & (tx <= win_w - 1) & (ty >= 0)
                    & (ty <= win_h - 1) & ((x - tx).abs() < 1) & ((y - ty).abs() < 1))
            touched[rows[need], (ty[need] * win_w + tx[need]).long()] = True
    return int(touched.sum()) * c


def bound_ms(windows: torch.Tensor, local_xy: torch.Tensor, valid: torch.Tensor,
             staged: bool = False):
    """(least milliseconds the card could take, "bytes" or "operations").
    Bytes: the window elements these inputs need (all of them with
    ``staged``), the coordinates, the mask and the [N, C, S] output once
    each, over the memory rate. Operations: about 20 per sample for the
    taps' hat weights plus 10 per channel for the 2x2 combination, over the
    float32 rate."""
    n, c = windows.shape[:2]
    s = local_xy.shape[1]
    read = windows.numel() if staged else needed_window_elements(windows, local_xy, valid)
    moved = (read + local_xy.numel() + valid.numel() + n * c * s) * windows.element_size()
    flops = n * s * (20 + 10 * c)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cold_sets(windows: torch.Tensor, local_xy: torch.Tensor, valid: torch.Tensor) -> int:
    """How many input sets of this shape hold twice the L2 cache's size, so
    that a walk through them finds none of them cached."""
    l2 = getattr(torch.cuda.get_device_properties(windows.device), "L2_cache_size",
                 50 * 2 ** 20)
    per_set = sum(t.numel() * t.element_size() for t in (windows, local_xy, valid))
    return math.ceil(2 * l2 / per_set)


def grid_sample_reference(windows, local_xy, valid):
    """The same function through one library call."""
    win_h, win_w = windows.shape[-2:]
    grid = torch.stack([local_xy[..., 0] * (2.0 / (win_w - 1)) - 1.0,
                        local_xy[..., 1] * (2.0 / (win_h - 1)) - 1.0], dim=-1)[:, None]
    out = torch.nn.functional.grid_sample(
        windows, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out[:, :, 0] * valid[:, None, :]


def variants():
    """(name, tile or None, threads, callable(windows, xy, valid)) of every
    kernel row of the sweep."""
    from ..ops import cuda_sampling as cs

    rows = [(f"K1 threads={th}", None, th,
             lambda w, xy, v, th=th: cs.window_bilinear_cuda(w, xy, v, threads=th))
            for th in THREADS]
    rows += [(f"K1-v tile={tile} threads={th}", tile, th,
              lambda w, xy, v, tile=tile, th=th: cs.window_bilinear_tiled_cuda(
                  w, xy, v, tile, th))
             for tile in TILES for th in THREADS]
    return rows


def run_sweep(samples=SAMPLES, channels=CHANNELS, reps: int = 60, inner: int = 20,
              out=print) -> List[dict]:
    """Run the sweep and print the table through ``out``; returns one dict
    per row: S, C, name, tile, threads, max_abs_err, ms, device_ms,
    device_cold_ms, bound_ms, bound_by, staged_bound_ms, card, launches (the
    wrappers' count while the row was timed: warm-up and timed calls, not
    the call compared with the plain version, not the calls recorded into a
    graph) and replayed_launches (the launches the graphs' replays made,
    which no wrapper sees)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel variant sweep needs a CUDA device")
    from ..ops import cuda_sampling as cs
    from ..ops.window_sampling import window_bilinear_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    g_reps = 20   # replays timed per graph, after one untimed
    out(f"card: {card}; N={N}, win={WIN}, float32; a call = median of {reps} x "
        f"{inner} calls, CUDA events; device = CUDA graph replays, inputs in L2 "
        f"(warm) or walked through sets of twice the L2's size (cold)")
    fns = variants() + [("plain", None, None, window_bilinear_plain),
                        ("grid_sample", None, None, grid_sample_reference)]
    rows = []
    for S in samples:
        for C in channels:
            first = make_inputs(S, C)
            sets = [first] + [make_inputs(S, C, seed=i)
                              for i in range(1, cold_sets(*first))]
            g_inner = len(sets) * math.ceil(50 / len(sets))
            ref = window_bilinear_plain(*first)
            b_ms, b_by = bound_ms(*first)
            staged_ms, _ = bound_ms(*first, staged=True)
            out(f"--- S={S} C={C}: bound {1e3 * b_ms:.2f} us ({b_by}; "
                f"{needed_window_elements(*first)} of {first[0].numel()} window "
                f"elements needed), staging every window {1e3 * staged_ms:.2f} us; "
                f"{len(sets)} input sets, graphs of {g_inner} calls ---")
            for name, tile, threads, f in fns:
                err = float((f(*first) - ref).abs().max())
                before = cs.LAUNCHES + cs.LAUNCHES_TILED
                ms = time_ms(lambda: f(*first), reps, inner)
                warm = device_ms([lambda: f(*first)], g_reps, g_inner)
                cold = device_ms([lambda s_=s_: f(*s_) for s_ in sets], g_reps, g_inner)
                is_kernel = threads is not None
                rows.append(dict(
                    S=S, C=C, name=name, tile=tile, threads=threads, max_abs_err=err,
                    ms=ms, device_ms=warm, device_cold_ms=cold, bound_ms=b_ms,
                    bound_by=b_by, staged_bound_ms=staged_ms, card=card,
                    launches=cs.LAUNCHES + cs.LAUNCHES_TILED - before,
                    replayed_launches=2 * (g_reps + 1) * g_inner if is_kernel else 0))
                out(f"{name:28s} {1e3 * ms:8.2f} us a call, on the device "
                    f"{1e3 * warm:7.2f} us warm, {1e3 * cold:7.2f} us cold (bound share "
                    f"{100 * b_ms / cold:5.1f} %)   max_abs_diff={err:.2e}")
    return rows


if __name__ == "__main__":
    run_sweep()
