"""Sampler kernel sweep on one NVIDIA GPU.

Counterpart of ``experiments/kernel_variants_r04.py::main``, which timed the
TPU sampler and its fixed-tile variant ``run_v0_tile``. Run from the root of
the repository on a machine with the card:

    python3 -m mba_vo_tpu_torch.experiments.kernel_variants [--tracker]

Synthetic rows (``run_sweep``). Inputs follow that sweep's recipe
(``make_inputs``: standard-normal windows, coordinates uniform in
[-2, win + 1], a 0/1 mask, seed 0) at N = 512 keypoints, 32x32 windows,
float32, for S in {40, 160, 320} samples per keypoint (one frame of 8 patch
pixels x 5 virtual poses, a joint chunk of 4 frames, one of 8) and C in
{3, 1} channels. Rows per shape:

  * K1 as the tracker runs it (``window_bilinear_cuda``) at 64, 128 and 256
    threads per block, and K1's band design
    (``window_bilinear_band_cuda``, "K1 band");
  * K1-v (``window_bilinear_tiled_cuda``) at every (tile, threads) of
    TILES x THREADS, and its first design at its best variant of the
    earlier sweeps (``window_bilinear_staged_cuda``, "K1-v staged");
  * the plain PyTorch version (``window_bilinear_plain``);
  * ``torch.nn.functional.grid_sample`` (bilinear, zero padding,
    ``align_corners=True``) times the mask: the one library call that
    computes the same function. It is a yardstick here and the port calls it
    nowhere else.

Tracker rows (``--tracker``, and ``chip_smoke.py`` phase 7). The inputs are
the sampler calls the tracker itself makes, recorded by
:func:`record_sampler_calls` on ``chip_smoke.py``'s bench scenario in
float32: "tracker S=40", 16 frames of ``track_frame`` from rest, and
"tracker S=160", one chunk of ``track_frames_joint(chunk=4)`` from a window
that already moves; the C = 3 calls of each. There the sweep keeps the two
designs of K1 and of K1-v (K1 at 128 threads, K1-v at the synthetic sweep's
best and worst variant), plain and ``grid_sample``, and prints the histogram of the rows
the taps read (:func:`tap_row_histogram`), from which K1's band heights
``ops.cuda_sampling.BAND_ROWS`` and ``TOP_ROWS`` are chosen. The floor row times each design
at N = 1, S = 1, C = 3: the least time one launch of a sampler takes.

Each row has max |out - plain|, three times per call and the least time the
card could take. ``ms`` is the median over ``reps`` of the mean of ``inner``
back-to-back calls between two CUDA events: what a caller in Python waits,
which for kernels this small is the host's cost of a launch. ``device_ms``
(warm) is the device's time per call in a replayed CUDA graph whose calls
read inputs that stay in the L2 cache: the same inputs every call on
synthetic rows, the recorded calls in the tracker's order on tracker rows
(their windows shared within a pyramid level, as in the tracker).
``device_cold_ms`` is a graph whose calls walk through input sets, each call
writing an output buffer of its own, until the bytes the sets need
(:func:`needed_bytes`: the 32-byte sectors of the window elements under a
tap, and the coordinates and mask) hold twice the L2: every kernel reads at
least those, so each call finds its inputs in device memory only. Synthetic
sets come from seeds 0, 1, ...; tracker sets are the recorded calls in
order, each with a copy of its windows of its own. The floor row's cold time
instead subtracts a graph of L2 flushes from a graph of (flush, call) pairs
(:func:`device_flushed_ms`): a set of one thread's inputs would need ~10^5
calls to hold the L2.

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

import argparse
import contextlib
import dataclasses
import inspect
import math
import statistics
import subprocess
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

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
SECTOR = 32                   # bytes the L2 moves to and from device memory at once
BANDS = tuple(range(2, 17, 2))  # centre band heights whose coverage the histogram prints
TOPS = (0, 2, 4, 6)             # top band heights likewise


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


def l2_bytes(device="cuda") -> int:
    return getattr(torch.cuda.get_device_properties(device), "L2_cache_size", 50 * 2 ** 20)


def device_flushed_ms(call: Callable[[], object], reps: int = 60, inner: int = 50) -> float:
    """Device time of ``call`` with its inputs out of the L2: a graph of
    ``inner`` (flush, call) pairs less a graph of ``inner`` flushes, per
    call. A flush writes a buffer of twice the L2's size."""
    flush = torch.empty(2 * l2_bytes() // 4, dtype=torch.float32, device="cuda")
    both = device_ms([lambda: (flush.zero_(), call())], reps, inner)
    alone = device_ms([flush.zero_], reps, inner)
    return both - alone


def _touched(windows: torch.Tensor, local_xy: torch.Tensor,
             valid: torch.Tensor) -> torch.Tensor:
    """[N, win_h * win_w] bool: per keypoint the pixels under a tap of
    non-zero hat weight of a sample whose mask is not 0 (a NaN coordinate
    touches none)."""
    n, _, win_h, win_w = windows.shape
    x, y = local_xy[..., 0], local_xy[..., 1]
    touched = torch.zeros((n, win_h * win_w), dtype=torch.bool, device=windows.device)
    rows = torch.arange(n, device=windows.device)[:, None].expand_as(x)
    for dy in (0, 1):
        for dx in (0, 1):
            tx, ty = torch.floor(x) + dx, torch.floor(y) + dy
            need = ((valid != 0) & (tx >= 0) & (tx <= win_w - 1) & (ty >= 0)
                    & (ty <= win_h - 1) & ((x - tx).abs() < 1) & ((y - ty).abs() < 1))
            touched[rows[need], (ty[need] * win_w + tx[need]).long()] = True
    return touched


def needed_window_elements(windows: torch.Tensor, local_xy: torch.Tensor,
                           valid: torch.Tensor) -> int:
    """Window elements the function has to read for these inputs: per
    keypoint the distinct pixels under a tap of non-zero hat weight of a
    sample whose mask is not 0 (a NaN coordinate needs none), times the
    channels."""
    return int(_touched(windows, local_xy, valid).sum()) * windows.shape[1]


def needed_bytes(windows: torch.Tensor, local_xy: torch.Tensor, valid: torch.Tensor) -> int:
    """Bytes of device memory a call of the function brings into the L2 at
    the least: the 32-byte sectors holding the window elements it needs
    (windows laid out contiguously, every channel), the coordinates and the
    mask. Every kernel reads at least these, so a walk through input sets
    whose needed bytes hold twice the L2 finds each set in device memory."""
    n, c, win_h, win_w = windows.shape
    plane, item = win_h * win_w, windows.element_size()
    kp, px = _touched(windows, local_xy, valid).nonzero(as_tuple=True)
    first = kp * (c * plane) + px
    elems = (first[None] + plane * torch.arange(c, device=first.device)[:, None]).flatten()
    sectors = torch.unique(elems * item // SECTOR).numel()
    return sectors * SECTOR + (local_xy.numel() + valid.numel()) * item


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
    """How many input sets like this one hold twice the L2 cache's size in
    the bytes they need, so that a walk through them finds none cached."""
    return math.ceil(2 * l2_bytes(windows.device) / needed_bytes(windows, local_xy, valid))


def max_abs_diff(out: torch.Tensor, ref: torch.Tensor) -> float:
    """max |out - ref| over the entries where neither is NaN; infinite where
    the NaN positions differ."""
    nan = torch.isnan(ref)
    if not torch.equal(torch.isnan(out), nan):
        return math.inf
    return float((out - ref).abs()[~nan].max()) if (~nan).any() else 0.0


def grid_sample_reference(windows, local_xy, valid):
    """The same function through one library call."""
    win_h, win_w = windows.shape[-2:]
    grid = torch.stack([local_xy[..., 0] * (2.0 / (win_w - 1)) - 1.0,
                        local_xy[..., 1] * (2.0 / (win_h - 1)) - 1.0], dim=-1)[:, None]
    out = torch.nn.functional.grid_sample(
        windows, grid, mode="bilinear", padding_mode="zeros", align_corners=True)
    return out[:, :, 0] * valid[:, None, :]


@dataclasses.dataclass(frozen=True)
class Row:
    """One row of the sweep: ``kind`` is "K1", "K1 band", "K1-v" or "K1-v
    staged" for a kernel (``threads`` set), "plain" or "grid_sample" for a
    yardstick; ``fn(windows, xy, valid)`` computes it."""
    name: str
    kind: str
    tile: Optional[int]
    threads: Optional[int]
    fn: Callable


def variants() -> List[Row]:
    """Every kernel row of the synthetic sweep."""
    from ..ops import cuda_sampling as cs

    rows = [Row(f"K1 threads={th}", "K1", None, th,
                lambda w, xy, v, th=th: cs.window_bilinear_cuda(w, xy, v, threads=th))
            for th in THREADS]
    rows.append(Row("K1 band threads=128", "K1 band", None, 128,
                    lambda w, xy, v: cs.window_bilinear_band_cuda(w, xy, v, threads=128)))
    rows += [Row(f"K1-v tile={tile} threads={th}", "K1-v", tile, th,
                 lambda w, xy, v, tile=tile, th=th: cs.window_bilinear_tiled_cuda(
                     w, xy, v, tile, th))
             for tile in TILES for th in THREADS]
    # the staged design takes contiguous windows only (the C = 3 cache is)
    rows.append(Row("K1-v staged tile=1 threads=256", "K1-v staged", 1, 256,
                    lambda w, xy, v: cs.window_bilinear_staged_cuda(
                        w.contiguous(), xy, v, 1, 256)))
    return rows


def total_launches() -> int:
    """Launches of every sampler wrapper so far."""
    from ..ops import cuda_sampling as cs

    return cs.LAUNCHES + cs.LAUNCHES_BAND + cs.LAUNCHES_TILED + cs.LAUNCHES_STAGED


def _require_cuda():
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel variant sweep needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _with_yardsticks(rows: Sequence[Row]) -> List[Row]:
    from ..ops.window_sampling import window_bilinear_plain

    return list(rows) + [Row("plain", "plain", None, None, window_bilinear_plain),
                         Row("grid_sample", "grid_sample", None, None, grid_sample_reference)]


def _time_row(row: Row, first, warm_calls, sets, ref_err, reps, inner, **fields) -> dict:
    """Time one row: a call on ``first``, warm over ``warm_calls`` (argument
    tuples), cold over ``sets``; returns the sweep's dict of it."""
    g_reps = 20   # replays timed per graph, after one untimed
    w_inner = len(warm_calls) * math.ceil(50 / len(warm_calls))
    g_inner = len(sets) * math.ceil(50 / len(sets))
    f = row.fn
    before = total_launches()
    ms = time_ms(lambda: f(*first), reps, inner)
    warm = device_ms([lambda a=a: f(*a) for a in warm_calls], g_reps, w_inner)
    cold = device_ms([lambda s=s: f(*s) for s in sets], g_reps, g_inner)
    is_kernel = row.threads is not None
    return dict(
        name=row.name, kind=row.kind, tile=row.tile, threads=row.threads,
        max_abs_err=ref_err, ms=ms, device_ms=warm, device_cold_ms=cold,
        launches=total_launches() - before,
        replayed_launches=(g_reps + 1) * (w_inner + g_inner) if is_kernel else 0, **fields)


def _print_row(out, r: dict):
    out(f"{r['name']:32s} {1e3 * r['ms']:8.2f} us a call, on the device "
        f"{1e3 * r['device_ms']:7.2f} us warm, {1e3 * r['device_cold_ms']:7.2f} us cold "
        f"(bound share {100 * r['bound_ms'] / r['device_cold_ms']:5.1f} %)   "
        f"max_abs_diff={r['max_abs_err']:.2e}")


def run_sweep(samples=SAMPLES, channels=CHANNELS, reps: int = 60, inner: int = 20,
              out=print) -> List[dict]:
    """Run the synthetic sweep and print the table through ``out``; returns
    one dict per row: S, C, name, kind, tile, threads, max_abs_err, ms,
    device_ms, device_cold_ms, bound_ms, bound_by, staged_bound_ms, card,
    launches (the wrappers' count while the row was timed: warm-up and timed
    calls, not the call compared with the plain version, not the calls
    recorded into a graph) and replayed_launches (the launches the graphs'
    replays made, which no wrapper sees)."""
    _require_cuda()
    card = card_line()
    out(f"card: {card}; N={N}, win={WIN}, float32; a call = median of {reps} x "
        f"{inner} calls, CUDA events; device = CUDA graph replays, inputs in L2 "
        f"(warm) or walked through sets needing twice the L2's size (cold)")
    from ..ops.window_sampling import window_bilinear_plain

    rows = []
    for S in samples:
        for C in channels:
            first = make_inputs(S, C)
            sets = [first] + [make_inputs(S, C, seed=i) for i in range(1, cold_sets(*first))]
            ref = window_bilinear_plain(*first)
            b_ms, b_by = bound_ms(*first)
            staged_ms, _ = bound_ms(*first, staged=True)
            out(f"--- S={S} C={C}: bound {1e3 * b_ms:.2f} us ({b_by}; "
                f"{needed_window_elements(*first)} of {first[0].numel()} window "
                f"elements needed), staging every window {1e3 * staged_ms:.2f} us; "
                f"{len(sets)} input sets for the cold walk ---")
            for row in _with_yardsticks(variants()):
                r = _time_row(row, first, [first], sets, max_abs_diff(row.fn(*first), ref),
                              reps, inner, S=S, C=C,
                              bound_ms=b_ms, bound_by=b_by, staged_bound_ms=staged_ms,
                              card=card, inputs="synthetic")
                rows.append(r)
                _print_row(out, r)
    return rows


# ------------------------------------------------------ the tracker's inputs


@dataclasses.dataclass
class SamplerCall:
    """One recorded call of ``window_bilinear``: copies of its inputs (the
    windows' copy shared by every call that passed the same windows, with
    the same strides) and the pyramid level that made it (None outside
    ``_run_level``)."""
    windows: torch.Tensor
    local_xy: torch.Tensor
    valid: torch.Tensor
    level: Optional[int]

    @property
    def args(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.windows, self.local_xy, self.valid

    @property
    def C(self) -> int:
        return self.windows.shape[1]

    @property
    def S(self) -> int:
        return self.local_xy.shape[1]


def copy_layout(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with its strides: the span of storage it covers is
    copied, so a slice such as ``windows[:, :1]`` stays a strided slice."""
    span = 1 + sum((s - 1) * st for s, st in zip(t.shape, t.stride())) if t.numel() else 0
    flat = torch.as_strided(t, (span,), (1,)).clone()
    return torch.as_strided(flat, t.shape, t.stride())


def _caller_level() -> Optional[int]:
    frame = inspect.currentframe()
    while frame is not None:
        if frame.f_code.co_name == "_run_level":
            return frame.f_locals.get("lv")
        frame = frame.f_back
    return None


@contextlib.contextmanager
def record_sampler_calls() -> Iterator[List[SamplerCall]]:
    """Record every call of ``ops.window_sampling.window_bilinear`` made
    inside the block, as the list it yields; the calls still run. The
    tracker's ``sample_windows_lk`` and ``sample_windows`` look the name up
    when they are called, so nothing of the tracker changes. The recorder
    copies on the device only (it may run on CPU tensors too), and
    ``window_bilinear`` is restored on leaving the block, also on an
    exception. Record outside a CUDA graph capture."""
    from ..ops import window_sampling as ws

    calls: List[SamplerCall] = []
    kept: List[torch.Tensor] = []   # one copy of each distinct windows tensor
    original = ws.window_bilinear

    def same(a, b):
        return (a.shape == b.shape and a.stride() == b.stride() and a.dtype == b.dtype
                and a.device == b.device and torch.equal(a, b))

    def recording(windows, local_xy, valid):
        copy = next((c for c in kept if same(c, windows)), None)
        if copy is None:
            copy = copy_layout(windows)
            kept.append(copy)
        calls.append(SamplerCall(copy, local_xy.clone(), valid.clone(), _caller_level()))
        return original(windows, local_xy, valid)

    ws.window_bilinear = recording
    try:
        yield calls
    finally:
        ws.window_bilinear = original


def staged_rows(win_h: int, top: int, band: int) -> Tuple[int, int, int]:
    """(top, r0, rows): the window rows [0, top) and [r0, r0 + rows) that K1
    stages with a top band of ``top`` rows and a centre band of ``band``
    rows, as window_bilinear.cu's staged_rows computes them: the centre band
    centred on the keypoint's own two tap rows and clamped into the window,
    the two merged into one band from row 0 where they meet."""
    t, rows = min(top, win_h), min(band, win_h)
    r0 = min(max(win_h // 2 + 1 - band // 2, 0), win_h - rows)
    if r0 <= t:
        return 0, 0, max(t, r0 + rows)
    return t, r0, rows


def tap_row_histogram(calls: Sequence[SamplerCall], bands=BANDS, tops=TOPS):
    """({row offset: taps}, {(top, band): share of taps on a staged row})
    over ``calls``: the window rows the kernels read, two tap rows per
    sample whose coordinates are not NaN (a tap row outside the window reads
    row 0, as the kernels do), as offsets from the centre row win_h // 2;
    and for each top and centre band height the share of those rows that K1
    would find staged."""
    hist: Dict[int, int] = {}
    inside = {(t, b): 0 for t in tops for b in bands}
    total = 0
    for call in calls:
        win_h = call.windows.shape[2]
        x, y = call.local_xy[..., 0], call.local_xy[..., 1]
        ok = ~(torch.isnan(x) | torch.isnan(y))
        fy = torch.floor(y[ok])
        taps = torch.stack([fy, fy + 1])
        rows = torch.where((taps >= 0) & (taps <= win_h - 1), taps,
                           torch.zeros_like(taps)).long().flatten()
        total += rows.numel()
        offsets, counts = torch.unique(rows - win_h // 2, return_counts=True)
        for o, c in zip(offsets.tolist(), counts.tolist()):
            hist[o] = hist.get(o, 0) + c
        for t, b in inside:
            top, r0, n = staged_rows(win_h, t, b)
            inside[t, b] += int(((rows < top) | ((rows >= r0) & (rows < r0 + n))).sum())
    return dict(sorted(hist.items())), {k: v / max(total, 1) for k, v in inside.items()}


def _cold_walk(calls: Sequence[SamplerCall]) -> List[Tuple[torch.Tensor, ...]]:
    """Copies of the recorded calls' inputs, in order and round again, each
    with windows of its own, until the bytes they need hold twice the L2."""
    need = [needed_bytes(*c.args) for c in calls]
    sets, held = [], 0
    while held < 2 * l2_bytes():
        i = len(sets) % len(calls)
        sets.append(tuple(copy_layout(t) for t in calls[i].args))
        held += need[i]
    return sets


def tracker_rows(label: str, calls: Sequence[SamplerCall], kernels: Sequence[Row],
                 reps: int = 20, inner: int = 20, out=print) -> List[dict]:
    """Time ``kernels``, plain and ``grid_sample`` on the recorded ``calls``
    (one S, C = 3): a call on the first recorded inputs, warm over all of
    them in the tracker's order, cold over :func:`_cold_walk`; the bound is
    the mean over the calls. Returns the rows as :func:`run_sweep` does,
    with ``inputs`` = ``label`` and the band coverage of the calls."""
    _require_cuda()
    from ..ops import cuda_sampling as cs
    from ..ops.window_sampling import window_bilinear_plain

    card = card_line()
    args = [c.args for c in calls]
    S, C = calls[0].S, calls[0].C
    refs = [window_bilinear_plain(*a) for a in args]
    bounds = [bound_ms(*a) for a in args]
    b_ms = statistics.fmean(b for b, _ in bounds)
    b_by = max(("bytes", "operations"), key=[by for _, by in bounds].count)
    staged_ms = statistics.fmean(bound_ms(*a, staged=True)[0] for a in args)
    needed = statistics.fmean(needed_window_elements(*a) for a in args)
    hist, cover = tap_row_histogram(calls)
    sets = _cold_walk(calls)
    levels = sorted({c.level for c in calls}, key=lambda lv: -1 if lv is None else lv)
    out(f"--- {label}: {len(calls)} recorded calls (C={C}, S={S}, N={calls[0].windows.shape[0]}, "
        f"levels {levels}); bound {1e3 * b_ms:.3f} us ({b_by}; {needed:.0f} of "
        f"{calls[0].windows.numel()} window elements needed a call), staging every window "
        f"{1e3 * staged_ms:.2f} us; {len(sets)} calls in the cold walk ---")
    out("    tap rows from the window's centre row: " + ", ".join(
        f"{o:+d}: {c}" for o, c in hist.items()))
    for t in TOPS:
        out(f"    share of taps on a staged row, top band of {t} rows, centre band of: "
            + ", ".join(f"{b} {100 * cover[t, b]:.2f} %" for b in BANDS))
    out(f"    (K1 stages a top band of {cs.TOP_ROWS} rows and a centre band of "
        f"{cs.BAND_ROWS}: {100 * cover.get((cs.TOP_ROWS, cs.BAND_ROWS), math.nan):.2f} %)")
    rows = []
    for row in _with_yardsticks(kernels):
        err = max(max_abs_diff(row.fn(*a), ref) for a, ref in zip(args, refs))
        r = _time_row(row, args[0], args, sets, err, reps, inner, S=S, C=C,
                      bound_ms=b_ms, bound_by=b_by, staged_bound_ms=staged_ms, card=card,
                      inputs=label, calls=len(calls),
                      band_cover=cover.get((cs.TOP_ROWS, cs.BAND_ROWS)), tap_rows=hist)
        rows.append(r)
        _print_row(out, r)
    return rows


def floor_rows(kernels: Sequence[Row], out=print) -> List[dict]:
    """Each of ``kernels`` at N = 1, S = 1, C = 3 (one thread's work): warm,
    the same inputs every call; cold, :func:`device_flushed_ms`. The least
    time one launch of each design takes on this card."""
    _require_cuda()
    first = make_inputs(1, 3, n=1)
    rows = []
    for row in kernels:
        warm = device_ms([lambda: row.fn(*first)])
        cold = device_flushed_ms(lambda: row.fn(*first))
        rows.append(dict(name=row.name, kind=row.kind, device_ms=warm, device_cold_ms=cold))
        out(f"floor {row.name:32s} N=1 S=1 C=3: {1e3 * warm:6.2f} us warm, "
            f"{1e3 * cold:6.2f} us cold (flushed L2)")
    return rows


def pick_kernels(rows: Sequence[dict]) -> List[Row]:
    """The kernels the tracker rows keep: K1 and its band design at 128
    threads, K1-v at the synthetic sweep's best and worst variant (cold, at
    S = 40, C = 3) and its first design."""
    by_name = {r.name: r for r in variants()}
    ranked = sorted((r for r in rows if r["kind"] == "K1-v" and r["S"] == 40 and r["C"] == 3),
                    key=lambda r: r["device_cold_ms"])
    names = ["K1 threads=128", "K1 band threads=128", ranked[0]["name"],
             ranked[-1]["name"], "K1-v staged tile=1 threads=256"]
    return [by_name[n] for n in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tracker", action="store_true",
                    help="also record the tracker's sampler inputs on chip_smoke.py's "
                         "bench scenario and time the rows there, and the floor row "
                         "(run from the root of the repository)")
    args = ap.parse_args(argv)
    rows = run_sweep()
    if args.tracker:
        import chip_smoke

        kernels = pick_kernels(rows)
        img, traj, frames = chip_smoke.make_scenario("cuda", chip_smoke.LONG_FRAMES)
        for label, calls in chip_smoke.record_tracker_calls(img, traj, frames).items():
            tracker_rows(label, [c for c in calls if c.C == 3], kernels)
        floor_rows(kernels)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
