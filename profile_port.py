"""Profile of the PyTorch port's main path on one NVIDIA GPU.

Run from the root of the repository:

    python3 profile_port.py [--frames 4] [--warmup 8] [--out FILE]
    python3 profile_port.py --joint [--chunk 4] [--out FILE]

Tracks chip_smoke.py's bench scenario (VGA, 512 keypoints, 3 levels, 5
virtual poses, f32, bench.py's options, from rest): ``--warmup`` frames
unprofiled and timed on the wall clock, then ``--frames`` frames under
``torch.profiler``. Prints per frame: wall ms (unprofiled), LM iterations
per level, kernel launches (``cudaLaunchKernel`` and ``cuLaunchKernel``
calls, also per LM evaluation), the most frequent aten ops, device time (sum of the kernels' self
CUDA time) and the device's busy share (device time over unprofiled wall
time). ``--out`` also writes the profiler's table there.

``--joint`` profiles the joint multi-frame path instead: after the keyframe,
``track_frames_joint`` tracks one chunk to warm up, one chunk unprofiled
(timed on the wall clock) and the next chunk under the profiler, from a
window that already moves
(chip_smoke.py's ``moving_window``), and the same numbers are printed per
chunk and per LM evaluation (one K1 launch each).
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np

from chip_smoke import (
    DEG, DEPTH, EXPOSURE, KVEC, bench_config, make_scenario, moving_window,
)
from mba_vo_tpu_torch.experiments.kernel_variants import card_line


def _self_device_us(a) -> float:
    # the field's name before and after torch 2.4
    v = getattr(a, "self_device_time_total", None)
    return v if v is not None else a.self_cuda_time_total


def _launches(avgs) -> int:
    return sum(a.count for a in avgs
               if a.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))


def _device_us(avgs) -> float:
    import torch

    return sum(_self_device_us(a) for a in avgs
               if a.device_type == torch.autograd.DeviceType.CUDA)


def _write_tables(avgs, path) -> None:
    with open(path, "w") as f:
        key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
               else "self_cuda_time_total")
        f.write(avgs.table(sort_by=key, row_limit=40))
        f.write("\n")
        f.write(avgs.table(sort_by="count", row_limit=40))


def profile_joint(args) -> int:
    """One joint chunk to warm up (the first solve initialises the dense
    solver's library), one timed unprofiled, the next under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.ops import cuda_sampling as cs
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    c = args.chunk
    img, traj, frames = make_scenario("cuda", 3 * c)
    h, w = img.shape
    tracker = BlurAwareTracker(bench_config("float32"), KVEC, (h, w), device="cuda")
    tracker.track_frame(img, img, 0.0, EXPOSURE, np.full((h, w), DEPTH))
    interop.install_tracker_state(tracker, moving_window(traj, frames, c, DEG))

    def track(part):
        tracker.track_frames_joint([b for _, b in part], [t for t, _ in part],
                                   [EXPOSURE] * len(part), chunk=c, inflight=1)
        torch.cuda.synchronize()

    track(frames[:c])
    k0, t0 = cs.LAUNCHES, time.perf_counter()
    track(frames[c:2 * c])
    wall_ms, evals_warm = 1e3 * (time.perf_counter() - t0), cs.LAUNCHES - k0
    k0 = cs.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        track(frames[2 * c:])
    evals = cs.LAUNCHES - k0
    avgs = prof.key_averages()
    launch, dev_ms = _launches(avgs), _device_us(avgs) / 1e3
    print(f"joint window, f32, chunk {c}, degree {DEG}: second chunk unprofiled "
          f"{wall_ms:.1f} ms over {evals_warm} LM evaluations = "
          f"{wall_ms / max(evals_warm, 1):.2f} ms per evaluation")
    print(f"profiled chunk: {evals} LM evaluations (K1 launches at S = "
          f"{c * 40}), {launch} kernel launches = {launch / max(evals, 1):.0f} per "
          f"evaluation; device time {dev_ms:.3f} ms = {dev_ms / max(evals, 1):.3f} ms per "
          f"evaluation; busy share at the unprofiled cost per evaluation: "
          f"{100 * (dev_ms / max(evals, 1)) / (wall_ms / max(evals_warm, 1)):.1f} %")
    if dev_ms == 0:
        print("the profiler recorded no device time")
    if args.out:
        _write_tables(avgs, args.out)
    return 0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mba_vo_tpu_torch.ops import cuda_sampling as cs
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--joint", action="store_true",
                    help="profile track_frames_joint instead of track_frame")
    ap.add_argument("--chunk", type=int, default=4, help="frames per joint chunk")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("profile_port: needs one CUDA GPU", file=sys.stderr)
        return 1
    print(card_line())
    cs.build()
    if args.joint:
        return profile_joint(args)
    n = args.warmup + args.frames
    img, _traj, frames = make_scenario("cuda", n)
    h, w = img.shape
    tracker = BlurAwareTracker(bench_config("float32"), KVEC, (h, w), device="cuda")
    tracker.track_frame(img, img, 0.0, EXPOSURE, np.full((h, w), DEPTH))
    torch.cuda.synchronize()

    wall, iters = [], []
    for cap, blur in frames[:args.warmup]:
        t0 = time.perf_counter()
        tracker.track_frame(None, blur, cap, EXPOSURE)
        torch.cuda.synchronize()
        wall.append(time.perf_counter() - t0)
        iters.append([s.num_iterations for _, s in tracker.last_summaries])

    launches0 = cs.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for cap, blur in frames[args.warmup:]:
            tracker.track_frame(None, blur, cap, EXPOSURE)
            iters.append([s.num_iterations for _, s in tracker.last_summaries])
        torch.cuda.synchronize()
    k1 = (cs.LAUNCHES - launches0) / args.frames

    avgs = prof.key_averages()
    nf = args.frames
    launch = _launches(avgs)
    device_us = _device_us(avgs)
    aten = sorted((a for a in avgs if a.key.startswith("aten::")),
                  key=lambda a: -a.count)[:8]
    ms_frame = 1e3 * statistics.median(wall[1:] if len(wall) > 1 else wall)
    dev_ms = device_us / 1e3 / nf
    print(f"wall ms/frame, unprofiled (median of frames 2..{args.warmup}): "
          f"{ms_frame:.2f}; all: {[round(1e3 * s, 2) for s in wall]}")
    print(f"LM iterations per level (coarse to fine) per frame: {iters}")
    print(f"kernel launches per frame: {launch / nf:.1f}; K1 launches per "
          f"frame (one per LM evaluation, S = 40): {k1:.1f}; kernel launches per LM "
          f"evaluation: {launch / nf / max(k1, 1):.0f}")
    print("most frequent aten ops per frame: " + ", ".join(
        f"{a.key} {a.count / nf:.0f}" for a in aten))
    print(f"device time per frame: {dev_ms:.3f} ms; busy share of the "
          f"unprofiled wall time: {100 * dev_ms / ms_frame:.1f} %")
    if device_us == 0:
        print("the profiler recorded no device time")
    if args.out:
        _write_tables(avgs, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
