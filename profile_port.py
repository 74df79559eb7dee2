"""Profile of the PyTorch port's main path on one NVIDIA GPU.

Run from the root of the repository:

    python3 profile_port.py [--frames 4] [--warmup 8] [--out FILE]

Tracks chip_smoke.py's bench scenario (VGA, 512 keypoints, 3 levels, 5
virtual poses, f32, bench.py's options, from rest): ``--warmup`` frames
unprofiled and timed on the wall clock, then ``--frames`` frames under
``torch.profiler``. Prints per frame: wall ms (unprofiled), LM iterations
per level, kernel launches (``cudaLaunchKernel`` and ``cuLaunchKernel``
calls), the most frequent aten ops, device time (sum of the kernels' self
CUDA time) and the device's busy share (device time over unprofiled wall
time). ``--out`` also writes the profiler's table there.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time

import numpy as np

from chip_smoke import DEPTH, EXPOSURE, KVEC, bench_config, card_line, make_scenario


def _self_device_us(a) -> float:
    # the field's name before and after torch 2.4
    v = getattr(a, "self_device_time_total", None)
    return v if v is not None else a.self_cuda_time_total


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mba_vo_tpu_torch.ops import cuda_sampling as cs
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("profile_port: needs one CUDA GPU", file=sys.stderr)
        return 1
    print(card_line())
    cs.build()
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
    launch = sum(a.count for a in avgs
                 if a.key in ("cudaLaunchKernel", "cuLaunchKernel",
                              "cudaLaunchKernelExC"))
    device_us = sum(_self_device_us(a) for a in avgs
                    if a.device_type == torch.autograd.DeviceType.CUDA)
    aten = sorted((a for a in avgs if a.key.startswith("aten::")),
                  key=lambda a: -a.count)[:8]
    ms_frame = 1e3 * statistics.median(wall[1:] if len(wall) > 1 else wall)
    dev_ms = device_us / 1e3 / nf
    print(f"wall ms/frame, unprofiled (median of frames 2..{args.warmup}): "
          f"{ms_frame:.2f}; all: {[round(1e3 * s, 2) for s in wall]}")
    print(f"LM iterations per level (coarse to fine) per frame: {iters}")
    print(f"kernel launches per frame: {launch / nf:.1f}; K1 launches per "
          f"frame: {k1:.1f}")
    print("most frequent aten ops per frame: " + ", ".join(
        f"{a.key} {a.count / nf:.0f}" for a in aten))
    print(f"device time per frame: {dev_ms:.3f} ms; busy share of the "
          f"unprofiled wall time: {100 * dev_ms / ms_frame:.1f} %")
    if device_us == 0:
        print("the profiler recorded no device time")
    if args.out:
        with open(args.out, "w") as f:
            key = ("self_device_time_total" if hasattr(avgs[0], "self_device_time_total")
                   else "self_cuda_time_total")
            f.write(avgs.table(sort_by=key, row_limit=40))
            f.write("\n")
            f.write(avgs.table(sort_by="count", row_limit=40))
    return 0


if __name__ == "__main__":
    sys.exit(main())
