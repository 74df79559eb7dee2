"""Frames/s of the per-frame main paths of one checkout, for paired runs.

Tracks ``chip_smoke.py``'s bench scenario (16 VGA frames from rest, f32,
bench options) through ``track_frame`` with the windowed sampler (phase
5a) and with ``sampling="direct"`` (phase 6e), alternately, ``--reps``
times each after one warm-up of 4 frames of each, and prints one JSON line:
the checkout, the card, and each run's frames/s and median milliseconds a
frame. ``--root DIR`` runs the package and ``chip_smoke.py`` of another
checkout (e.g. the parent, unpacked by ``git archive`` into a gitignored
directory), so that two commits are compared on one card in turns
(parent, change, change, parent), each in a process of its own. Run it as
a file, not as a module, so that the package comes from ``--root``:

    python3 mba_vo_tpu_torch/experiments/paired_fps.py [--root DIR]
        [--label NAME] [--reps 3] [--device cuda] [--frames 16]

``--device cpu --frames 2 --reps 1`` rehearses it without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default="")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=16)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("paired_fps: needs one CUDA GPU (or --device cpu)", file=sys.stderr)
        return 1
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    img, _, frames = cs.make_scenario(args.device, args.frames)
    configs = {"5a windowed": cs.bench_config("float32"),
               "6e direct": cs.bench_config("float32", sampling="direct")}
    for cfg in configs.values():                   # builds, first compiles
        cs.run_tracker(cfg, args.device, img, frames[:4])
    runs = {name: [] for name in configs}
    for _ in range(args.reps):
        for name, cfg in configs.items():
            _, secs, _ = cs.run_tracker(cfg, args.device, img, frames)
            runs[name].append(dict(frames_per_s=len(frames) / sum(secs),
                                   median_ms=1e3 * statistics.median(secs)))
    card = (f"{torch.cuda.get_device_name(0)}" if args.device == "cuda" else "cpu")
    print(json.dumps(dict(label=args.label, root=root, device=card, frames=len(frames),
                          runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
