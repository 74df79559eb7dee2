"""Long-sequence loop-closure benchmark through the port's command line.

The port's counterpart of the repository's ``bench_loop.py``, with the same
sequence recipe, configs and summary JSON: ``cli synth --trajectory loop
--texture random`` writes a closed-loop blurred sequence (the camera leaves
the start, circles and returns), and ``cli track`` tracks it twice,
tracker-only and ``--backend ba+pg``, reporting the full-trajectory and the
final-quarter ATE of both. Drift accumulates from per-keyframe chaining,
8-bit quantisation and pixel noise; the pose graph's PnP loop edges must
cut the final-quarter error when the camera comes back.

Besides, each run reports its wall time, frames/s, keyframe count,
loop-edge count, K1's, K2's and K3's launches, and (``cli track
--backend-stats``) the backend's milliseconds per keyframe by stage, each
stage ended by a device synchronisation, its BA and pose-graph iterations
and its device-to-host reads per keyframe. Stage timing adds a synchronisation per stage to the
``ba+pg`` run's wall time.

    python3 -m mba_vo_tpu_torch.experiments.loop_bench [--device cuda]
        [--num-frames 60 --height 240 --width 320 --noise 1.5]
        [--keep DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

TRACKER_CONFIG = {
    "num_pyramid_levels": 2,
    "num_virtual_poses": [5, 5],
    "huber_a": 10.0,
    "min_abs_cost_decrease": 1e-6,
    # aggressive keyframing: drift accumulates per switch, giving the loop
    # closure something real to correct
    "keyframe_max_flow_mag0": 1.5,
    "keyframe_max_flow_mag1": 3.0,
    "keyframe_max_blur_kernel_mag": 1e9,
    "max_sane_flow": 200.0,
    "detector": {"score_threshold": 5.0, "cell_h": 12, "cell_w": 12,
                 "max_keypoints": 256},
    "dtype": "float64",
}

# denser backend corners than the VGA-tuned default (grid cells scale with
# resolution), so the loop detector has real match support
BACKEND_CONFIG = {
    "detector": {"score_threshold": 1.0, "cell_h": 12, "cell_w": 12,
                 "max_keypoints": 512},
}


def _ate(est_path, gt_path, tail_frac=None):
    from ..data import datasets as ds

    _, est_t, _ = ds.load_tum_trajectory(est_path)
    _, ref_t, _ = ds.load_tum_trajectory(gt_path)
    n = min(len(est_t), len(ref_t))
    err = np.linalg.norm(est_t[:n] - ref_t[:n], axis=1)
    if tail_frac is not None:
        err = err[int(n * (1 - tail_frac)):]
    return float(np.sqrt(np.mean(err ** 2)))


def _backend_summary(stats) -> dict:
    """Per-keyframe means of the backend's stage times, iterations and
    host reads (profile=True runs)."""
    from ..backend.vo_backend import STAGES

    n = max(len(stats), 1)
    ms = {s: sum(st.get("ms", {}).get(s, 0.0) for st in stats) / n for s in STAGES}
    return dict(
        keyframes=len(stats),
        ms_per_keyframe=ms,
        ms_per_keyframe_total=sum(ms.values()),
        ba_iterations=sum(st["ba_iterations"] for st in stats),
        ba_iterations_per_keyframe=sum(st["ba_iterations"] for st in stats) / n,
        pg_iterations_per_keyframe=sum(st["pg_iterations"] for st in stats) / n,
        pose_graph_runs=sum(1 for st in stats if st["pg_iterations"] > 0),
        loop_edges=sum(st["loop_edges"] for st in stats),
        host_reads_per_keyframe=sum(st["syncs"] for st in stats) / n,
    )


def run(num_frames=60, height=240, width=320, noise=1.5, device="cuda", keep=None,
        quiet=True) -> dict:
    """Synthesise the loop sequence and track it tracker-only and with
    ``--backend ba+pg``; returns the summary dict."""
    import torch

    from .. import cli
    from ..ops import cuda_ba
    from ..ops import cuda_residual as cr
    from ..ops import cuda_sampling as cs

    root = keep or tempfile.mkdtemp(prefix="loopbench_")
    os.makedirs(root, exist_ok=True)
    seq = os.path.join(root, "seq")
    sink = io.StringIO() if quiet else sys.stdout

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sink):
        rc = cli.main([
            "synth", "--output", seq, "--num-frames", str(num_frames),
            "--height", str(height), "--width", str(width), "--num-samples", "7",
            "--trajectory", "loop", "--texture", "random", "--noise", str(noise),
            "--device", str(device),
        ])
    assert rc == 0
    synth_s = time.perf_counter() - t0
    with open(os.path.join(seq, "config.json"), "w") as f:
        json.dump(TRACKER_CONFIG, f)
    with open(os.path.join(seq, "backend.json"), "w") as f:
        json.dump(BACKEND_CONFIG, f)
    intr = open(os.path.join(seq, "intrinsics.txt")).read().strip()
    gt = os.path.join(seq, "groundtruth.txt")

    runs = {}
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    for name, extra in (
        ("tracker_only", []),
        ("ba_pg", ["--backend", "ba+pg",
                   "--backend-config", os.path.join(seq, "backend.json"),
                   "--backend-stats", os.path.join(root, "backend_stats.json")]),
    ):
        out_file = os.path.join(root, f"est_{name}.txt")
        cs.LAUNCHES = 0
        cr.zero_launch_counts()
        cuda_ba.zero_launch_counts()
        sync()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sink):
            rc = cli.main([
                "track", "--images", os.path.join(seq, "images"),
                "--sharp-images", os.path.join(seq, "sharp"),
                "--depths", os.path.join(seq, "depths"), "--dataset-type", "eth3d",
                "--times", os.path.join(seq, "times.txt"), "--intrinsics", intr,
                "--output", out_file, "--chunk", "1",
                "--config", os.path.join(seq, "config.json"),
                "--device", str(device), *extra,
            ])
        sync()
        wall = time.perf_counter() - t0
        assert rc == 0
        frames = num_frames + 1
        runs[name] = {
            "ate_full_m": round(_ate(out_file, gt), 6),
            "ate_final_quarter_m": round(_ate(out_file, gt, tail_frac=0.25), 6),
            "wall_s": wall,
            "frames_per_s": frames / wall,
            "k1_launches": cs.LAUNCHES,
            "k2_k3_launches": cr.launch_counts(),
            "k10_k12_launches": cuda_ba.launch_counts(),
            "k10_k12_ticket_launches": cuda_ba.earlier_launch_counts(),
        }
        if name == "ba_pg":
            with open(os.path.join(root, "backend_stats.json")) as f:
                runs[name]["backend"] = _backend_summary(json.load(f))
        print(json.dumps({name: runs[name]}), flush=True)

    imp = 1.0 - (runs["ba_pg"]["ate_final_quarter_m"]
                 / max(runs["tracker_only"]["ate_final_quarter_m"], 1e-12))
    summary = {
        "metric": "loop_closure_final_segment_ate",
        "num_frames": num_frames,
        "image": [height, width],
        "noise_sigma": noise,
        "runs": runs,
        "final_segment_improvement_frac": round(imp, 3),
        "device": str(device),
        "synth_s": synth_s,
    }
    if not keep:
        shutil.rmtree(root, ignore_errors=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=None)
    p.add_argument("--num-frames", type=int, default=60)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--noise", type=float, default=1.5)
    p.add_argument("--device", default="cuda")
    p.add_argument("--keep", default=None,
                   help="keep the sequence and trajectories in this directory")
    args = p.parse_args(argv)
    summary = run(args.num_frames, args.height, args.width, args.noise, args.device,
                  args.keep)
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
