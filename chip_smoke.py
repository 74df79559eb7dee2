"""Smoke test of the PyTorch port (mba_vo_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build kernel K1 (csrc/window_bilinear.cu) with nvcc for sm_90a;
  3. K1 against its plain PyTorch version at the tracker's shapes and on
     edge cases, f32 and f64, and both timed with CUDA events;
  4. the tracker in f64 on CUDA against the same tracker on the CPU, on the
     bench scenario (VGA, 512 keypoints, 3 levels, 5 virtual poses);
  5. the main path: the tracker in f32 on CUDA under bench.py's options,
     from rest, over a longer run of the same scenario: frames/s, K1's
     launch count in that run and the ATE against the generating spline;
     the f32-vs-f64 drift rule of tests/test_precision.py with that test's
     options, measured on the bench scenario and checked on the test's own
     scenario;
then one JSON line of kernel results, the card line again, and the final
status line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

H, W, FX = 480, 640, 480.0
KVEC = np.array([FX, FX, (W - 1) / 2, (H - 1) / 2])
DEPTH, EXPOSURE, FRAME_DT, DEG = 2.0, 0.03, 0.1, 2
N_KP, WIN, S_MAIN = 512, 32, 40   # S = frames x patch x virtual poses = 1 x 8 x 5
CPU_FRAMES = 4                    # phase 4: the CPU f64 run is the slow one
LONG_FRAMES = 16                  # phase 5


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------------ phase 3


def kernel_problem(rng, n, c, win_h, win_w, s, dtype, special=False):
    import torch

    windows = rng.normal(0.0, 50.0, (n, c, win_h, win_w))
    xy = np.stack([rng.uniform(-3, win_w + 2, (n, s)),
                   rng.uniform(-3, win_h + 2, (n, s))], axis=-1)
    valid = rng.integers(0, 2, (n, s)).astype(np.float64)
    if special:
        q = s // 5
        xy[:, :q] = rng.integers(-2, max(win_h, win_w) + 2, (n, q, 2))  # integers
        xy[:, q:2 * q, 0] = -0.5                                       # half a px left
        xy[:, 2 * q:3 * q] += np.where(rng.random((n, q, 1)) < 0.5, -40.0, 40.0)  # far out
        xy[::7, 3 * q, 0] = np.nan                                     # NaN x
        xy[::11, 3 * q + 1, 1] = np.nan                                # NaN y
    dev = dict(dtype=dtype, device="cuda")
    return (torch.tensor(windows, **dev), torch.tensor(xy, **dev),
            torch.tensor(valid, **dev))


def compare(out, ref, windows, dtype, label):
    import torch

    check(out.shape == ref.shape, f"{label}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    nan_o, nan_r = torch.isnan(out), torch.isnan(ref)
    check(torch.equal(nan_o, nan_r), f"{label}: NaN positions differ")
    err = (out - ref).abs()[~nan_o].max().item() if (~nan_o).any() else 0.0
    bound = 1e-5 * windows.abs().max().item() if dtype == torch.float32 else 1e-12
    print(f"  {label}: max|kernel - plain| = {err:.3e} (bound {bound:.3e}), "
          f"NaN outputs {int(nan_o.sum())}")
    check(err <= bound, f"{label}: max abs error {err} > {bound}")
    return err


def time_ms(fn, reps=60, inner=20):
    """Median over `reps` of the mean time of `inner` back-to-back calls,
    measured with CUDA events."""
    import torch

    for _ in range(5):
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


def phase_kernel(cs):
    import torch
    from mba_vo_tpu_torch.ops.window_sampling import window_bilinear_plain

    rng = np.random.default_rng(1234)
    max_err = 0.0
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        cases = [
            (f"{name} C=1 N=512 win=32 S=40", dict(c=1, win_h=WIN, win_w=WIN), False),
            (f"{name} C=3 N=512 win=32 S=40", dict(c=3, win_h=WIN, win_w=WIN), False),
            (f"{name} C=3 rectangular 20x32", dict(c=3, win_h=20, win_w=WIN), False),
            (f"{name} C=3 edge cases", dict(c=3, win_h=WIN, win_w=WIN), True),
        ]
        for label, shape, special in cases:
            win, xy, valid = kernel_problem(rng, N_KP, s=S_MAIN, dtype=dtype,
                                            special=special, **shape)
            out = cs.window_bilinear_cuda(win, xy, valid)
            torch.cuda.synchronize()
            err = compare(out, window_bilinear_plain(win, xy, valid), win, dtype, label)
            if dtype == torch.float32:
                max_err = max(max_err, err)
        win, xy, valid = kernel_problem(rng, N_KP, 3, WIN, WIN, S_MAIN, dtype, True)
        zero = torch.zeros_like(valid)
        out = cs.window_bilinear_cuda(win, xy, zero)
        torch.cuda.synchronize()
        compare(out, window_bilinear_plain(win, xy, zero), win, dtype,
                f"{name} all-zero valid")
        finite = out[~torch.isnan(out)]
        check(bool((finite == 0).all()), "all-zero valid left a non-zero sample")

    times = {}
    for c in (3, 1):
        win, xy, valid = kernel_problem(rng, N_KP, c, WIN, WIN, S_MAIN, torch.float32)
        k_ms = time_ms(lambda: cs.window_bilinear_cuda(win, xy, valid))
        p_ms = time_ms(lambda: window_bilinear_plain(win, xy, valid))
        times[c] = (k_ms, p_ms)
        print(f"  time f32 C={c} N=512 S=40: kernel {k_ms * 1e3:.2f} us, "
              f"plain {p_ms * 1e3:.2f} us (median of 60 x 20 calls, CUDA events)")
    return max_err, times


# ------------------------------------------------------------- phases 4-5


def make_scenario(device, n_frames, h=H, w=W, kvec=KVEC, texture_seed=0,
                  knot_noise_seed=None, samples=5):
    """A smoothed random texture on a plane at 2 m seen along a generating
    spline, and blurred frames rendered in f64 with `samples` exposure
    samples by the port's own forward model.

    The defaults are the bench.py scenario: a constant-velocity spline. With
    `knot_noise_seed`, every knot is perturbed as tests/test_tracker.py's
    world_spline perturbs it (the scenario of tests/test_precision.py)."""
    import torch
    from mba_vo_tpu_torch.core import lie
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import _box_filter_1d, synthesize_blurred_image

    img = np.random.default_rng(texture_seed).uniform(0, 255, (h, w))
    for _ in range(2):
        img = _box_filter_1d(img, 2, 0)
        img = _box_filter_1d(img, 2, 1)
    f64 = dict(dtype=torch.float64, device=device)
    rng = None if knot_noise_seed is None else np.random.default_rng(knot_noise_seed)
    vel_t = np.array([0.06, -0.04, 0.02])
    vel_w = np.array([0.02, 0.05, -0.08])
    kt, kq = [np.zeros(3)], [torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)]
    for _ in range(1, n_frames + 4):
        dt, dw = vel_t * FRAME_DT, vel_w * FRAME_DT
        if rng is not None:
            dt = dt + rng.normal(0, 3e-4, 3)
            dw = dw + rng.normal(0, 5e-4, 3)
        kt.append(kt[-1] + dt)
        q = lie.quat_multiply(kq[-1], lie.quat_exp(torch.tensor(dw, dtype=torch.float64)))
        kq.append(q / torch.linalg.norm(q))
    traj = make_knots(torch.tensor(np.array(kt), **f64),
                      torch.stack(kq).to(device), 0.0, FRAME_DT)
    img0 = torch.tensor(img, **f64)
    K = torch.tensor(kvec, **f64)
    frames = []
    for i in range(1, n_frames + 1):
        cap = i * FRAME_DT
        blur = synthesize_blurred_image(img0, traj, DEG, cap, EXPOSURE, samples, DEPTH, K)
        frames.append((cap, blur.cpu().numpy()))
    return img, traj, frames


def bench_config(dtype: str, max_keypoints=N_KP, cell=30, levels=3, virtual_poses=5,
                 **options):
    """bench.py's configuration (TrackerConfig defaults otherwise);
    ``options`` overrides further TrackerConfig fields."""
    from mba_vo_tpu_torch.tracker.blur_tracker import TrackerConfig
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    return TrackerConfig(
        num_pyramid_levels=levels,
        num_virtual_poses=(virtual_poses,) * levels,
        huber_a=10.0,
        max_chi_square_error=3.0,
        keyframe_max_flow_mag0=1e9,
        keyframe_max_flow_mag1=1e9,
        detector=DetectorOptions(score_threshold=5.0, cell_h=cell, cell_w=cell,
                                 max_keypoints=max_keypoints),
        dtype=dtype,
        **options,
    )


# tests/test_precision.py's options for its drift rule: both sides stop a
# level below 1e-6 of cost decrease, and the float32 side takes full-f32
# products and Kahan-compensated normal equations
DRIFT_F64 = dict(min_abs_cost_decrease=1e-6)
DRIFT_F32 = dict(min_abs_cost_decrease=1e-6, precision="highest", compensated_sum=True)

# tests/test_precision.py's own scenario: 64x80 frames (fx 60), texture seed
# 3, the noisy world spline of tests/test_tracker.py, 3 exposure samples, 2
# levels of 3 virtual poses, 128 keypoints in 10-px cells, 100 frames
PREC_H, PREC_W, PREC_FX, PREC_FRAMES = 64, 80, 60.0, 100
PREC_KVEC = np.array([PREC_FX, PREC_FX, (PREC_W - 1) / 2, (PREC_H - 1) / 2])
PREC_SCENARIO = dict(h=PREC_H, w=PREC_W, kvec=PREC_KVEC, texture_seed=3,
                     knot_noise_seed=9, samples=3)
PREC_CONFIG = dict(max_keypoints=128, cell=10, levels=2, virtual_poses=3)


def drift_rule(ate64: float, ate32: float) -> bool:
    """tests/test_precision.py:115-117."""
    return ate64 < 2e-3 and ate32 < max(1.1 * ate64, ate64 + 2e-4)


def run_tracker(cfg, device, img, frames, kvec=KVEC):
    """Track `frames` from rest after the sharp keyframe, as bench.py does;
    returns (poses [T, 7] numpy, wall seconds of each track_frame call,
    synchronised, LM iterations per level of each frame)."""
    import torch
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    h, w = img.shape
    tracker = BlurAwareTracker(cfg, kvec, (h, w), device=device)
    tracker.track_frame(img, img, 0.0, EXPOSURE, np.full((h, w), DEPTH))
    sync = torch.cuda.synchronize if tracker.device.type == "cuda" else (lambda: None)
    sync()
    poses, seconds, iters = [], [], []
    for cap, blur in frames:
        t0 = time.perf_counter()
        poses.append(tracker.track_frame(None, blur, cap, EXPOSURE))
        sync()
        seconds.append(time.perf_counter() - t0)
        iters.append([s.num_iterations for _, s in tracker.last_summaries])
    out = np.stack([torch.cat([p.t, p.q]).double().cpu().numpy() for p in poses])
    return out, seconds, iters


def frame_errors(poses, traj, frames) -> np.ndarray:
    """Translation error [T] of each tracked frame against the generating
    spline."""
    from mba_vo_tpu_torch.core.spline import spline_pose_at

    return np.array([np.linalg.norm(p[:3] - spline_pose_at(traj, cap, DEG).t.cpu().numpy())
                     for p, (cap, _) in zip(poses, frames)])


def ate(poses, traj, frames) -> float:
    return float(np.sqrt(np.mean(np.square(frame_errors(poses, traj, frames)))))


def main() -> int:
    import torch

    # the port itself: without it (the script alone) there is nothing to run
    from mba_vo_tpu_torch.ops import cuda_sampling as cs

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    lib = cs.build()
    print(f"[2] built K1 in {time.perf_counter() - t0:.2f} s -> {lib}")
    if cs.BUILD_LOG:
        print("\n".join("    " + ln for ln in cs.BUILD_LOG.splitlines()
                        if "registers" in ln or "spill" in ln))

    # ---- 3. kernel against plain
    print("[3] K1 against its plain version")
    max_err, times = phase_kernel(cs)

    # ---- 4. slice, f64: CUDA against CPU
    t0 = time.perf_counter()
    img, traj, frames = make_scenario("cuda", LONG_FRAMES)
    print(f"[4] scenario: {LONG_FRAMES} blurred VGA frames rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    launches0 = cs.LAUNCHES
    p64, s64, _ = run_tracker(bench_config("float64"), "cuda", img, frames)
    check(cs.LAUNCHES > launches0, "the f64 CUDA run did not launch K1")
    pcpu, scpu, _ = run_tracker(bench_config("float64"), "cpu", img, frames[:CPU_FRAMES])
    diff = float(np.abs(p64[:CPU_FRAMES] - pcpu).max())
    print(f"    f64 CUDA {LONG_FRAMES} frames in {sum(s64):.2f} s; f64 CPU "
          f"{CPU_FRAMES} frames in {sum(scpu):.2f} s; max |pose CUDA - pose CPU| "
          f"over {CPU_FRAMES} frames = {diff:.3e} (bound 1e-8)")
    check(np.isfinite(p64).all() and np.isfinite(pcpu).all(), "non-finite poses")
    check(diff <= 1e-8, f"f64 CUDA and CPU poses differ by {diff}")

    # ---- 5. slice, f32 on CUDA
    # 5a. the main path: bench.py's options (TrackerConfig defaults), from rest
    cs.LAUNCHES = 0
    p32, s32, it32 = run_tracker(bench_config("float32"), "cuda", img, frames)
    launches = cs.LAUNCHES
    fps = LONG_FRAMES / sum(s32)
    ate64, ate32 = ate(p64, traj, frames), ate(p32, traj, frames)
    print(f"[5a] main path, f32 CUDA, bench options, from rest: {LONG_FRAMES} frames "
          f"in {sum(s32):.3f} s = {fps:.3f} frames/s (median "
          f"{1e3 * statistics.median(s32):.2f} ms/frame, first frame "
          f"{1e3 * s32[0]:.2f} ms); K1 launches {launches} "
          f"({launches / LONG_FRAMES:.1f} per frame)")
    print(f"    ATE f32 {ate32:.4e} m, f64 (phase 4) {ate64:.4e} m; LM iterations "
          f"per level (coarse to fine) of the first 4 frames {it32[:4]}")
    check(p32.shape == (LONG_FRAMES, 7) and np.isfinite(p32).all(), "bad f32 poses")
    check(launches > 0, "the main path never launched K1")

    # 5b. the drift rule of tests/test_precision.py with that test's options,
    # on the bench scenario from rest. Measured and printed, not a check:
    # from rest the float32 tracker ends frame 2's finest level on a step
    # that raised its cost, where float64 goes on, and the JAX tracker run
    # op by op does the same (tests/test_torch_tracker.py,
    # test_float32_from_a_standing_start_follows_jax_op_by_op; PERF.md §7)
    d64, _, it64d = run_tracker(bench_config("float64", **DRIFT_F64), "cuda", img, frames)
    d32, _, it32d = run_tracker(bench_config("float32", **DRIFT_F32), "cuda", img, frames)
    ate64d, ate32d = ate(d64, traj, frames), ate(d32, traj, frames)
    print(f"[5b] drift rule on the bench scenario from rest: ATE f32 {ate32d:.4e} m, "
          f"f64 {ate64d:.4e} m: the rule "
          f"{'holds' if drift_rule(ate64d, ate32d) else 'DOES NOT HOLD'} "
          f"(f64 < 2e-3, f32 < max(1.1 x f64, f64 + 2e-4)); not a check, see PERF.md §7")
    print(f"    LM iterations per level of the first 4 frames: f64 {it64d[:4]}, "
          f"f32 {it32d[:4]}")
    for name, p in (("f64", d64), ("f32", d32)):
        print(f"    per-frame error {name}, mm: " + " ".join(
            f"{1e3 * e:.3f}" for e in frame_errors(p, traj, frames)))
    for name, p in (("drift f64", d64), ("drift f32", d32)):
        check(p.shape == (LONG_FRAMES, 7) and np.isfinite(p).all(), f"bad {name} poses")

    # 5c. the drift rule on tests/test_precision.py's own scenario and
    # options, frame by frame (track_frames, which the test calls, is not
    # ported; it has track_frame's semantics): checked
    t0 = time.perf_counter()
    pimg, ptraj, pframes = make_scenario("cuda", PREC_FRAMES, **PREC_SCENARIO)
    r64, _, _ = run_tracker(bench_config("float64", **PREC_CONFIG, **DRIFT_F64),
                            "cuda", pimg, pframes, PREC_KVEC)
    r32, _, _ = run_tracker(bench_config("float32", **PREC_CONFIG, **DRIFT_F32),
                            "cuda", pimg, pframes, PREC_KVEC)
    ate64p, ate32p = ate(r64, ptraj, pframes), ate(r32, ptraj, pframes)
    print(f"[5c] drift rule on tests/test_precision.py's scenario ({PREC_FRAMES} frames "
          f"of {PREC_H}x{PREC_W}, from rest): ATE f32 {ate32p:.4e} m, f64 "
          f"{ate64p:.4e} m, bound for f32 {max(1.1 * ate64p, ate64p + 2e-4):.4e} m; "
          f"{time.perf_counter() - t0:.1f} s")
    for name, p in (("f64", r64), ("f32", r32)):
        check(p.shape == (PREC_FRAMES, 7) and np.isfinite(p).all(), f"bad {name} poses")
    check(drift_rule(ate64p, ate32p), f"drift rule: f32 ATE {ate32p} vs f64 {ate64p}")

    k_ms, p_ms = times[3]
    print(json.dumps({"kernels": [{
        "name": "window_bilinear",
        "route": "cuda",
        "source": "mba_vo_tpu_torch/csrc/window_bilinear.cu",
        "replaces": "mba_vo_tpu/ops/pallas_sampling.py:88",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
