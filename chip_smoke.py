"""Smoke test of the PyTorch port (mba_vo_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build kernels K1 (csrc/window_bilinear.cu) and K1-v
     (csrc/window_bilinear_tiled.cu) with nvcc for sm_90a, both at once, and
     print each kernel's registers, shared memory and spills;
  3. K1, and K1-v at every (tile, threads) the sweep harness runs, against
     the plain PyTorch version at the tracker's shapes (S = 40 per frame,
     160 and 320 per joint chunk) and on edge cases, f32 and f64;
  4. the tracker in f64 on CUDA against the same tracker on the CPU, on the
     bench scenario (VGA, 512 keypoints, 3 levels, 5 virtual poses);
  5. the per-frame main path: the tracker in f32 on CUDA under bench.py's
     options, from rest, over a longer run of the same scenario: frames/s,
     K1's launch count in that run and the ATE against the generating
     spline; the f32-vs-f64 drift rule of tests/test_precision.py with that
     test's options, measured on the bench scenario and checked on the
     test's own scenario through track_frames, as the test runs it;
  6. the multi-frame main paths at the same width: (a) track_frames against
     phase 4's track_frame poses in f64, inflight 1 against 2, and timed in
     f32; (b) a keyframe switch and a rejected frame inside one track_frames
     run against the per-frame run; (c) track_frames_joint at degree 4 and 2
     in f64 on CUDA against the CPU, then timed in f32 with its launches per
     chunk; (d) sampling="direct" and affine_brightness in f64 on CUDA
     against the CPU;
  7. the sampler sweep (mba_vo_tpu_torch.experiments.kernel_variants), the
     path that runs K1-v: every variant timed beside K1, the plain version
     and torch's grid_sample at S = 40, 160 and 320;
then one JSON line of kernel results, the card line again, and the final
status line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

H, W, FX = 480, 640, 480.0
KVEC = np.array([FX, FX, (W - 1) / 2, (H - 1) / 2])
DEPTH, EXPOSURE, FRAME_DT, DEG = 2.0, 0.03, 0.1, 2
N_KP, WIN, S_MAIN = 512, 32, 40   # S = frames x patch x virtual poses = 1 x 8 x 5
S_JOINT = (160, 320)              # joint chunks of 4 and of 8 frames
CPU_FRAMES = 4                    # phase 4: the CPU f64 run is the slow one
LONG_FRAMES = 16                  # phase 5


def kernel_launches(fn) -> int:
    """Device kernel launches made by fn(), counted by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(a.count for a in prof.key_averages()
               if a.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))


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
    check(err <= bound, f"{label}: max abs error {err} > {bound}")
    return err


def phase_kernel(cs, kv):
    """K1 and every K1-v variant against the plain version; returns the
    largest f32 error of each kernel."""
    import torch
    from mba_vo_tpu_torch.ops.window_sampling import window_bilinear_plain

    variants = kv.variants()
    rng = np.random.default_rng(1234)
    max_err = {"K1": 0.0, "K1-v": 0.0}

    def hold(win, xy, valid, dtype, label):
        ref = window_bilinear_plain(win, xy, valid)
        worst = {"K1": 0.0, "K1-v": 0.0}
        outs = []
        for name, _tile, _threads, fn in variants:
            out = fn(win, xy, valid)
            torch.cuda.synchronize()
            err = compare(out, ref, win, dtype, f"{label}: {name}")
            kind = "K1-v" if name.startswith("K1-v") else "K1"
            worst[kind] = max(worst[kind], err)
            outs.append(out)
        print(f"  {label}: max|kernel - plain| K1 {worst['K1']:.3e}, K1-v "
              f"{worst['K1-v']:.3e} over {len(variants)} variants, NaN outputs "
              f"{int(torch.isnan(ref).sum())}")
        if dtype == torch.float32:
            for kind in worst:
                max_err[kind] = max(max_err[kind], worst[kind])
        return outs

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        cases = [
            (f"{name} C=1 N=512 win=32 S=40", dict(c=1, win_h=WIN, win_w=WIN, s=S_MAIN), False),
            (f"{name} C=3 N=512 win=32 S=40", dict(c=3, win_h=WIN, win_w=WIN, s=S_MAIN), False),
            (f"{name} C=3 rectangular 20x32", dict(c=3, win_h=20, win_w=WIN, s=S_MAIN), False),
            (f"{name} C=3 edge cases", dict(c=3, win_h=WIN, win_w=WIN, s=S_MAIN), True),
        ] + [(f"{name} C=3 N=512 win=32 S={s}", dict(c=3, win_h=WIN, win_w=WIN, s=s), True)
             for s in S_JOINT]
        for label, shape, special in cases:
            win, xy, valid = kernel_problem(rng, N_KP, dtype=dtype, special=special, **shape)
            hold(win, xy, valid, dtype, label)
        win, xy, valid = kernel_problem(rng, N_KP, 3, WIN, WIN, S_MAIN, dtype, True)
        for out in hold(win, xy, torch.zeros_like(valid), dtype, f"{name} all-zero valid"):
            finite = out[~torch.isnan(out)]
            check(bool((finite == 0).all()), "all-zero valid left a non-zero sample")
    return max_err


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

    fields = dict(
        num_pyramid_levels=levels,
        num_virtual_poses=(virtual_poses,) * levels,
        huber_a=10.0,
        max_chi_square_error=3.0,
        keyframe_max_flow_mag0=1e9,
        keyframe_max_flow_mag1=1e9,
        detector=DetectorOptions(score_threshold=5.0, cell_h=cell, cell_w=cell,
                                 max_keypoints=max_keypoints),
        dtype=dtype,
    )
    fields.update(options)
    return TrackerConfig(**fields)


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


def poses_array(poses) -> np.ndarray:
    """[T, 7] float64 (t; q) rows of a list of Poses, in one copy."""
    import torch

    return torch.stack([torch.cat([p.t, p.q]) for p in poses]).double().cpu().numpy()


def run_batch(cfg, device, img, frames, method="track_frames", kvec=KVEC,
              candidates=None, window=None, **kw):
    """Bootstrap on the sharp keyframe as run_tracker does, then track
    `frames` in one call of ``method`` (track_frames or track_frames_joint).
    ``candidates``: (sharp images, depth maps) per frame; ``window``: a joint
    knot window to start from, as interop's joint_knots/joint_dt mapping.
    Returns (poses [T, 7], wall seconds of the call, synchronised, tracker)."""
    import torch
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    h, w = img.shape
    tracker = BlurAwareTracker(cfg, kvec, (h, w), device=device)
    tracker.track_frame(img, img, 0.0, EXPOSURE, np.full((h, w), DEPTH))
    if window is not None:
        interop.install_tracker_state(tracker, window)
    sync = torch.cuda.synchronize if tracker.device.type == "cuda" else (lambda: None)
    sync()
    if candidates is not None:
        kw.update(sharp_imgs=candidates[0], depth_maps=candidates[1])
    t0 = time.perf_counter()
    poses = getattr(tracker, method)([b for _, b in frames], [c for c, _ in frames],
                                     [EXPOSURE] * len(frames), **kw)
    sync()
    return poses_array(poses), time.perf_counter() - t0, tracker


def keyframe_candidates(img, traj, frames):
    """Per frame the sharp view from the generating spline and the plane's
    depth there (frontoparallel approximation), as keyframe candidate data."""
    import torch
    from mba_vo_tpu_torch.core.spline import spline_pose_at
    from mba_vo_tpu_torch.data.synthetic import warp_image

    dev = dict(dtype=torch.float64, device=traj.t.device)
    img0, K = torch.tensor(img, **dev), torch.tensor(KVEC, **dev)
    sharp, depth = [], []
    for cap, _ in frames:
        p = spline_pose_at(traj, cap, DEG)
        sharp.append(warp_image(img0, p.t, p.q, DEPTH, K).cpu().numpy())
        depth.append(np.full(img.shape, DEPTH - float(p.t[2])))
    return sharp, depth


def moving_window(traj, frames, chunk: int, degree: int) -> dict:
    """A joint knot window that already moves: the generating spline sampled
    at the window's knot times (the keyframe is the identity at t = 0), in
    interop.install_tracker_state's layout. An identity window would put
    the first patch anchors on integer pixels up to the last bit, where two
    devices may floor them differently."""
    from mba_vo_tpu_torch.core.spline import spline_pose_at_times

    K = chunk + degree - 1
    dt = max(FRAME_DT, EXPOSURE)
    t0 = frames[0][0] - 0.5 * EXPOSURE
    p = spline_pose_at_times(traj, t0 + dt * np.arange(K), DEG)
    return {"joint_knots": dict(t=p.t.cpu().numpy(), q=p.q.cpu().numpy(), t0=t0, dt=dt),
            "joint_dt": dt}


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
    from mba_vo_tpu_torch.experiments import kernel_variants as kv
    from mba_vo_tpu_torch.ops import cuda_sampling as cs

    # ---- 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = kv.card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    libs = cs.build()
    print(f"[2] built K1 and K1-v in {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(str(p) for p in libs.values())}")
    for name, log in cs.BUILD_LOG.items():
        # ptxas -v: one block of lines per instantiation (IdE = double, IfE = float)
        dtype = "?"
        for ln in log.splitlines():
            if "Compiling entry function" in ln:
                dtype = "f64" if "kernelIdE" in ln else "f32"
            elif "registers" in ln or "spill" in ln or "smem" in ln:
                print(f"    {name} {dtype}: {ln.replace('ptxas info    : ', '').strip()}")
    per_window = 3 * WIN * WIN
    print("    K1 uses no shared memory; K1-v's is dynamic, tile x C x win_h x win_w x "
          "itemsize: at C=3, 32x32 " + ", ".join(
              f"tile {t}: {t * per_window * 4} B f32 / {t * per_window * 8} B f64"
              for t in kv.TILES) + f" (a block may use {cs.MAX_SHARED_BYTES} B)")

    # ---- 3. kernels against plain
    print("[3] K1 and K1-v against the plain version")
    max_err = phase_kernel(cs, kv)

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
    launches = {"track_frame": cs.LAUNCHES}
    fps = LONG_FRAMES / sum(s32)
    ate64, ate32 = ate(p64, traj, frames), ate(p32, traj, frames)
    print(f"[5a] main path, f32 CUDA, bench options, from rest: {LONG_FRAMES} frames "
          f"in {sum(s32):.3f} s = {fps:.3f} frames/s (median "
          f"{1e3 * statistics.median(s32):.2f} ms/frame, first frame "
          f"{1e3 * s32[0]:.2f} ms); K1 launches {cs.LAUNCHES} "
          f"({cs.LAUNCHES / LONG_FRAMES:.1f} per frame)")
    print(f"    ATE f32 {ate32:.4e} m, f64 (phase 4) {ate64:.4e} m; LM iterations "
          f"per level (coarse to fine) of the first 4 frames {it32[:4]}")
    check(p32.shape == (LONG_FRAMES, 7) and np.isfinite(p32).all(), "bad f32 poses")
    check(cs.LAUNCHES > 0, "the per-frame main path never launched K1")

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
    # options, through track_frames as the test runs it: checked
    t0 = time.perf_counter()
    pimg, ptraj, pframes = make_scenario("cuda", PREC_FRAMES, **PREC_SCENARIO)
    r64, _, _ = run_batch(bench_config("float64", **PREC_CONFIG, **DRIFT_F64),
                          "cuda", pimg, pframes, kvec=PREC_KVEC, chunk=8)
    r32, _, _ = run_batch(bench_config("float32", **PREC_CONFIG, **DRIFT_F32),
                          "cuda", pimg, pframes, kvec=PREC_KVEC, chunk=8)
    ate64p, ate32p = ate(r64, ptraj, pframes), ate(r32, ptraj, pframes)
    print(f"[5c] drift rule on tests/test_precision.py's scenario ({PREC_FRAMES} frames "
          f"of {PREC_H}x{PREC_W}, from rest, track_frames in chunks of 8): ATE f32 "
          f"{ate32p:.4e} m, f64 {ate64p:.4e} m, bound for f32 "
          f"{max(1.1 * ate64p, ate64p + 2e-4):.4e} m; {time.perf_counter() - t0:.1f} s")
    for name, p in (("f64", r64), ("f32", r32)):
        check(p.shape == (PREC_FRAMES, 7) and np.isfinite(p).all(), f"bad {name} poses")
    check(drift_rule(ate64p, ate32p), f"drift rule: f32 ATE {ate32p} vs f64 {ate64p}")

    # ---- 6. the multi-frame main paths, at the bench scenario's width
    # 6a. track_frames: f64 against phase 4's track_frame poses, inflight 1
    # against 2, and f32 timed
    a2, _, _ = run_batch(bench_config("float64"), "cuda", img, frames, chunk=8, inflight=2)
    a1, _, _ = run_batch(bench_config("float64"), "cuda", img, frames, chunk=8, inflight=1)
    diff = float(np.abs(a2 - p64).max())
    check(diff <= 1e-8, f"f64 track_frames and track_frame poses differ by {diff}")
    check(np.array_equal(a1, a2), "inflight=1 and inflight=2 give different poses")
    cs.LAUNCHES = 0
    a32, sec, _ = run_batch(bench_config("float32"), "cuda", img, frames, chunk=8, inflight=2)
    launches["track_frames"] = cs.LAUNCHES
    print(f"[6a] track_frames(chunk=8, inflight=2): max |f64 pose - track_frame pose| = "
          f"{diff:.3e} (bound 1e-8), inflight 1 == 2 exactly; f32 {LONG_FRAMES} frames in "
          f"{sec:.3f} s = {LONG_FRAMES / sec:.3f} frames/s, K1 launches {cs.LAUNCHES} "
          f"({cs.LAUNCHES / LONG_FRAMES:.1f} per frame), ATE {ate(a32, traj, frames):.4e} m")
    check(a32.shape == (LONG_FRAMES, 7) and np.isfinite(a32).all(), "bad f32 poses")
    d32 = float(np.abs(a32 - p32).max())
    check(d32 <= 1e-6, f"f32 track_frames and track_frame poses differ by {d32}")
    check(cs.LAUNCHES > 0, "track_frames never launched K1")

    # 6b. a keyframe switch and a rejected frame inside one track_frames run
    # (TrackerConfig's own keyframe thresholds fire mid-chunk; frame 6 is
    # NaN) against the per-frame run of the same inputs
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    cfg_kf = bench_config("float64", keyframe_max_flow_mag0=15.0, keyframe_max_flow_mag1=30.0)
    cand = keyframe_candidates(img, traj, frames)
    bad = 6
    broken = [(c, np.full_like(b, np.nan) if i == bad else b) for i, (c, b) in enumerate(frames)]
    b2, _, tb = run_batch(cfg_kf, "cuda", img, broken, candidates=cand, chunk=8, inflight=2)
    tf = BlurAwareTracker(cfg_kf, KVEC, img.shape, device="cuda")
    tf.track_frame(img, img, 0.0, EXPOSURE, np.full(img.shape, DEPTH))
    bf = poses_array([tf.track_frame(cand[0][i], blur, cap, EXPOSURE, cand[1][i])
                      for i, (cap, blur) in enumerate(broken)])
    tf.flush()
    good = [i for i in range(LONG_FRAMES) if i != bad]
    diff = float(np.abs(b2[good] - bf[good]).max())
    moved = float(tb.T_keyframe.t.abs().max())
    print(f"[6b] keyframe switches and a NaN frame in one track_frames run: max |pose - "
          f"per-frame pose| = {diff:.3e} (bound 1e-8) over {len(good)} frames; keyframe "
          f"chain moved {moved:.4f} m; rejected {[e.cap_time for e in tb.failure_log]}")
    check(diff <= 1e-8, f"track_frames with events differs from the per-frame run by {diff}")
    check(moved > 1e-3, "no keyframe switch fired")
    check([e.cap_time for e in tb.failure_log] == [e.cap_time for e in tf.failure_log]
          == [frames[bad][0]], "the NaN frame was not rejected alike")
    check(np.array_equal(b2[bad], b2[bad - 1]), "the rejected frame did not repeat the last pose")
    check(float((tb.T_keyframe.t - tf.T_keyframe.t).abs().max()) <= 1e-8, "keyframe chains differ")

    # 6c. track_frames_joint: f64 CUDA against CPU over one chunk (LM depth
    # cut to 4 iterations a level: the CPU side is the slow one), then f32 on
    # CUDA over the whole run at full LM depth. Every run starts from a
    # window that already moves, as a tracker that has been running would: a
    # cold identity window loses this scenario's 5 px a frame within its
    # first chunk, in the reference as in the port (PERF.md section 7)
    JCHUNK = 4
    for deg in (4, 2):
        t0 = time.perf_counter()
        cfg_j = bench_config("float64", spline_degree=deg, max_num_iterations=4)
        win = moving_window(traj, frames, JCHUNK, deg)
        args = dict(method="track_frames_joint", window=win, chunk=JCHUNK, inflight=3)
        jc, _, tc = run_batch(cfg_j, "cuda", img, frames[:JCHUNK], **args)
        jh, _, th = run_batch(cfg_j, "cpu", img, frames[:JCHUNK], **args)
        diff = float(np.abs(jc - jh).max())
        kdiff = float((tc._joint_knots.t.cpu() - th._joint_knots.t).abs().max())
        print(f"[6c] track_frames_joint degree {deg}, f64, {JCHUNK} frames, "
              f"{tc._joint_knots.num_knots} knots: max |pose CUDA - pose CPU| = {diff:.3e}, "
              f"knots {kdiff:.3e} (bound 1e-8); {time.perf_counter() - t0:.1f} s")
        check(np.isfinite(jc).all(), "non-finite joint poses")
        check(diff <= 1e-8 and kdiff <= 1e-8, f"joint f64 CUDA and CPU differ by {diff}, {kdiff}")
    cs.LAUNCHES = 0
    j32, sec, _ = run_batch(bench_config("float32"), "cuda", img, frames,
                            method="track_frames_joint", chunk=JCHUNK, inflight=3,
                            window=moving_window(traj, frames, JCHUNK, DEG))
    jl = launches["track_frames_joint"] = cs.LAUNCHES
    n_chunks = LONG_FRAMES // JCHUNK
    cfg_p = bench_config("float32", max_num_iterations=4)
    total = kernel_launches(lambda: run_batch(
        cfg_p, "cuda", img, frames[:JCHUNK], method="track_frames_joint",
        window=moving_window(traj, frames, JCHUNK, DEG), chunk=JCHUNK))
    evals = cs.LAUNCHES - jl
    print(f"[6c] track_frames_joint(chunk={JCHUNK}, inflight=3), f32, degree {DEG}: "
          f"{LONG_FRAMES} frames in {sec:.3f} s = {1e3 * sec / n_chunks:.1f} ms/chunk, "
          f"{LONG_FRAMES / sec:.3f} frames/s; K1 launches {jl} "
          f"({jl / n_chunks:.1f} per chunk, one per LM evaluation at S = "
          f"{JCHUNK * S_MAIN}); ATE {ate(j32, traj, frames):.4e} m (track_frame f32 "
          f"{ate32:.4e} m)")
    print(f"    kernel launches of one chunk with the LM cut to 4 iterations a level, "
          f"bootstrap included (torch.profiler): {total} over {evals} LM evaluations = "
          f"{total / max(evals, 1):.0f} per evaluation")
    check(j32.shape == (LONG_FRAMES, 7) and np.isfinite(j32).all(), "bad joint f32 poses")
    check(jl > 0, "track_frames_joint never launched K1")

    # 6d. sampling="direct" and affine_brightness (frames under a gain that
    # drifts by 2 % and a bias that drifts by 1 grey level a frame), four
    # frames each through track_frames, f64 CUDA against CPU
    gained = [(c, (1.0 + 0.02 * (i + 1)) * b + 1.0 * (i + 1))
              for i, (c, b) in enumerate(frames[:CPU_FRAMES])]
    for label, cfg_d, fr in (
            ("sampling=direct", bench_config("float64", sampling="direct"), frames[:CPU_FRAMES]),
            ("affine_brightness", bench_config("float64", affine_brightness=True), gained)):
        t0 = time.perf_counter()
        dc, _, _ = run_batch(cfg_d, "cuda", img, fr, chunk=4)
        dh, _, _ = run_batch(cfg_d, "cpu", img, fr, chunk=4)
        diff = float(np.abs(dc - dh).max())
        print(f"[6d] {label}, f64, {len(fr)} frames: max |pose CUDA - pose CPU| = {diff:.3e} "
              f"(bound 1e-8), ATE {ate(dc, traj, fr):.4e} m; {time.perf_counter() - t0:.1f} s")
        check(np.isfinite(dc).all(), f"{label}: non-finite poses")
        check(diff <= 1e-8, f"{label}: f64 CUDA and CPU poses differ by {diff}")
        check(ate(dc, traj, fr) < 2e-3, f"{label}: ATE {ate(dc, traj, fr)} m")

    # ---- 7. the sampler sweep: the path that runs K1-v
    print("[7] sampler sweep (mba_vo_tpu_torch.experiments.kernel_variants)")
    cs.LAUNCHES_TILED = 0
    rows = kv.run_sweep(out=lambda line: print("    " + line))
    tiled = [r for r in rows if r["tile"] is not None]
    swept = sum(r["launches"] for r in tiled)
    replayed = sum(r["replayed_launches"] for r in tiled)
    # one more launch per row was compared with the plain version; a call
    # recorded into a graph is no launch, and a replay's launches pass no wrapper
    check(cs.LAUNCHES_TILED == swept + len(tiled), "the sweep's K1-v launch count is off")
    print(f"    K1-v launches in the sweep: {swept} through the wrapper to time it, "
          f"{len(tiled)} more compared with the plain version, {replayed} by graph replays")
    check(all(r["launches"] > 0 for r in tiled), "a K1-v variant was never launched")
    # f32 against 1e-5 max|W|; the sweep's standard-normal windows stay under 6
    check(all(r["max_abs_err"] <= 6e-5 for r in rows if r["name"] != "grid_sample"),
          "a sweep row disagrees with the plain version")

    def row(S, name):
        return next(r for r in rows if r["S"] == S and r["C"] == 3 and r["name"] == name)

    def entry(S, r, **more):
        plain, lib = row(S, "plain"), row(S, "grid_sample")
        return dict(S=S, name=r["name"], ms=r["ms"], device_ms=r["device_ms"],
                    device_cold_ms=r["device_cold_ms"], plain_ms=plain["ms"],
                    plain_device_ms=plain["device_ms"],
                    plain_device_cold_ms=plain["device_cold_ms"], library_ms=lib["ms"],
                    library_device_ms=lib["device_ms"],
                    library_device_cold_ms=lib["device_cold_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], staged_bound_ms=r["staged_bound_ms"], **more)

    def us(r):
        return (f"{1e3 * r['ms']:.2f} us a call / {1e3 * r['device_ms']:.2f} warm / "
                f"{1e3 * r['device_cold_ms']:.2f} cold on the device")

    by_shape = {"K1": [], "K1-v": []}
    for S in kv.SAMPLES:
        by_shape["K1"].append(entry(S, row(S, "K1 threads=128")))
        # ranked on the device's cold time: the time a call takes is the host's
        ranked = sorted((r for r in tiled if r["S"] == S and r["C"] == 3),
                        key=lambda r: r["device_cold_ms"])
        by_shape["K1-v"].append(entry(S, ranked[0], worst_name=ranked[-1]["name"],
                                      worst_ms=ranked[-1]["ms"],
                                      worst_device_ms=ranked[-1]["device_ms"],
                                      worst_device_cold_ms=ranked[-1]["device_cold_ms"]))
        print(f"    S={S} C=3: K1 {us(row(S, 'K1 threads=128'))}; K1-v best "
              f"{ranked[0]['name']} {us(ranked[0])}, worst {ranked[-1]['name']} "
              f"{us(ranked[-1])}; plain {us(row(S, 'plain'))}; grid_sample "
              f"{us(row(S, 'grid_sample'))}; bound {1e3 * ranked[0]['bound_ms']:.2f} us, "
              f"staging every window {1e3 * ranked[0]['staged_bound_ms']:.2f} us")

    def kernel_entry(name, source, replaces, n_launches, err, shapes, **more):
        main = shapes[0]   # S = 40, C = 3: the per-frame shape
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=n_launches, max_abs_err=err, ms=main["ms"],
                    device_ms=main["device_ms"], device_cold_ms=main["device_cold_ms"],
                    plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"], library_ms=main["library_ms"],
                    by_shape=shapes, **more)

    print(json.dumps({"kernels": [
        kernel_entry("window_bilinear", "mba_vo_tpu_torch/csrc/window_bilinear.cu",
                     "mba_vo_tpu/ops/pallas_sampling.py:118", sum(launches.values()),
                     max_err["K1"], by_shape["K1"], launches_by_path=launches),
        kernel_entry("window_bilinear_tiled", "mba_vo_tpu_torch/csrc/window_bilinear_tiled.cu",
                     "experiments/kernel_variants_r04.py:133",
                     swept, max_err["K1-v"], by_shape["K1-v"],
                     variant=by_shape["K1-v"][0]["name"], replayed_launches=replayed),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
