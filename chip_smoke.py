"""Smoke test of the PyTorch port (mba_vo_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build kernels K1 (csrc/window_bilinear.cu: one thread a sample, which
     the tracker launches, and the band design) and K1-v
     (csrc/window_bilinear_tiled.cu: the ring design and the staged first
     design) with nvcc for sm_90a, both sources at once, and print each
     kernel's registers, shared memory and spills;
  3. record the sampler's inputs as the tracker gives them on the bench
     scenario (16 frames of track_frame from rest, one chunk of
     track_frames_joint from a moving window, f32); then both designs of K1
     and of K1-v, K1-v at every (tile, threads) the sweep harness runs,
     against the plain PyTorch version: f32 and f64, C = 1 and 3, S = 1,
     40, 160 and 320, windows 32x32, 20x32, 20x30, 21x31 and 6x9, the
     strided C = 1 slice, a ragged last tile, an all-zero mask, coordinates
     off the staged band and off the window, and every recorded call;
     whether K1's two designs agree bit for bit;
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
     path that runs K1-v: every variant timed beside K1, K1's band design,
     K1-v's staged design, the plain version and torch's grid_sample at
     S = 40, 160 and 320 on the sweep's synthetic inputs; then the two designs of each
     kernel, K1-v's best and worst variant, plain and grid_sample on phase
     3's recorded inputs ("tracker S=40", "tracker S=160") with the
     histogram of their tap rows; and the floor row (N = 1, S = 1, C = 3);
then one JSON line of kernel results, the card line again, and the final
status line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
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
JCHUNK = 4                        # phase 6c: frames a joint chunk


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


def kernel_problem(rng, n, c, win_h, win_w, s, dtype, special=False, band_edges=False):
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
    if band_edges:
        # rows inside the window but off K1's staged band, and just off the window
        top = rng.uniform(-1.5, 4.0, (n, s))
        bottom = rng.uniform(win_h - 5.0, win_h + 0.5, (n, s))
        xy[..., 1] = np.where(rng.random((n, s)) < 0.5, top, bottom)
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


KINDS = ("K1", "K1 band", "K1-v", "K1-v staged")


def phase_kernel(kv, recorded):
    """Every kernel row of the sweep (both designs of K1 and of K1-v, every
    K1-v variant) against the plain version on the cases of the module
    docstring and on every recorded tracker call; returns (the largest f32
    error of each kind, [(case, K1 and K1 band equal bit for bit, their
    largest difference)])."""
    import torch
    from mba_vo_tpu_torch.ops.window_sampling import window_bilinear_plain

    rows = kv.variants()
    rng = np.random.default_rng(1234)
    max_err = {kind: 0.0 for kind in KINDS}
    bitwise = []

    def hold(win, xy, valid, label):
        dtype = win.dtype
        ref = window_bilinear_plain(win, xy, valid)
        worst = {kind: 0.0 for kind in KINDS}
        outs = {}
        for row in rows:
            out = row.fn(win, xy, valid)
            torch.cuda.synchronize()
            err = compare(out, ref, win, dtype, f"{label}: {row.name}")
            worst[row.kind] = max(worst[row.kind], err)
            outs[row.name] = out
        k1, band = outs["K1 threads=128"], outs["K1 band threads=128"]
        same = torch.equal(torch.nan_to_num(k1, nan=-1.0), torch.nan_to_num(band, nan=-1.0))
        bitwise.append((label, same, compare(band, k1, win, dtype, f"{label}: K1 band "
                                             "against K1")))
        if dtype == torch.float32:
            for kind in KINDS:
                max_err[kind] = max(max_err[kind], worst[kind])
        return outs, ref, worst

    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        cases = [(f"C=1 S={S_MAIN}", dict(c=1, win_h=WIN, win_w=WIN, s=S_MAIN), {})]
        cases += [(f"C=3 S={s}", dict(c=3, win_h=WIN, win_w=WIN, s=s), dict(special=s >= 40))
                  for s in (1, S_MAIN) + S_JOINT]
        cases += [(f"C=3 {h}x{w}", dict(c=3, win_h=h, win_w=w, s=S_MAIN), dict(special=True))
                  for h, w in ((20, WIN), (20, 30), (21, 31), (6, 9))]
        cases += [("C=1 20x30", dict(c=1, win_h=20, win_w=30, s=S_MAIN), {}),
                  ("C=3 off the band", dict(c=3, win_h=WIN, win_w=WIN, s=S_MAIN),
                   dict(band_edges=True))]
        summary = []
        for label, shape, extra in cases:
            win, xy, valid = kernel_problem(rng, N_KP, dtype=dtype, **shape, **extra)
            _, ref, worst = hold(win, xy, valid, f"{name} {label}")
            summary.append((label, worst, int(torch.isnan(ref).sum())))
        # the C = 1 slice of a C = 3 cache, read in place; a ragged last tile
        win, xy, valid = kernel_problem(rng, N_KP, 3, WIN, WIN, S_MAIN, dtype, True)
        _, ref, worst = hold(win[:, :1], xy, valid, f"{name} strided C=1 slice")
        summary.append(("strided C=1 slice", worst, int(torch.isnan(ref).sum())))
        win, xy, valid = kernel_problem(rng, N_KP - 3, 3, WIN, WIN, S_MAIN, dtype, True)
        _, ref, worst = hold(win, xy, valid, f"{name} N={N_KP - 3} (ragged last tile)")
        summary.append((f"N={N_KP - 3}", worst, int(torch.isnan(ref).sum())))
        win, xy, valid = kernel_problem(rng, N_KP, 3, WIN, WIN, S_MAIN, dtype, True)
        outs, ref, worst = hold(win, xy, torch.zeros_like(valid), f"{name} all-zero valid")
        for out in outs.values():
            finite = out[~torch.isnan(out)]
            check(bool((finite == 0).all()), "all-zero valid left a non-zero sample")
        summary.append(("all-zero valid", worst, int(torch.isnan(ref).sum())))
        for label, worst, nans in summary:
            print(f"  {name} {label}: max|kernel - plain| " + ", ".join(
                f"{k} {v:.3e}" for k, v in worst.items()) + f"; NaN outputs {nans}")

    for label, calls in recorded.items():
        worst = {kind: 0.0 for kind in KINDS}
        for i, call in enumerate(calls):
            _, _, w = hold(*call.args, f"{label} call {i} (C={call.C}, level {call.level})")
            worst = {k: max(worst[k], w[k]) for k in KINDS}
        print(f"  {label}: {len(calls)} recorded calls (C = "
              f"{sorted({c.C for c in calls})}, S = {sorted({c.S for c in calls})}): "
              f"max|kernel - plain| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return max_err, bitwise


def record_tracker_calls(img, traj, frames) -> dict:
    """The sampler's inputs as the tracker gives them on the bench scenario
    in f32: "tracker S=40", the calls of 16 frames of track_frame from rest
    (bench.py's options); "tracker S=160", those of one chunk of
    track_frames_joint(chunk=4) from a moving window (the bootstrap frame's
    S = 40 calls left out)."""
    from mba_vo_tpu_torch.experiments import kernel_variants as kv

    with kv.record_sampler_calls() as per_frame:
        run_tracker(bench_config("float32"), "cuda", img, frames)
    with kv.record_sampler_calls() as joint:
        run_batch(bench_config("float32"), "cuda", img, frames[:JCHUNK],
                  method="track_frames_joint", chunk=JCHUNK, inflight=3,
                  window=moving_window(traj, frames, JCHUNK, DEG))
    s_joint = JCHUNK * S_MAIN
    return {"tracker S=40": [c for c in per_frame if c.S == S_MAIN],
            f"tracker S={s_joint}": [c for c in joint if c.S == s_joint]}


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
    device_kind = torch.cuda.get_device_name(0)
    print(f"[1] device: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 2. build
    t0 = time.perf_counter()
    libs = cs.build()
    print(f"[2] built K1 and K1-v in {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(str(p) for p in libs.values())}")
    for name, log in cs.BUILD_LOG.items():
        # ptxas -v: one block of lines per kernel instantiation (IfE float,
        # IdE double)
        kernel = "?"
        for ln in log.splitlines():
            m = re.search(r"(window_bilinear(?:_[a-z]+)?_kernel)I([fd])", ln)
            if "Compiling entry function" in ln and m:
                kernel = f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'f64'}"
            elif any(w in ln for w in ("registers", "spill", "smem")) and "extern" not in ln:
                print(f"    {kernel}: {ln.replace('ptxas info    : ', '').strip()}")
    item = dict(f32=4, f64=8)
    print(f"    dynamic shared memory at C=3, 32x32, S={S_MAIN}: K1 band ({cs.TOP_ROWS} + "
          f"{cs.BAND_ROWS} rows a plane and warp, 128 threads) " + " / ".join(
              f"{cs.band_shared_bytes(128, 3, WIN, WIN, b)} B {t}" for t, b in item.items())
          + "; K1-v (a ring of 2 stages, whatever the tile) " + " / ".join(
              f"{cs.ring_shared_bytes(3, WIN, WIN, S_MAIN, b)} B {t}" for t, b in item.items())
          + "; K1-v staged, tile x C x win_h x win_w x itemsize: " + ", ".join(
              f"tile {t}: {t * 3 * WIN * WIN * 4} B f32" for t in kv.TILES)
          + f"; K1 none (a block may use {cs.MAX_SHARED_BYTES} B)")

    # ---- 3. kernels against plain, on the cases and on the tracker's inputs
    t0 = time.perf_counter()
    img, traj, frames = make_scenario("cuda", LONG_FRAMES)
    t1 = time.perf_counter()
    recorded = record_tracker_calls(img, traj, frames)
    print(f"[3] scenario: {LONG_FRAMES} blurred VGA frames rendered in {t1 - t0:.1f} s; "
          f"sampler calls recorded in {time.perf_counter() - t1:.1f} s: " + ", ".join(
              f"{label} {len(calls)} (C=3: {sum(c.C == 3 for c in calls)}, levels "
              f"{sorted({c.level for c in calls})})" for label, calls in recorded.items()))
    print("    K1 (and its band design) and K1-v (ring, every variant; staged) against "
          "the plain version")
    t0 = time.perf_counter()
    max_err, bitwise = phase_kernel(kv, recorded)
    equal = [label for label, same, _ in bitwise if same]
    differ = [(label, d) for label, same, d in bitwise if not same]
    print(f"    K1 band against K1: equal bit for bit on {len(equal)} of "
          f"{len(bitwise)} cases; " + ("differ on " + ", ".join(
              f"{label} (max {d:.3e})" for label, d in differ) if differ else "no case differs")
          + f"; phase 3 in {time.perf_counter() - t0:.1f} s")

    # ---- 4. slice, f64: CUDA against CPU
    launches0 = cs.LAUNCHES
    p64, s64, _ = run_tracker(bench_config("float64"), "cuda", img, frames)
    check(cs.LAUNCHES > launches0, "the f64 CUDA run did not launch K1")
    pcpu, scpu, _ = run_tracker(bench_config("float64"), "cpu", img, frames[:CPU_FRAMES])
    diff = float(np.abs(p64[:CPU_FRAMES] - pcpu).max())
    print(f"[4] f64 CUDA {LONG_FRAMES} frames in {sum(s64):.2f} s; f64 CPU "
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
    t0 = time.perf_counter()

    def indent(line):
        print("    " + line)

    counters = dict(zip(KINDS, ("LAUNCHES", "LAUNCHES_BAND", "LAUNCHES_TILED",
                                "LAUNCHES_STAGED")))
    for counter in counters.values():
        setattr(cs, counter, 0)
    rows = kv.run_sweep(out=indent)
    swept, replayed = {}, {}
    for kind, counter in counters.items():
        mine = [r for r in rows if r["kind"] == kind]
        swept[kind] = sum(r["launches"] for r in mine)
        replayed[kind] = sum(r["replayed_launches"] for r in mine)
        # one more launch per row was compared with the plain version; a call
        # recorded into a graph is no launch, and a replay's launches pass no
        # wrapper
        check(getattr(cs, counter) == swept[kind] + len(mine),
              f"the sweep's {kind} launch count is off")
        check(all(r["launches"] > 0 for r in mine), f"a {kind} row was never launched")
    print("    launches in the synthetic sweep (through the wrapper to time it, one more "
          "a row compared with the plain version, by graph replays): " + "; ".join(
              f"{k} {swept[k]} + {sum(r['kind'] == k for r in rows)} + {replayed[k]}"
              for k in KINDS))
    # f32 against 1e-5 max|W|; the sweep's standard-normal windows stay under 6
    check(all(r["max_abs_err"] <= 6e-5 for r in rows if r["name"] != "grid_sample"),
          "a sweep row disagrees with the plain version")
    kernels = kv.pick_kernels(rows)
    for label, calls in recorded.items():
        rows += kv.tracker_rows(label, [c for c in calls if c.C == 3], kernels, out=indent)
    floor = {r["name"]: r for r in kv.floor_rows(kernels, out=indent)}
    print(f"    phase 7 in {time.perf_counter() - t0:.1f} s")

    shapes = ([("synthetic", S) for S in kv.SAMPLES]
              + [(label, calls[0].S) for label, calls in recorded.items()])

    def row(inputs, S, name):
        return next(r for r in rows if r["inputs"] == inputs and r["S"] == S
                    and r["C"] == 3 and r["name"] == name)

    def entry(r, **more):
        plain, lib = row(r["inputs"], r["S"], "plain"), row(r["inputs"], r["S"], "grid_sample")
        return dict(inputs=r["inputs"], S=r["S"], name=r["name"], ms=r["ms"],
                    device_ms=r["device_ms"], device_cold_ms=r["device_cold_ms"],
                    plain_ms=plain["ms"], plain_device_ms=plain["device_ms"],
                    plain_device_cold_ms=plain["device_cold_ms"], library_ms=lib["ms"],
                    library_device_ms=lib["device_ms"],
                    library_device_cold_ms=lib["device_cold_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], staged_bound_ms=r["staged_bound_ms"], **more)

    def us(r):
        return (f"{1e3 * r['ms']:.2f} us a call / {1e3 * r['device_ms']:.2f} warm / "
                f"{1e3 * r['device_cold_ms']:.2f} cold on the device")

    by_shape = {k: [] for k in KINDS}
    for inputs, S in shapes:
        for kind in ("K1", "K1 band", "K1-v staged"):
            name = next(k.name for k in kernels if k.kind == kind)
            by_shape[kind].append(entry(row(inputs, S, name)))
        # ranked on the device's cold time: the time a call takes is the host's
        ranked = sorted((r for r in rows if r["kind"] == "K1-v" and r["inputs"] == inputs
                         and r["S"] == S and r["C"] == 3), key=lambda r: r["device_cold_ms"])
        by_shape["K1-v"].append(entry(ranked[0], worst_name=ranked[-1]["name"],
                                      worst_ms=ranked[-1]["ms"],
                                      worst_device_ms=ranked[-1]["device_ms"],
                                      worst_device_cold_ms=ranked[-1]["device_cold_ms"]))
        b = by_shape["K1"][-1]
        print(f"    {inputs} S={S} C=3: K1 {us(b)}; K1 band {us(by_shape['K1 band'][-1])}; "
              f"K1-v best {ranked[0]['name']} {us(ranked[0])}, worst {ranked[-1]['name']} "
              f"{us(ranked[-1])}; K1-v staged {us(by_shape['K1-v staged'][-1])}; plain "
              f"{us(row(inputs, S, 'plain'))}; grid_sample {us(row(inputs, S, 'grid_sample'))}; "
              f"bound {1e3 * b['bound_ms']:.3f} us, staging every window "
              f"{1e3 * b['staged_bound_ms']:.2f} us")
    main_shape = len(kv.SAMPLES)   # tracker S=40: the per-frame path's own inputs
    k1, k1b = by_shape["K1"][main_shape], by_shape["K1 band"][main_shape]
    print(f"    the tracker's own S={S_MAIN} inputs, cold: K1 "
          f"{1e3 * k1['device_cold_ms']:.2f} us, its band design "
          f"{1e3 * k1b['device_cold_ms']:.2f} us; floor of one launch (N=1, S=1, C=3) cold: "
          + ", ".join(f"{n} {1e3 * r['device_cold_ms']:.2f} us" for n, r in floor.items()))

    def design(kind):
        fl = floor[by_shape[kind][0]["name"]]
        return dict(name=by_shape[kind][0]["name"], max_abs_err=max_err[kind],
                    floor_ms=fl["device_cold_ms"], floor_warm_ms=fl["device_ms"],
                    by_shape=by_shape[kind])

    def kernel_entry(name, source, replaces, kind, n_launches, **more):
        main, d = by_shape[kind][main_shape], design(kind)
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=n_launches, max_abs_err=d["max_abs_err"], ms=main["ms"],
                    device_ms=main["device_ms"], device_cold_ms=main["device_cold_ms"],
                    plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                    bound_by=main["bound_by"], library_ms=main["library_ms"],
                    floor_ms=d["floor_ms"], floor_warm_ms=d["floor_warm_ms"],
                    by_shape=d["by_shape"], **more)

    # K1: the tracker launches the one-thread-a-sample design; the band
    # redesign, slower cold on the tracker's S = 40 inputs when the tracker's
    # design was chosen (PERF.md section 6), is reported beside it
    print(json.dumps({"kernels": [
        kernel_entry("window_bilinear", "mba_vo_tpu_torch/csrc/window_bilinear.cu",
                     "mba_vo_tpu/ops/pallas_sampling.py:118", "K1", sum(launches.values()),
                     launches_by_path=launches, before=design("K1"),
                     redesign=dict(design("K1 band"), launches=swept["K1 band"])),
        kernel_entry("window_bilinear_tiled", "mba_vo_tpu_torch/csrc/window_bilinear_tiled.cu",
                     "experiments/kernel_variants_r04.py:133", "K1-v", swept["K1-v"],
                     variant=by_shape["K1-v"][main_shape]["name"],
                     replayed_launches=replayed["K1-v"], before=design("K1-v staged")),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
