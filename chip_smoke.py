"""Smoke test of the PyTorch port (mba_vo_tpu_torch) on one NVIDIA GPU.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises and the exit code is non-zero):
  1. device: require CUDA, print the card's name and power limit, TF32 off;
  2. build kernels K1 (csrc/window_bilinear.cu: one thread a sample, which
     the tracker launches, and the band design), K1-v
     (csrc/window_bilinear_tiled.cu: the ring design and the staged first
     design), K2 (csrc/residual_rows.cu: warp_tangents from the spline
     knots and its earlier thread design, blur_rows in the keypoint design
     and the earlier thread design), K3
     (csrc/normal_equations.cu: the cluster design and the earlier split
     design), K5 (csrc/frame_layout.cu: the patch layout, the staged design
     and the earlier serial design) and K4 (csrc/image_bilinear.cu: the
     direct path's whole-image sampler, the select design, the interleaved
     row and the earlier branch design) and K6-K8 (csrc/lm_step.cu: the LM
     iteration's step, decision and commit; K6's shuffle design, K7's
     keypoint design and K8's staged design, and the earlier block designs
     of the three), K9 (csrc/knot_prior.cu: the joint path's knot
     prior) and K10-K12 (csrc/bundle_adjust.cu: the backend's BA
     iteration, its normal equations, Schur step and commit; K10's band
     design, K11's cooperative design and K12's cluster design, and the
     earlier ticket designs of the three) with nvcc for sm_90a, all
     nine sources at once, and print each kernel's registers, shared
     memory and spills, K5's staging, K4's block, K6's threads and shared
     memory by D, K7's threads by N, K9's shared memory by K and K10-K12's
     split of the landmarks, shared memory, K11's resident CTAs and K12's
     cluster by window;
  2b. the card tests: tests/test_torch_cuda.py under pytest (-m cuda,
     without the JAX test configuration), every kernel against its plain
     version (K4 and K5 bit for bit, the direct path on the kernels against
     its plain chain, K6-K8 against the LM's plain stages at D = 12, 30,
     42 and 162, both K6 designs against K6's order transcribed bit for
     bit, both K7 designs against the plain stage, both K8 designs, the
     staged one through lm_commit_cuda and through a CommitBinding, against
     the plain stage bit for bit, K9 against its plain version at K = 3,
     7, 11 and 32 (bit for bit as the target) and through a level's
     binding, and the tracker's LM on
     them against the plain-stage tracker) and blur_rows and K3 against
     their earlier designs bit for bit on edge shapes; and
     tests/test_torch_cuda_ba.py: K10-K12 against the BA's plain stages on
     every iteration of runs on padded, prior-less, 8a-sized, two-pose,
     short-last-slice (19 CTAs) and wide windows (S in K11's global
     scratch) in f64 and f32, the earlier ticket designs of K10-K12
     against the launched ones on the same runs (K10 and K12 bit for bit),
     the kernels' run against the CPU's, one launch of each an iteration
     and no plain stage or ticket design, the wrapper's refusals, a K11
     grid too large to be resident raising, K11 and K12 recorded into CUDA
     graphs, a NaN step rejected and a done state unchanged; any failure
     fails the run;
  3. record the sampler's inputs as the tracker gives them on the bench
     scenario (16 frames of track_frame from rest, one chunk of
     track_frames_joint from a moving window, f32), and K2's and K3's
     inputs on the same 16 frames and on one joint chunk at degree 4 (6K =
     42), and K4's and K5's (and K2's and K3's) on 4 frames of track_frame
     with sampling="direct", held against their plain versions on every
     recorded call (experiments/residual_kernels.py; the layout K5 on every
     path and K4 bit for bit), warp_tangents also against the old path (the
     torch chain of the pose Jacobian, then the thread design) to the same
     tolerances with vs equal, blur_rows, K3, K5 and K4 against their
     earlier designs bit for bit, and the direct path on the kernels against its
     plain chain at every recorded layout call's knots (r and J within K2's
     tolerances, valid equal); then both designs of K1
     and of K1-v, K1-v at every (tile, threads) the sweep harness runs,
     against the plain PyTorch version: f32 and f64, C = 1 and 3, S = 1,
     40, 160 and 320, windows 32x32, 20x32, 20x30, 21x31 and 6x9, the
     strided C = 1 slice, a ragged last tile, an all-zero mask, coordinates
     off the staged band and off the window, and every recorded call;
     whether K1's two designs agree bit for bit; and the LM's stages K6-K8,
     recorded on the same three runs, against their plain stages on every
     call (K6's step and model change, in both designs, bit for bit against
     its order transcribed, its candidate knots equal to the retraction of
     its own step, its refined step within kappa_2(H1) u and the
     library's within 3 D kappa_2(H1) u of a float64 solve of the same
     system, where that bound is under 1, both forward errors and the calls
     left unchecked printed; K7's
     flags, decrease and mask equal in both designs; K8's next state, in
     both designs, the staged one through lm_commit_cuda and through a
     CommitBinding, bit for bit); K9's calls of the joint chunk (K = 7)
     against its plain version (bit for bit where the transcendentals round
     alike, else within 1e-6 of each output's magnitude);
  4. the tracker in f64 on CUDA against the same tracker on the CPU, on the
     bench scenario (VGA, 512 keypoints, 3 levels, 5 virtual poses), with
     every K2, K3 and K5 call of the CUDA run held against the plain
     version, then 4 frames of the direct path in f64 recorded and held as
     phase 3 holds the f32 ones; K6-K8 on every call of the f64 run, whose
     LM iterations a level and poses (1e-9) equal the plain-stage
     tracker's, one host read an LM iteration;
  5. the per-frame main path: the tracker in f32 on CUDA under bench.py's
     options, from rest, over a longer run of the same scenario: frames/s,
     K1's to K8's launch counts in that run, the kernel launches a frame and
     an LM evaluation (torch.profiler; with K5 and with the plain layout in
     its place), the host reads an LM iteration and the ATE against the
     generating spline; the f32-vs-f64 drift rule of tests/test_precision.py with that
     test's options, measured on the bench scenario and checked on the
     test's own scenario through track_frames, as the test runs it;
  6. the multi-frame main paths at the same width: (a) track_frames against
     phase 4's track_frame poses in f64, inflight 1 against 2, and timed in
     f32; (b) a keyframe switch and a rejected frame inside one track_frames
     run against the per-frame run; (c) track_frames_joint at degree 4 and 2
     in f64 on CUDA against the CPU, K6-K9 held on every call of the f64
     CUDA runs (into phase 4's f64 figures), then timed in f32 with its
     launches per chunk and per LM evaluation, K9's launches against the
     levels' starts and iterations; (d) sampling="direct" and affine_brightness in f64 on CUDA
     against the CPU (1e-8, ATE under 2e-3 m), with K1's to K8's launches;
     in (a), (c) and (d) the f64 LM iterations a level equal the plain-stage
     tracker's and the poses its to 1e-9;
     (e) sampling="direct" in f32 at full width from rest, as 5a: frames/s
     and kernel launches an LM evaluation on the kernels, eager (its plain
     chain and the plain layout on the card) and beside 5a's;
  7. the sampler sweep (mba_vo_tpu_torch.experiments.kernel_variants), the
     path that runs K1-v: every variant timed beside K1, K1's band design,
     K1-v's staged design, the plain version and torch's grid_sample at
     S = 40, 160 and 320 on the sweep's synthetic inputs; then the two designs of each
     kernel, K1-v's best and worst variant, plain and grid_sample on phase
     3's recorded inputs ("tracker S=40", "tracker S=160") with the
     histogram of their tap rows; and the floor row (N = 1, S = 1, C = 3);
     then K2's two entries, K3 (its calls with J) and K5 on phase 3's
     recorded calls of the windowed paths and K4 (its C = 3 calls) on the
     direct path's, warm and cold in a replayed graph and as a call from
     Python, beside the earlier designs (for warp_tangents the old path
     whole and the thread design alone on the chain's outputs), the plain
     versions, the bound (its share of each design's time, and the ratio of
     that time to one launch's floor) and, for K3, cuBLAS's Jw.T @ Jw, for
     K4 grid_sample of the stacked planes and K1 at N = 1 on the whole
     image, and K4's interleaved row (held to the kernel bit for bit on the
     calls it is timed on) and the cost of building its planes; K4's
     designs and yardsticks level by level; K4's and K5's targets; then K6-K8
     and their plain stages on phase 3's recorded LM calls at the frame (6K
     = 12) and the degree-4 joint chunk (42), a call, warm and cold, beside
     the bound and, for K6, torch.linalg.cholesky_ex + cholesky_solve;
     K6's, K7's and K8's earlier designs (the block designs) beside the
     launched ones, each design's floor (K6 at D = 6, K7 at N = 1, K8 at K
     = F = N = 1), K8's host call through its CommitBinding beside the
     public wrapper's, the two timed in turn, K6's and K7's predictions
     and K8's targets; K9 on the joint chunk's recorded calls beside its
     old path (torch.func.jacfwd), its plain version, its bound and its
     floor (K = 3), and its target;
  8. the command line and the keyframe backend: (a) float64 on CUDA against
     the CPU at full width: detect_sparse + match_descriptors on a VGA frame
     of the bench scenario with BackendConfig's default detector (differing
     descriptor bits counted, float32 too), run_bundle_adjustment at window
     7 with 512 landmark slots on K10-K12 (its iterations, one launch of
     each and one host read an iteration, every iteration held against the
     plain stages, its time beside the plain stages' on the card, in turn),
     optimize_pose_graph at 64 nodes, solve_pnp;
     (b) `cli track --backend ba+pg` on a small loop sequence (float64
     config) with --device cuda against --device cpu: every keyframe's
     BA/PG iterations, loop edges and landmarks, and the TUM files (1e-8
     until BA's roundoff amplification reaches it, 1e-6 over the run),
     beside the same run on the CPU with one thread, and K10-K12's launches
     against its BA iterations; (c) the loop benchmark at bench_loop.py's
     defaults through experiments/loop_bench.py on the card, its ATE rule
     (ba+pg cuts the final-quarter ATE by >= 50 %) beside LOOP_r05.json's
     JAX-on-CPU figures, wall time, frames/s, K1's, K2's and K3's launches
     (each > 0), K10-K12's against its BA iterations, every BA iteration
     of its ba+pg run held against the plain stages, and the backend's
     ms per keyframe by stage, then its tracker-only run again on the CPU
     from the card's files: the per-frame TUM difference and the first
     frame over 1e-8; (d) `cli synth` at VGA, then `cli track` in
     float32 under bench options (TrackerConfig's keyframe thresholds) with
     --chunk 8, with and without --backend ba+pg: frames/s of both, K10-K12's
     launches against the f32 backend's BA iterations (0 without it); then
     K10-K12 timed on 8a's and 8c's recorded iterations (a call through the
     binding, warm and cold on the device, each in both designs in turn,
     the launched one and the earlier ticket design, beside the plain
     stage's call, the bound and, for K11, torch.linalg.cholesky_ex +
     cholesky_solve on the same reduced system), the phase split of both
     designs of K10, K11 and K12 from bundle_adjust.cu's harness-only build
     (BA_PHASE_CLOCKS), and the ticket designs held against the launched
     ones on every 8a iteration and 8c's first 200 (K10 and K12 bit for
     bit);
  9. the models, the non-planar scene, undistortion and overlays, each
     stage under the port's StageTimer: (a) at VGA, the undistortion maps
     (rad-tan pinhole, unified xi = 0.8) in f64 CUDA against the CPU and
     f32 against f64, ms a map, the f32 remap of a bench frame and of a
     depth map through the rounded map, a profile_trace of one map and
     remap; IMU synthesis at 1 kHz over 2 s of a bench-style spline
     (degree 4) CUDA against the CPU and its strapdown re-integration
     (tests/test_sensors_navstate.py's bounds); fit_scene_flow at M = 512,
     T = 8; MultiCameraFrame with two VGA cameras (f64 keypoints equal on
     CUDA and the CPU, responses to an ulp, with the count of f64 square
     roots each rounds otherwise); (b) `cli synth --scene 3d` at its
     defaults on the card and at 3 frames on the CPU (grey levels and
     depth compared), then `cli track` on it in f32 under bench options
     with --chunk 8 --viz-dir: frames/s, K1 launches, ATE (4e-2), overlay
     count and ms; (c) rad-tan and unified copies of 8d's VGA sequence
     tracked with --distortion=... and --camera-model unified --xi 0.8
     (ATE 8e-3) beside the original; (d) the realism ladder of
     tests/test_scene3d.py in f64 and f32 through track_frame, at the
     test's recipe (its bounds checked on f64) and at VGA, and the
     recipe's f32 run on the CPU beside it;
 10. sharding on torch.distributed and the command line's read-ahead: (a)
     two spawned gloo ranks on cuda:0 track 8 frames of the bench scenario
     with shard_devices = 2 through track_frame, track_frames and
     track_frames_joint in f64, against phases 4, 6a and 6c's
     single-process runs (1e-9), every rank's knots and poses equal bit for
     bit and K1, K2 and K3 launched by every rank (counted from 0 before
     each path), K1 held against the plain version on every sampler call
     of the sharded track_frame path, at the shard's 256 keypoints (1e-12),
     and K2 and K3 on every call of that path on every rank (1e-12 rows,
     1e-10 sums), then track_frame in f32: frames/s beside 5a's; (b)
     run_bundle_adjustment_sharded at 8a's size against dense (1e-8), the
     dense run on K10-K12 (a launch of each an iteration) and the sharded
     one on the plain stages (no launch); (c)
     `python -m torch.distributed.run --nproc-per-node 2 -m
     mba_vo_tpu_torch.cli track --shard-devices 2` on 8d's sequence (f64)
     against the single-process command line (1e-6); (d) `cli track` on a
     Paeth-filtered copy of 8d's sequence reading every file on the calling
     thread, with the decoders in two threads and in two processes (the
     command line's read-ahead, `cli.READ_AHEAD`): frames/s of each, the
     TUM file equal to the filter-0 run's;
K2's to K12's launches are counted, as K1's, on each path (5a, 6a, 6c-6e,
8b-8d, 9b-9d; K2-K5 and K9 10a per rank, whose sharded LM runs the plain
stages around K9; a call of K3 launches one kernel; K9 only where the
knot prior is on, the joint path; K10-K12 on the backend's paths, 8a-8d
and 10b); then one JSON line of kernel results (K1 to K12),
the card line again, and the final status line {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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


# K2's and K3's launch counters (ops/cuda_residual.py), and their counts by
# path: each in-process path zeroes every kernel's count just before it runs
# and reads K2's and K3's just after (K1's go to the ``launches`` dicts)
RESIDUAL_LAUNCHES: dict = {}
# the launches of the earlier designs by path (K6-K8's block designs, K10's,
# K11's and K12's ticket designs), read beside K2's to K12's: no path launches
# them, so each must read 0
EARLIER_LAUNCHES: dict = {}


def earlier_counts() -> dict:
    """The earlier designs' launches (EARLIER_LAUNCHES' entries)."""
    from mba_vo_tpu_torch.ops import cuda_ba, cuda_lm

    return {**cuda_lm.earlier_launch_counts(), **cuda_ba.earlier_launch_counts()}


def zero_counts(cs):
    """Zero K1's launch count and K2's to K12's."""
    from mba_vo_tpu_torch.ops import cuda_ba, cuda_lm
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    cs.LAUNCHES = 0
    cr.zero_launch_counts()
    cuda_lm.zero_launch_counts()
    cuda_ba.zero_launch_counts()


def note_residual_launches(path: str) -> dict:
    """K2's to K12's launches since :func:`zero_counts`, kept under ``path``."""
    from mba_vo_tpu_torch.ops import cuda_ba, cuda_lm
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    got = {**cr.launch_counts(), **cuda_lm.launch_counts(),
           "knot_prior": cuda_lm.LAUNCHES_KNOT_PRIOR, **cuda_ba.launch_counts()}
    RESIDUAL_LAUNCHES[path] = got
    EARLIER_LAUNCHES[path] = earlier_counts()
    return got


def skipped(got: dict, direct: bool = False, prior: bool = False) -> list:
    """The kernels that a path's launch counts ``got`` show it never
    launched though it should have: every path's (K2's two entries, K3, the
    layout K5 and, where ``got`` counts them, the LM's K6-K8), on the
    direct path K4 and, where the knot prior is on (the joint path), K9."""
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    lm = tuple(k for k in cuda_lm.launch_counts() if k in got)
    want = (cr.EVERY_PATH + lm + (("image_bilinear_lk",) if direct else ())
            + (("knot_prior",) if prior else ()))
    return [k for k in want if got.get(k, 0) == 0]


@contextlib.contextmanager
def lm_probe(plain: bool = False):
    """Inside the block every optimize_level call of the tracker is probed:
    its LM iterations are appended to ``probe["iterations"]`` in the order
    of the calls, and the host reads made during it (Tensor.item and
    Tensor.__bool__) added to ``probe["reads"]``; ``probe["prior"]`` counts
    the knot prior's evaluations the levels make (K9's launches on the
    card: one at a level's start and one an iteration, where the prior is
    on). With ``plain`` the LM's stages (K6-K9) run their plain versions on
    the card's tensors: the plain-stage tracker that the kernels are held
    to."""
    import torch
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.solver import lm
    from mba_vo_tpu_torch.tracker import blur_tracker as bt

    probe = {"iterations": [], "reads": 0, "prior": 0}
    item, boolean = torch.Tensor.item, torch.Tensor.__bool__
    original = bt.optimize_level
    stages = rk.LM_STAGES
    saved = {k: getattr(lm, k) for k in stages}

    def counted(fn):
        def call(self, *args):
            probe["reads"] += 1
            return fn(self, *args)
        return call

    def optimize_level(*args, **kw):
        torch.Tensor.item, torch.Tensor.__bool__ = counted(item), counted(boolean)
        try:
            knots, summary = original(*args, **kw)
        finally:
            torch.Tensor.item, torch.Tensor.__bool__ = item, boolean
        probe["iterations"].append(summary.num_iterations)
        if lm._prior_on(args[0], args[4]):
            probe["prior"] += 1 + summary.num_iterations
        return knots, summary

    bt.optimize_level = optimize_level
    if plain:
        for k in stages:
            setattr(lm, k, rk.lm_plain_fn(k))
    try:
        yield probe
    finally:
        bt.optimize_level = original
        for k, fn in saved.items():
            setattr(lm, k, fn)


def hold_lm_calls(recorded: dict) -> dict:
    """K6-K9 against their plain versions on every recorded call, K6 and K7
    in both designs (``residual_kernels.hold_lm``: a difference past the
    bounds raises; K6's step bit for bit against its order of operations
    transcribed, ``lm_step_kernel_order``, its block design bit for bit
    against its shuffle design, K6's refined step within kappa_2 u and the
    library's within 3 D kappa_2 u of a float64 solve, where that bound is
    under 1); prints each kernel's largest differences
    and the branches the calls took, and returns by kernel the largest
    (absolute, relative) difference: K6's step against the plain stage's
    library solve (relative to its norm; a figure, not a check), K7's mu
    and sigma, K8's state (bit for bit: 0), K9's cost, g and H (relative to
    each output's magnitude; within rk.PRIOR_TOLERANCE, where a
    transcendental rounds otherwise than torch's); under "forward" K6's
    forward errors (the largest of each step's, each step's calls checked
    under a bound below 1 and its largest ratio to that bound, the calls
    where K6's step is the nearer, the calls compared, kappa_2's range);
    under "prior bits" K9's calls held, those equal bit for bit and the
    largest difference in ulps."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    worst = {"prior bits": {"calls": 0, "bit_equal": 0, "ulps": 0.0}}
    fwd = {"kernel": 0.0, "library": 0.0, "share_kernel": 0.0, "share_library": 0.0,
           "checked_kernel": 0, "checked_library": 0, "nearer": 0, "calls": 0,
           "kappa": [math.inf, 0.0]}
    for label, by_kernel in recorded.items():
        for kernel, calls in by_kernel.items():
            check(len(calls) > 0, f"{label}: no {kernel} call was recorded")
            got = [rk.hold_lm(c) for c in calls]
            a = max(g["abs"] for g in got)
            r = max(max(g.get(k, 0.0) for k in ("step", "mu", "sigma", "prior")) for g in got)
            old = worst.get(kernel, (0.0, 0.0))
            worst[kernel] = (max(old[0], a), max(old[1], r))
            if kernel == rk.PRIOR:
                pb = worst["prior bits"]
                pb.update(calls=pb["calls"] + len(got),
                          bit_equal=pb["bit_equal"] + int(sum(g["bits"] for g in got)),
                          ulps=max(pb["ulps"], max(g["ulps"] for g in got)))
            dt = str(calls[0].dtype).split(".")[-1]
            what = {"lm_step": f"{int(sum(g.get('invalid', 0) for g in got))} invalid (the plain "
                               f"stage's: {int(sum(g.get('plain_invalid', 0) for g in got))}); "
                               f"step and model change equal to K6's order transcribed bit "
                               f"for bit in both designs, the library solve's step within "
                               f"{r:.3e} of its norm (a figure); the candidate equal to the "
                               f"retraction of the kernel's step bit for bit",
                    "lm_decide": f"{int(sum(g.get('success', 0) for g in got))} successes; flags, "
                                 f"decrease and mask equal in both designs, mu and sigma "
                                 f"within {r:.3e}",
                    "lm_commit": "the next state equal bit for bit in both designs, the staged "
                                 "one through lm_commit_cuda and through a "
                                 "CommitBinding",
                    rk.PRIOR: f"cost, g and H equal to the plain version bit for bit on "
                              f"{int(sum(g.get('bits', 0) for g in got))}, within {r:.3e} of "
                              f"each output's magnitude on all (worst "
                              f"{max(g.get('ulps', 0.0) for g in got):.1f} ulps)"}[kernel]
            bound = (f" (bound {rk.LM_TOLERANCE[calls[0].dtype]:.0e})"
                     if kernel == "lm_decide" else
                     f" (bound {rk.PRIOR_TOLERANCE[calls[0].dtype]:.0e})"
                     if kernel == rk.PRIOR else "")
            print(f"  {label}: {kernel}, {len(calls)} recorded calls ({dt}, 6K = "
                  f"{sorted({c.D for c in calls})}): {what}{bound}")
            if kernel != "lm_step":
                continue
            held = [g for g in got if math.isfinite(g["fwd_kernel"])]
            if not held:
                continue
            fk = [g["fwd_kernel"] for g in held]
            fl = [g["fwd_library"] for g in held]
            nearer = sum(g["fwd_kernel"] <= g["fwd_library"] for g in held)
            kap = [g["kappa"] for g in held]
            # each step's checked calls (its bound under 1) and its largest
            # share of that bound
            checked, share = {}, {}
            for name in ("kernel", "library"):
                on = [g for g in held if g[f"fwd_checked_{name}"]]
                checked[name] = len(on)
                share[name] = max((g[f"fwd_{name}"] / g[f"fwd_bound_{name}"] for g in on),
                                  default=0.0)
            print(f"    forward error against a float64 solve of the same H1 and g, "
                  f"||step - x64|| / ||x64|| on {len(held)} calls: K6 max "
                  f"{max(fk):.3e} (median {statistics.median(fk):.3e}), the library's max "
                  f"{max(fl):.3e} (median {statistics.median(fl):.3e}); K6's the nearer on "
                  f"{nearer}; kappa_2(H1) {min(kap):.3e}-{max(kap):.3e}; K6's refined step "
                  f"within kappa_2 u on {checked['kernel']} calls (at most "
                  f"{share['kernel']:.3e} of it), unchecked on "
                  f"{len(held) - checked['kernel']} (kappa_2 u >= 1); the library's within "
                  f"3 D kappa_2 u on {checked['library']} (at most {share['library']:.3e} of "
                  f"it), unchecked on {len(held) - checked['library']} (3 D kappa_2 u >= 1)")
            fwd.update(kernel=max(fwd["kernel"], max(fk)), library=max(fwd["library"], max(fl)),
                       share_kernel=max(fwd["share_kernel"], share["kernel"]),
                       share_library=max(fwd["share_library"], share["library"]),
                       checked_kernel=fwd["checked_kernel"] + checked["kernel"],
                       checked_library=fwd["checked_library"] + checked["library"],
                       nearer=fwd["nearer"] + nearer, calls=fwd["calls"] + len(held),
                       kappa=[min(fwd["kappa"][0], min(kap)), max(fwd["kappa"][1], max(kap))])
    worst["forward"] = fwd
    return worst


def check_plain_stage_iterations(label: str, probe: dict, plain: dict):
    """The kernels' LM iterations against the plain-stage tracker's, level
    by level, and one host read an iteration."""
    its, its_p = probe["iterations"], plain["iterations"]
    print(f"    {label}: LM iterations a level on K6-K8 {its[:12]}"
          f"{' ...' if len(its) > 12 else ''} (total {sum(its)}), the plain-stage tracker's "
          f"{'equal' if its == its_p else its_p}; host reads {probe['reads']} = "
          f"{probe['reads'] / max(sum(its), 1):.2f} an iteration (plain stages "
          f"{plain['reads'] / max(sum(its_p), 1):.2f})")
    check(its == its_p, f"{label}: LM iterations differ from the plain-stage tracker's")
    check(probe["reads"] == sum(its), f"{label}: {probe['reads']} host reads over "
                                      f"{sum(its)} LM iterations")


def sharded_residual_launches(path: str, per_rank: list) -> dict:
    """K2's, K3's and K5's launches of a path's ranks, each rank's read as
    :func:`note_residual_launches` reads them: kept under ``path`` summed
    over the ranks, returned by kernel per rank; fails where a rank never
    launched one."""
    got = {k: [r[k] for r in per_rank] for k in per_rank[0]}
    check(not any(skipped(r) for r in per_rank),
          f"{path}: a rank never launched K2, K3 or K5: {got}")
    RESIDUAL_LAUNCHES[path] = {k: sum(ns) for k, ns in got.items()}
    return got


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


def record_tracker_calls(img, traj, frames):
    """The sampler's inputs as the tracker gives them on the bench scenario
    in f32: "tracker S=40", the calls of 16 frames of track_frame from rest
    (bench.py's options); "tracker S=160", those of one chunk of
    track_frames_joint(chunk=4) from a moving window (the bootstrap frame's
    S = 40 calls left out). And K2's and K3's inputs, by kernel: "tracker
    S=40", the same 16 frames; "joint degree 4", one chunk of
    track_frames_joint(chunk=4) at degree 4 (6K = 42) from a moving window,
    its calls over the chunk's 4 frames; "direct f32", 4 frames of
    track_frame with sampling="direct" (K4's and K5's calls, and K2's and
    K3's there). The layout K5 is recorded on every path, K4 on the direct
    one. The LM's stages K6-K8 are recorded on the same three runs, and the
    knot prior K9 on the joint chunk's (K = 7), the one run where it is on.
    Returns (sampler calls, K2-K5 calls, K6-K9 calls)."""
    from mba_vo_tpu_torch.experiments import kernel_variants as kv
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    with (kv.record_sampler_calls() as per_frame, rk.record_residual_calls() as rows,
          rk.record_lm_calls() as lm_frame):
        run_tracker(bench_config("float32"), "cuda", img, frames)
    with kv.record_sampler_calls() as joint:
        run_batch(bench_config("float32"), "cuda", img, frames[:JCHUNK],
                  method="track_frames_joint", chunk=JCHUNK, inflight=3,
                  window=moving_window(traj, frames, JCHUNK, DEG))
    with rk.record_residual_calls() as joint_rows, rk.record_lm_calls() as lm_joint:
        run_batch(bench_config("float32", spline_degree=4), "cuda", img, frames[:JCHUNK],
                  method="track_frames_joint", chunk=JCHUNK, inflight=3,
                  window=moving_window(traj, frames, JCHUNK, 4))
    with rk.record_residual_calls() as direct_rows, rk.record_lm_calls() as lm_direct:
        run_tracker(bench_config("float32", sampling="direct"), "cuda", img,
                    frames[:CPU_FRAMES])
    s_joint = JCHUNK * S_MAIN
    sampler = {"tracker S=40": [c for c in per_frame if c.S == S_MAIN],
               f"tracker S={s_joint}": [c for c in joint if c.S == s_joint]}
    residual = {"tracker S=40": windowed(rows),
                "joint degree 4": {k: [c for c in calls if c.frames == JCHUNK]
                                   for k, calls in windowed(joint_rows).items()},
                "direct f32": direct_rows}
    lm = {"tracker S=40": lm_frame, "joint degree 4": lm_joint, "direct f32": lm_direct}
    return sampler, residual, {label: prior_calls(label, calls, label == "joint degree 4")
                               for label, calls in lm.items()}


def prior_calls(label: str, calls: dict, joint: bool) -> dict:
    """A run's recorded LM calls (``rk.record_lm_calls``) with K9's list
    dropped where the knot prior is off: it must be empty there, and not
    empty on a joint run."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    check(bool(calls[rk.PRIOR]) == joint,
          f"{label}: {len(calls[rk.PRIOR])} calls of the knot prior recorded")
    return calls if joint else {k: v for k, v in calls.items() if k != rk.PRIOR}


def windowed(calls: dict) -> dict:
    """A windowed path's recorded residual-stage calls without K4's, of
    which there must be none (K4 is the direct path's sampler)."""
    check(not calls.pop("image_bilinear_lk"), "a windowed path called K4")
    return calls


@contextlib.contextmanager
def plain_stages(names):
    """The tracker's calls of each dispatcher of ops.residual in ``names``
    go to its plain version (on the card's tensors) inside the block."""
    from mba_vo_tpu_torch.ops import residual

    saved = {k: getattr(residual, k) for k in names}
    for k in names:
        setattr(residual, k, getattr(residual, f"{k}_plain"))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(residual, k, fn)


@contextlib.contextmanager
def counting_evaluations():
    """Count the LM evaluations made inside the block: calls of either
    path's residual function, which compute_rjv looks up in ops.residual;
    yields a one-element list holding the count."""
    from mba_vo_tpu_torch.ops import residual

    names = ("compute_residuals_windowed", "compute_residuals")
    saved = {k: getattr(residual, k) for k in names}
    count = [0]

    def counting(fn):
        def call(*args, **kw):
            count[0] += 1
            return fn(*args, **kw)
        return call

    for k in names:
        setattr(residual, k, counting(saved[k]))
    try:
        yield count
    finally:
        for k, fn in saved.items():
            setattr(residual, k, fn)


def launches_an_evaluation(cfg, img, frames, plain=()) -> tuple:
    """(kernel launches, LM evaluations, :func:`lm_probe`'s probe) of
    tracking ``frames`` from rest with ``cfg`` under torch.profiler
    (run_tracker: the keyframe included), the dispatchers named in ``plain``
    sent to their plain versions."""
    with plain_stages(plain), counting_evaluations() as evals, lm_probe() as probe:
        total = kernel_launches(lambda: run_tracker(cfg, "cuda", img, frames))
    return total, evals[0], probe


def launches_an_iteration(cfg, img, frames, run=None) -> float:
    """Kernel launches of one LM iteration alone (``solver.lm.lm_iteration``:
    K6, the evaluation, K3 twice, K9 where the prior is on, K7, K8 and
    whatever torch ops remain), each iteration of tracking ``frames`` from
    rest (or of ``run()``) counted under torch.profiler on its own; the
    mean."""
    import torch
    from mba_vo_tpu_torch.solver import lm

    original, counts = lm.lm_iteration, []

    def counted(*args):
        out = []
        counts.append(kernel_launches(lambda: out.append(original(*args))))
        return out[0]

    lm.lm_iteration = counted
    try:
        if run is None:
            run_tracker(cfg, "cuda", img, frames)
        else:
            run()
    finally:
        lm.lm_iteration = original
    torch.cuda.synchronize()
    return sum(counts) / max(len(counts), 1)


def hold_residual_calls(recorded: dict) -> dict:
    """K2's two entries and K3 against their plain versions on every
    recorded call, warp_tangents against the old path to the same
    tolerances (vs equal), and blur_rows and K3 against their earlier
    designs bit for bit, K4 and K5 against their plain versions bit for bit
    (a difference raises), and, on a direct path's recording, the direct
    path on the kernels against its plain chain at every recorded layout
    call's knots (rk.hold_direct: r and J within K2's tolerances, valid
    equal); prints each kernel's largest differences and returns them by
    kernel (and "direct path") as (absolute, relative to the output's
    magnitude)."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    worst = {}

    def keep(name, err):
        a, r = worst.get(name, (0.0, 0.0))
        worst[name] = (max(a, err[0]), max(r, err[1]))

    for label, by_kernel in recorded.items():
        for kernel, calls in by_kernel.items():
            check(len(calls) > 0, f"{label}: no {kernel} call was recorded")
            errs = [rk.hold(c) for c in calls]
            equal = sum(rk.hold_earlier(c) for c in calls)
            err = (max(e[0] for e in errs), max(e[1] for e in errs))
            keep(kernel, err)
            bits = kernel in rk.BIT_EQUAL_PLAIN
            print(f"  {label}: {kernel}, {len(calls)} recorded calls ("
                  f"{str(calls[0].dtype).split('.')[-1]}, 6K = "
                  f"{sorted({c.tangents for c in calls})}, levels "
                  f"{sorted({c.level for c in calls}, key=str)}): "
                  + ("equal to the plain version bit for bit on every call" if bits else
                     f"max |kernel - plain| {err[0]:.3e}, {err[1]:.3e} of the output's "
                     f"magnitude (bound {rk.TOLERANCE[kernel, calls[0].dtype]:.0e})")
                  + (f"; equal to the earlier design bit for bit on all {equal}"
                     if kernel in rk.BIT_EQUAL else
                     f"; the old path (torch chain, then the thread design) held to the "
                     f"same bound, vs equal, on all {equal}" if kernel in rk.EARLIER else ""))
        if by_kernel.get("image_bilinear_lk"):
            layouts = by_kernel["prepare_frame_layout"]
            errs = [rk.hold_direct(*c.args) for c in layouts]
            keep("direct path", (0.0, max(max(e) for e in errs)))
            print(f"  {label}: the direct path on the kernels against its plain chain at "
                  f"each of the {len(layouts)} layout calls' knots: r within "
                  f"{max(e[0] for e in errs):.3e}, J within {max(e[1] for e in errs):.3e} of "
                  f"the magnitude (bound {rk.TOLERANCE['blur_rows', layouts[0].dtype]:.0e}), "
                  f"valid equal")
    return worst


# ------------------------------------------------------------- phases 4-5


def smooth_texture(h, w, seed):
    """A uniform random texture box-filtered twice along each axis."""
    from mba_vo_tpu_torch.data.synthetic import _box_filter_1d

    img = np.random.default_rng(seed).uniform(0, 255, (h, w))
    for _ in range(2):
        img = _box_filter_1d(img, 2, 0)
        img = _box_filter_1d(img, 2, 1)
    return img


def bench_knots(device, n_knots, knot_noise_seed=None):
    """The bench scenario's generating spline (float64): constant velocity,
    knots FRAME_DT apart from the identity at t = 0; with
    `knot_noise_seed`, every knot perturbed as tests/test_tracker.py's
    world_spline perturbs it."""
    import torch
    from mba_vo_tpu_torch.core import lie
    from mba_vo_tpu_torch.core.spline import make_knots

    rng = None if knot_noise_seed is None else np.random.default_rng(knot_noise_seed)
    vel_t = np.array([0.06, -0.04, 0.02])
    vel_w = np.array([0.02, 0.05, -0.08])
    kt, kq = [np.zeros(3)], [torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)]
    for _ in range(1, n_knots):
        dt, dw = vel_t * FRAME_DT, vel_w * FRAME_DT
        if rng is not None:
            dt = dt + rng.normal(0, 3e-4, 3)
            dw = dw + rng.normal(0, 5e-4, 3)
        kt.append(kt[-1] + dt)
        q = lie.quat_multiply(kq[-1], lie.quat_exp(torch.tensor(dw, dtype=torch.float64)))
        kq.append(q / torch.linalg.norm(q))
    return make_knots(torch.tensor(np.array(kt), dtype=torch.float64, device=device),
                      torch.stack(kq).to(device), 0.0, FRAME_DT)


def make_scenario(device, n_frames, h=H, w=W, kvec=KVEC, texture_seed=0,
                  knot_noise_seed=None, samples=5):
    """A smoothed random texture on a plane at 2 m seen along a generating
    spline, and blurred frames rendered in f64 with `samples` exposure
    samples by the port's own forward model.

    The defaults are the bench.py scenario: a constant-velocity spline. With
    `knot_noise_seed`, every knot is perturbed as tests/test_tracker.py's
    world_spline perturbs it (the scenario of tests/test_precision.py)."""
    import torch
    from mba_vo_tpu_torch.data.synthetic import synthesize_blurred_image

    img = smooth_texture(h, w, texture_seed)
    f64 = dict(dtype=torch.float64, device=device)
    traj = bench_knots(device, n_frames + 4, knot_noise_seed)
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


# ------------------------------------------------------------------ phase 8

LOOP_REFERENCE = "LOOP_r05.json"     # bench_loop.py's JAX-on-CPU figures


def median_ms(fn, reps=5) -> float:
    """Median wall ms of fn() between device synchronisations (one warm-up
    call first)."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(out)


def ba_problem_arrays(W=7, M=512, live=300, seed=0):
    """8a's BA window (experiments/ba_kernels.py's window_arrays): W cameras
    over M landmark slots, `live` of them observed."""
    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    return bk.window_arrays(W, M, live, seed)


def pose_graph_arrays(n=64, seed=1):
    """A drifted chain of n keyframes with noisy consecutive edges and two
    loop edges of weight 5."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    i = np.concatenate([np.arange(n - 1), [0, 5]])
    j = np.concatenate([np.arange(1, n), [n - 1, n - 2]])
    t_ij = t[j] - t[i] + rng.normal(0, 0.01, (len(i), 3))
    w = np.concatenate([np.ones(n - 1), [5.0, 5.0]])
    return (t, q), (i, j, t_ij, np.tile(q[:1], (len(i), 1)), w)


# K10-K12 held against their plain versions, by the label of the run whose
# BA iterations were recorded (experiments/ba_kernels.py's hold_ba_calls)
BA_HELD: dict = {}
BA_KERNELS = ("ba_build", "ba_step", "ba_commit")
# K10-K12's launches by path, each checked against the path's BA iterations
BA_LAUNCHES: dict = {}
# the earlier ticket designs of K10-K12 held against the launched ones, by
# the label of the recorded run (experiments/ba_kernels.py's
# hold_designs_calls), and each design's phase split by (label, kernel,
# method)
BA_DESIGNS_HELD: dict = {}
BA_SPLIT: dict = {}


def hold_ba_recorded(label: str, calls: list) -> dict:
    """K10-K12 against their plain versions on every recorded BA iteration
    of a run (float64: 1e-12 of each output's magnitude, K10's sums of
    the magnitude of their terms; K11 within what roundoff in its sums can
    move its outputs by where that is larger, NaN steps where S is
    indefinite beyond its roundoff, unchecked and counted where S's
    definiteness is within it; K12's decisions equal,
    a flip at a knife edge failing the run too), and the replay equal to
    the run bit for bit; printed and kept in BA_HELD."""
    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    check(len(calls) > 0, f"{label}: no BA iteration was recorded")
    t0 = time.perf_counter()
    got = bk.hold_ba_calls(calls)
    w, n = got["worst"], got["iterations"]
    c = calls[0]
    print(f"    {label}: K10-K12 against their plain versions on all {n} recorded iterations "
          f"({str(c.dtype).split('.')[-1]}, W {c.W}, M {c.M}, {len({x.run for x in calls})} "
          f"BA runs; {got['accepted']} steps accepted, {got['done']} ending a loop, "
          f"{got['nan_steps']} NaN steps): K10 within {w['ba_build']:.3e} and K12 within "
          f"{w['ba_commit']:.3e} of each output's magnitude (bound "
          f"{bk.TOLERANCE[c.dtype]:.0e}); K11 within that bound on {got['step_within']}, "
          f"within what roundoff in its sums can move it by (ba_kernels.step_bounds; at "
          f"most {got['step_share']:.3e} of it) on {got['step_checked'] - got['step_within']} "
          f"where S's definiteness is beyond its roundoff ("
          + (f"kappa_2(S) {got['kappa'][0]:.3e}-{got['kappa'][1]:.3e}, the V blocks' up to "
             f"{got['kappa_V']:.3e}" if got["kappa"][1] > 0 else "none computed")
          + f"), unchecked on "
          f"{n - got['step_checked']}, largest difference {w['ba_step']:.3e} of its "
          f"magnitude; ok and done equal on "
          f"{n - len(got['flips'])}, flipped at a knife edge on {len(got['flips'])}; the replay "
          f"equal to the run bit for bit on {got['replayed_equal']} of {got['transitions']} "
          f"transitions; {time.perf_counter() - t0:.1f} s")
    for flip in got["flips"]:
        print(f"      knife edge: {flip}")
    check(got["replayed_equal"] == got["transitions"], f"{label}: a replay differs from the run")
    check(not got["flips"], f"{label}: K12's decisions differ from the plain version's")
    BA_HELD[label] = got
    return got


def check_ba_launches(path: str, iterations: int) -> dict:
    """K10-K12's launches on ``path`` (RESIDUAL_LAUNCHES) against its BA
    iterations: one of each an iteration."""
    got = {k: RESIDUAL_LAUNCHES[path].get(k, 0) for k in BA_KERNELS}
    check(all(n == iterations for n in got.values()),
          f"{path}: K10-K12 launched {got} times in {iterations} BA iterations")
    BA_LAUNCHES[path] = got
    return got


@contextlib.contextmanager
def host_reads():
    """Counts the host reads (Tensor.item and Tensor.__bool__) made inside
    the block into ``reads["n"]``."""
    import torch

    reads = {"n": 0}
    item, boolean = torch.Tensor.item, torch.Tensor.__bool__

    def counted(fn):
        def call(self, *args):
            reads["n"] += 1
            return fn(self, *args)
        return call

    torch.Tensor.item, torch.Tensor.__bool__ = counted(item), counted(boolean)
    try:
        yield reads
    finally:
        torch.Tensor.item, torch.Tensor.__bool__ = item, boolean


def phase_backend_solvers(img, other):
    """8a: the backend's device work, float64 on CUDA against the CPU at
    full width, and its times on the card. Returns a dict of results."""
    import torch
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.backend import ba, geometry, pose_graph
    from mba_vo_tpu_torch.backend.vo_backend import BackendConfig
    from mba_vo_tpu_torch.core.transform import Pose
    from mba_vo_tpu_torch.experiments import ba_kernels as bk
    from mba_vo_tpu_torch.ops import cuda_ba
    from mba_vo_tpu_torch.tracker.sparse_features import detect_sparse, match_descriptors

    det = BackendConfig().detector
    res = {}
    for dtype in (torch.float64, torch.float32):
        name = str(dtype).split(".")[-1]
        feats = {}
        for dev in ("cuda", "cpu"):
            feats[dev] = [detect_sparse(torch.tensor(x, dtype=dtype, device=dev), det)
                          for x in (img, other)]
        bits = sum(int((a.descriptors.cpu() != b.descriptors).sum())
                   for a, b in zip(feats["cuda"], feats["cpu"]))
        kp = max(float((a.kp_xy.cpu() - b.kp_xy).abs().max())
                 for a, b in zip(feats["cuda"], feats["cpu"]))
        masks = all(torch.equal(a.mask.cpu(), b.mask) for a, b in zip(feats["cuda"], feats["cpu"]))
        mc, _ = match_descriptors(*feats["cuda"], 96.0, 0.85)
        mh, _ = match_descriptors(*feats["cpu"], 96.0, 0.85)
        n_live = int(feats["cpu"][0].mask.sum())
        res[name] = dict(desc_bits_differ=bits, kp_max_diff=kp, masks_equal=masks,
                         matches_differ=int((mc.cpu() != mh).sum()),
                         matches=int((mh >= 0).sum()), keypoints=n_live)
        print(f"[8a] detect_sparse + match_descriptors, {name}, VGA, BackendConfig's "
              f"detector: {n_live} corners, {res[name]['matches']} matches; CUDA against "
              f"CPU: descriptor bits differing {bits} (of {2 * 256 * det.max_keypoints}), "
              f"max |kp| {kp:.3e} px, masks equal {masks}, matches differing "
              f"{res[name]['matches_differ']}")
        check(masks and res[name]["matches_differ"] == 0 and bits == 0,
              f"{name} detection on CUDA differs from the CPU")
        check(kp <= (1e-9 if dtype == torch.float64 else 0.0), f"{name} keypoints differ by {kp}")
    f32 = [torch.tensor(x, dtype=torch.float32, device="cuda") for x in (img, other)]
    res["detect_ms"] = median_ms(lambda: detect_sparse(f32[0], det))
    fa, fb = (detect_sparse(x, det) for x in f32)
    res["match_ms"] = median_ms(lambda: match_descriptors(fa, fb, 96.0, 0.85))

    a = ba_problem_arrays()
    cuda_ba.zero_launch_counts()
    with bk.record_ba_calls() as calls, host_reads() as reads:
        rc, sc = ba.run_bundle_adjustment(interop.ba_problem_from_arrays(**a, device="cuda"),
                                          ba.BAOptions())
    counts = cuda_ba.launch_counts()
    # the BA's ticket designs only: the LM's counts are not zeroed here
    EARLIER_LAUNCHES["run_bundle_adjustment, f64, window 7 (8a)"] = (
        cuda_ba.earlier_launch_counts())
    rh, sh = ba.run_bundle_adjustment(interop.ba_problem_from_arrays(**a, device="cpu"),
                                      ba.BAOptions())
    dpose = float((rc.poses.t.cpu() - rh.poses.t).abs().max())
    dpts = float((rc.map.points.cpu() - rh.map.points).abs().max())
    prob = interop.ba_problem_from_arrays(**a, device="cuda")
    # the kernels and the plain stages on the card, timed in turn
    res["ba_ms"] = median_ms(lambda: ba.run_bundle_adjustment(prob, ba.BAOptions()), reps=3)
    res["ba_plain_ms"] = median_ms(lambda: ba.run_plain_stages(prob, ba.BAOptions()), reps=3)
    res["ba_ms_again"] = median_ms(lambda: ba.run_bundle_adjustment(prob, ba.BAOptions()), reps=3)
    res["ba_plain_ms_again"] = median_ms(lambda: ba.run_plain_stages(prob, ba.BAOptions()),
                                         reps=3)
    res["ba_iterations"] = (sc.num_iterations, sh.num_iterations)
    res["ba_launches"], res["ba_calls"] = counts, calls
    n = sc.num_iterations
    print(f"[8a] run_bundle_adjustment, f64, window 7, 512 landmark slots (300 live), on "
          f"K10-K12: iterations CUDA {n} / CPU {sh.num_iterations}; max |pose CUDA - "
          f"CPU| {dpose:.3e}, points {dpts:.3e} (bound 1e-8); launches {counts}, host reads "
          f"{reads['n']}; {res['ba_ms']:.2f} / {res['ba_ms_again']:.2f} ms on the card "
          f"({res['ba_ms'] / max(n, 1):.3f} ms an iteration) against the plain stages on the "
          f"card {res['ba_plain_ms']:.2f} / {res['ba_plain_ms_again']:.2f} ms, timed in turn")
    check(sc.num_iterations == sh.num_iterations, "BA iteration counts differ")
    check(dpose <= 1e-8 and dpts <= 1e-8, f"BA CUDA and CPU differ by {dpose}, {dpts}")
    check(all(v == n for v in counts.values()), f"K10-K12 launched {counts} in {n} iterations")
    check(reads["n"] == n, f"{reads['n']} host reads in {n} BA iterations")
    BA_LAUNCHES["run_bundle_adjustment, f64, window 7 (8a)"] = counts
    hold_ba_recorded("8a run_bundle_adjustment", calls)

    (t, q), e = pose_graph_arrays()
    outs = []
    for d in ("cuda", "cpu"):
        f = lambda x: torch.tensor(x, dtype=torch.float64, device=d)  # noqa: E731
        edges = interop.pose_graph_edges_from_arrays(*e, device=d)
        outs.append(pose_graph.optimize_pose_graph_counted(Pose(f(t), f(q)), edges))
    dpg = float((outs[0][0].t.cpu() - outs[1][0].t).abs().max())
    edges = interop.pose_graph_edges_from_arrays(*e, device="cuda")
    start = Pose(torch.tensor(t, device="cuda"), torch.tensor(q, device="cuda"))
    res["pg_ms"] = median_ms(lambda: pose_graph.optimize_pose_graph(start, edges), reps=3)
    print(f"[8a] optimize_pose_graph, f64, 64 nodes, 65 edges: iterations CUDA {outs[0][2]} / "
          f"CPU {outs[1][2]}; max |pose CUDA - CPU| {dpg:.3e} (bound 1e-8); "
          f"{res['pg_ms']:.1f} ms on the card")
    check(outs[0][2] == outs[1][2] and dpg <= 1e-8, f"pose graph CUDA and CPU differ by {dpg}")

    pts = a["points"][:256] - np.array([0.3, 0.0, 0.0])
    obs = a["obs_xy"][2, :256]
    msk = np.ones(256)
    pnp = []
    for d in ("cuda", "cpu"):
        f = lambda x: torch.tensor(x, dtype=torch.float64, device=d)  # noqa: E731
        p, c = geometry.solve_pnp(f(pts), f(obs), f(msk), f(a["K"]),
                                  Pose(f([0.0, 0.0, 0.0]), f([0.0, 0.0, 0.0, 1.0])))
        pnp.append(torch.cat([p.t, p.q, c[None]]).cpu())
    dpnp = float((pnp[0] - pnp[1]).abs().max())
    fd = lambda x: torch.tensor(x, dtype=torch.float64, device="cuda")  # noqa: E731
    args = (fd(pts), fd(obs), fd(msk), fd(a["K"]), Pose(fd([0.0] * 3), fd([0.0, 0.0, 0.0, 1.0])))
    res["pnp_ms"] = median_ms(lambda: geometry.solve_pnp(*args))
    print(f"[8a] solve_pnp, f64, 256 correspondences, 30 iterations: max |CUDA - CPU| "
          f"{dpnp:.3e} (bound 1e-8); {res['pnp_ms']:.1f} ms on the card, no host read; "
          f"detect {res['detect_ms']:.1f} ms, match {res['match_ms']:.2f} ms (f32, VGA)")
    check(dpnp <= 1e-8, f"PnP CUDA and CPU differ by {dpnp}")
    return res


def run_cli(argv):
    """mba_vo_tpu_torch.cli.main(argv) with its per-frame lines captured;
    returns (wall seconds between device synchronisations, output)."""
    import torch
    from mba_vo_tpu_torch import cli

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli.main(argv)
    torch.cuda.synchronize()
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return time.perf_counter() - t0, out.getvalue()


def track_argv(seq, out, device, config, extra=()):
    intr = open(os.path.join(seq, "intrinsics.txt")).read().strip()
    return ["track", "--images", os.path.join(seq, "images"),
            "--sharp-images", os.path.join(seq, "sharp"),
            "--depths", os.path.join(seq, "depths"), "--dataset-type", "eth3d",
            "--times", os.path.join(seq, "times.txt"), "--intrinsics", intr,
            "--output", out, "--config", config, "--device", device, *extra]


CLI_TOL = 1e-8          # TUM files print 9 decimals
CLI_TAIL_TOL = 1e-6     # the last frames, after loop closures (PERF.md section 7)


def phase_cli_cuda_vs_cpu(root, cs, launches):
    """8b: `cli track --backend ba+pg` (float64 config) on a small loop
    sequence, --device cuda against --device cpu: every keyframe's BA and
    pose-graph iterations, loop edges and landmarks equal; the TUM files
    equal to CLI_TOL until the roundoff that BA's ill-conditioned normal
    equations amplify reaches it (printed), and to CLI_TAIL_TOL over the
    whole run. The same run on the CPU with one thread (the CPU's own sums
    in another order) shows the amplification without a device change."""
    from mba_vo_tpu_torch.data import datasets as ds
    from mba_vo_tpu_torch.experiments import loop_bench as lb

    seq = os.path.join(root, "loop_small")
    run_cli(["synth", "--output", seq, "--num-frames", "24", "--height", "120", "--width",
             "160", "--num-samples", "7", "--trajectory", "loop", "--texture", "random",
             "--noise", "1.5", "--device", "cuda"])
    config, bconfig = os.path.join(seq, "config.json"), os.path.join(seq, "backend.json")
    with open(config, "w") as f:
        json.dump(lb.TRACKER_CONFIG, f)
    with open(bconfig, "w") as f:
        json.dump(lb.BACKEND_CONFIG, f)
    import torch

    out = {}
    threads = torch.get_num_threads()
    for run in ("cuda", "cpu", "cpu 1 thread"):
        dev = run.split()[0]
        zero_counts(cs)
        torch.set_num_threads(1 if run == "cpu 1 thread" else threads)
        try:
            wall, _ = run_cli(track_argv(seq, os.path.join(root, f"est_{len(run)}.txt"), dev,
                                         config, ["--backend", "ba+pg", "--backend-config",
                                                  bconfig, "--backend-stats",
                                                  os.path.join(root, f"stats_{len(run)}.json")]))
        finally:
            torch.set_num_threads(threads)
        if dev == "cuda":
            launches["cli track --backend ba+pg (8b)"] = cs.LAUNCHES
            note_residual_launches("cli track --backend ba+pg (8b)")
        with open(os.path.join(root, f"stats_{len(run)}.json")) as f:
            stats = json.load(f)
        _, t, q = ds.load_tum_trajectory(os.path.join(root, f"est_{len(run)}.txt"))
        out[run] = dict(wall=wall, poses=np.concatenate([t, q], 1), stats=stats)
    per_frame = np.abs(out["cuda"]["poses"] - out["cpu"]["poses"]).max(axis=1)
    over = np.flatnonzero(per_frame > CLI_TOL)
    fields = ("ba_iterations", "pg_iterations", "loop_edges", "landmarks")
    counts = [tuple(s[f] for f in fields) for s in out["cuda"]["stats"]]
    same = counts == [tuple(s[f] for f in fields) for s in out["cpu"]["stats"]]
    cost = max((abs(a["ba_cost"] - b["ba_cost"]) / abs(b["ba_cost"])
                for a, b in zip(out["cuda"]["stats"], out["cpu"]["stats"]) if "ba_cost" in b),
               default=0.0)
    print(f"[8b] cli track --backend ba+pg, f64 config, {len(per_frame)} frames of a 120x160 "
          f"loop: {len(counts)} keyframes, {counts[-1][3]} landmarks, "
          f"{sum(c[2] for c in counts)} loop edges, BA/PG iterations, loop edges and landmarks "
          f"equal at every keyframe on CUDA and CPU: {same}; max relative BA cost difference "
          f"{cost:.2e}; max |TUM CUDA - TUM CPU| {per_frame.max():.3e}, first frame over "
          f"{CLI_TOL:g}: {int(over[0]) if len(over) else None}; per frame " + " ".join(
              f"{d:.0e}" for d in per_frame))
    ba_its = sum(st["ba_iterations"] for st in out["cuda"]["stats"])
    k1012 = check_ba_launches("cli track --backend ba+pg (8b)", ba_its)
    print(f"    K10-K12 launches {k1012} in the CUDA run's {ba_its} BA iterations (one of each "
          f"an iteration)")
    threads_diff = np.abs(out["cpu"]["poses"] - out["cpu 1 thread"]["poses"]).max(axis=1)
    print(f"    the same run on the CPU with {threads} threads against 1 thread (another order "
          f"of the same sums): max |TUM| difference {threads_diff.max():.3e}; per frame " + " ".join(
              f"{d:.0e}" for d in threads_diff))
    print(f"    wall CUDA {out['cuda']['wall']:.1f} s, CPU {out['cpu']['wall']:.1f} s, CPU 1 thread "
          f"{out['cpu 1 thread']['wall']:.1f} s; K1 launches "
          f"{launches['cli track --backend ba+pg (8b)']}")
    check(np.isfinite(out["cuda"]["poses"]).all(), "non-finite CLI poses")
    check(same, "the backend's control flow differs between CUDA and the CPU")
    check(len(counts) >= 10 and sum(c[2] for c in counts) > 0, "no loop closure in 8b")
    check(per_frame.max() <= CLI_TAIL_TOL, f"cli track on CUDA and CPU differ by {per_frame.max()}")
    check(len(over) == 0 or over[0] >= len(per_frame) - 5,
          f"cli track on CUDA and CPU differ by more than {CLI_TOL} from frame {over[:1]}")
    return dict(per_frame=per_frame, counts=counts)


LOOP_PARTING_TOL = 1e-8
LOOP_LOST_FRAME = 57    # where both packages lose the loop's closing frames on the CPU


def phase_loop_benchmark(cs, launches, root):
    """8c: the loop benchmark at bench_loop.py's defaults on the card; then
    its tracker-only run again on the card's host CPU from the same files,
    and where the two f64 trajectories part."""
    from mba_vo_tpu_torch.data import datasets as ds
    from mba_vo_tpu_torch.experiments import loop_bench as lb
    from mba_vo_tpu_torch.ops import cuda_lm

    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    t0 = time.perf_counter()
    keep = os.path.join(root, "loop")
    cuda_lm.zero_launch_counts()
    with contextlib.redirect_stdout(io.StringIO()), bk.record_ba_calls() as ba_calls:
        summary = lb.run(device="cuda", keep=keep)
    EARLIER_LAUNCHES["loop benchmark (8c)"] = {
        **cuda_lm.earlier_launch_counts(),
        **{k: sum(r["k10_k12_ticket_launches"][k] for r in summary["runs"].values())
           for k in BA_KERNELS}}
    wall = time.perf_counter() - t0
    ref = None
    if os.path.exists(LOOP_REFERENCE):
        with open(LOOP_REFERENCE) as f:
            ref = json.load(f)
    for name, label in (("ba_pg", "ba+pg"), ("tracker_only", "tracker-only")):
        r = summary["runs"][name]
        path = f"loop benchmark {label} (8c)"
        launches[path] = r["k1_launches"]
        RESIDUAL_LAUNCHES[path] = {**r["k2_k3_launches"], **r["k10_k12_launches"]}
        check(not skipped(r["k2_k3_launches"]),
              f"{path} never launched K2, K3 or K5: {r['k2_k3_launches']}")
        check_ba_launches(path, r["backend"]["ba_iterations"] if name == "ba_pg" else 0)
    for name, r in summary["runs"].items():
        jr = ref["runs"][name] if ref else {}
        print(f"[8c] loop benchmark ({summary['num_frames']} frames, {summary['image']}, "
              f"noise {summary['noise_sigma']}), {name}: ATE full {r['ate_full_m']:.6f} m, final "
              f"quarter {r['ate_final_quarter_m']:.6f} m (JAX on CPU, {LOOP_REFERENCE}: "
              f"{jr.get('ate_full_m')} / {jr.get('ate_final_quarter_m')}); {r['wall_s']:.2f} s "
              f"= {r['frames_per_s']:.3f} frames/s; K1 launches {r['k1_launches']}, K2/K3 "
              f"{r['k2_k3_launches']}")
    b = summary["runs"]["ba_pg"]["backend"]
    print(f"    backend: {b['keyframes']} keyframes, {b['loop_edges']} loop edges in "
          f"{b['pose_graph_runs']} pose-graph runs; ms per keyframe by stage (each stage ended "
          f"by a synchronisation) " + ", ".join(f"{k} {v:.2f}" for k, v in
                                                b["ms_per_keyframe"].items())
          + f", total {b['ms_per_keyframe_total']:.2f}; BA iterations "
          f"{b['ba_iterations_per_keyframe']:.2f} and PG iterations "
          f"{b['pg_iterations_per_keyframe']:.2f} a keyframe; host reads "
          f"{b['host_reads_per_keyframe']:.2f} a keyframe")
    print(f"    K10-K12 launches {summary['runs']['ba_pg']['k10_k12_launches']} in the "
          f"ba+pg run's {b['ba_iterations']} BA iterations, 0 tracker-only")
    check(len(ba_calls) == b["ba_iterations"], f"{len(ba_calls)} BA iterations recorded of "
                                                 f"{b['ba_iterations']}")
    hold_ba_recorded("8c loop benchmark ba+pg", ba_calls)
    summary["ba_calls"] = ba_calls
    imp = summary["final_segment_improvement_frac"]
    print(f"    final-quarter improvement {imp:.3f} (JAX on CPU "
          f"{ref.get('final_segment_improvement_frac') if ref else None}; rule >= 0.5, "
          f"tests/test_loop_benchmark.py); synth {summary['synth_s']:.1f} s, phase {wall:.1f} s")
    check(imp >= 0.5, f"ba+pg cut the final-quarter ATE by only {imp}")

    # the tracker-only run on the CPU, from the card's files: the per-frame
    # TUM difference and the first frame over LOOP_PARTING_TOL
    seq = os.path.join(keep, "seq")
    cpu_out = os.path.join(keep, "est_tracker_only_cpu.txt")
    t0 = time.perf_counter()
    run_cli(track_argv(seq, cpu_out, "cpu", os.path.join(seq, "config.json"), ["--chunk", "1"]))
    cpu_s = time.perf_counter() - t0
    _, tc, qc = ds.load_tum_trajectory(os.path.join(keep, "est_tracker_only.txt"))
    _, th, qh = ds.load_tum_trajectory(cpu_out)
    per_frame = np.abs(np.concatenate([tc - th, qc - qh], 1)).max(axis=1)
    over = np.flatnonzero(per_frame > LOOP_PARTING_TOL)
    first = int(over[0]) if len(over) else None
    _, tg, _ = ds.load_tum_trajectory(os.path.join(seq, "groundtruth.txt"))
    err_c = np.linalg.norm(tc - tg[:len(tc)], axis=1)
    err_h = np.linalg.norm(th - tg[:len(th)], axis=1)
    print(f"[8c] tracker-only, f64, CUDA - CPU (the card's host, {cpu_s:.1f} s) on the same "
          f"files: max |TUM| difference {per_frame.max():.3e}; first frame over "
          f"{LOOP_PARTING_TOL:g}: {first} ("
          + ("none" if first is None else "before" if first < LOOP_LOST_FRAME else "not before")
          + f" frame {LOOP_LOST_FRAME}); ATE CUDA {np.sqrt(np.mean(err_c ** 2)):.6f} m, CPU "
          f"{np.sqrt(np.mean(err_h ** 2)):.6f} m")
    print("    per frame |CUDA - CPU|: " + " ".join(f"{d:.0e}" for d in per_frame))
    print("    per frame error CUDA / CPU, mm: " + " ".join(
        f"{1e3 * a:.2f}/{1e3 * b:.2f}" for a, b in zip(err_c, err_h)))
    check(len(tc) == len(th) and np.isfinite(th).all(), "the CPU loop run is incomplete")
    return summary


def phase_vga_cli(root, cs, launches):
    """8d: cli synth at its VGA default, cli track in f32 under bench options
    (TrackerConfig's keyframe thresholds) with --chunk 8, with and without
    --backend ba+pg at BackendConfig's defaults."""
    import dataclasses

    from mba_vo_tpu_torch.utils.config import tracker_config_to_dict

    seq = os.path.join(root, "vga")
    synth_s, _ = run_cli(["synth", "--output", seq, "--device", "cuda"])
    cfg = dataclasses.replace(bench_config("float32"), keyframe_max_flow_mag0=15.0,
                              keyframe_max_flow_mag1=30.0)
    config = os.path.join(seq, "config.json")
    with open(config, "w") as f:
        json.dump(tracker_config_to_dict(cfg), f)
    # a short untimed run first: the first pass through the command line
    # reads the sequence's files from disk
    run_cli(track_argv(seq, os.path.join(root, "vga_warm.txt"), "cuda", config,
                       ["--chunk", "8", "--max-frames", "9"]))
    res = {}
    for name, extra in (("tracker only", []), ("ba+pg", [
            "--backend", "ba+pg", "--backend-stats", os.path.join(root, "vga_stats.json")])):
        zero_counts(cs)
        wall, _ = run_cli(track_argv(seq, os.path.join(root, f"vga_{len(extra)}.txt"), "cuda",
                                     config, ["--chunk", "8", *extra]))
        launches[f"cli track VGA --chunk 8, {name} (8d)"] = cs.LAUNCHES
        note_residual_launches(f"cli track VGA --chunk 8, {name} (8d)")
        res[name] = dict(wall=wall, fps=21 / wall, launches=cs.LAUNCHES)
    with open(os.path.join(root, "vga_stats.json")) as f:
        stats = json.load(f)
    ba_its = sum(st["ba_iterations"] for st in stats)
    k1012 = check_ba_launches("cli track VGA --chunk 8, ba+pg (8d)", ba_its)
    check_ba_launches("cli track VGA --chunk 8, tracker only (8d)", 0)
    ms = sum(sum(s.get("ms", {}).values()) for s in stats) / max(len(stats), 1)
    print(f"[8d] cli synth VGA (21 frames, 31 samples) {synth_s:.1f} s; cli track f32, bench "
          f"options, --chunk 8: tracker only {res['tracker only']['fps']:.3f} frames/s, "
          f"--backend ba+pg {res['ba+pg']['fps']:.3f} frames/s ({len(stats)} keyframes, "
          f"{ms:.1f} ms of backend a keyframe); K1 launches "
          f"{res['tracker only']['launches']} / {res['ba+pg']['launches']}; K10-K12 launches "
          f"{k1012} in the f32 backend's {ba_its} BA iterations")
    check(all(r["launches"] > 0 for r in res.values()), "the VGA CLI never launched K1")
    return res


# ------------------------------------------------------------------ phase 9

DIST = (-0.12, 0.04, 0.001, -0.002)     # tests/test_cli_e2e.py's rad-tan coefficients
XI = 0.8                                # tests/test_image_camera.py's unified mirror
CLI_ATE_3D = 4e-2                       # tests/test_cli_e2e.py::test_synth_3d_scene_tracks
CLI_ATE_UNDISTORTED = 8e-3              # tests/test_cli_e2e.py's --distortion bound
SYNTH3D_FRAMES_CPU = 3


def vga_cameras(device, dtype):
    """(rad-tan pinhole, unified xi = 0.8, clean pinhole) at VGA, fx 480."""
    import torch
    from mba_vo_tpu_torch.models.camera import PinholeCamera, RadTanDistortion, UnifiedCamera

    f = dict(dtype=dtype, device=device)
    K = torch.tensor(KVEC, **f)
    dist = RadTanDistortion(*(torch.tensor(c, **f) for c in DIST))
    return (PinholeCamera(K=K, height=H, width=W, distortion=dist),
            UnifiedCamera(K=K, xi=torch.tensor(XI, **f), height=H, width=W),
            PinholeCamera(K=K, height=H, width=W))


def max_diff(a, b) -> float:
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def sampled_scene_depth():
    """The 3D scene's depth map at VGA from the identity (float32 on the
    CPU): a depth map with silhouettes to remap."""
    import torch
    from mba_vo_tpu_torch.data import scene3d

    scene = scene3d.default_scene(smooth_texture(H, W, 0), depth=DEPTH)
    f = dict(dtype=torch.float32)
    return scene3d.scene_depth_map(scene, torch.zeros(3, **f),
                                   torch.tensor([0.0, 0.0, 0.0, 1.0], **f),
                                   torch.tensor(KVEC, **f), H, W)


def phase_models(timer, frame):
    """9a: the models at VGA, CUDA against the CPU (float64 unless said)."""
    import torch
    from mba_vo_tpu_torch.backend import dynamic_points as dp
    from mba_vo_tpu_torch.core import lie
    from mba_vo_tpu_torch.core import navstate as nav
    from mba_vo_tpu_torch.models import sensors, trajectory
    from mba_vo_tpu_torch.ops.image import build_undistort_map, remap
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    f64, f32 = torch.float64, torch.float32
    # undistortion maps: f64 CUDA against the CPU, f32 CUDA against f64
    gpu64, cpu64, gpu32 = (vga_cameras("cuda", f64), vga_cameras("cpu", f64),
                           vga_cameras("cuda", f32))
    depth = sampled_scene_depth()
    for k, name in enumerate(("pinhole rad-tan", "unified xi=0.8")):
        with timer.stage(f"9a undistort map {name}", sync_on=gpu64[k].K):
            m64 = build_undistort_map(gpu64[k], gpu64[2])
            m32 = build_undistort_map(gpu32[k], gpu32[2])
        mc = build_undistort_map(cpu64[k], cpu64[2])
        d_dev, d_32 = max_diff(m64, mc), max_diff(m32, m64)
        ms64 = median_ms(lambda: build_undistort_map(gpu64[k], gpu64[2]))
        ms32 = median_ms(lambda: build_undistort_map(gpu32[k], gpu32[2]))
        # the command line's float32 remap of a bench frame, and of a depth
        # map through the rounded map (nearest neighbour)
        m32c = build_undistort_map(vga_cameras("cpu", f32)[k], vga_cameras("cpu", f32)[2])
        img = torch.tensor(frame, dtype=f32)
        r_dev = max_diff(remap(img.cuda(), m32), remap(img, m32c))
        ms_remap = median_ms(lambda: remap(img.cuda(), m32))
        nn_g, nn_c = remap(depth.cuda(), torch.round(m32)).cpu(), remap(depth, torch.round(m32c))
        n_depth = int((nn_g != nn_c).sum())
        n_map = int((m32.cpu() != m32c).any(dim=-1).sum())
        print(f"[9a] undistort map {name} (VGA): f64 |CUDA - CPU| {d_dev:.3e} px (bound 1e-10), "
              f"f32 CUDA - f64 {d_32:.3e} px; {ms64:.3f} ms f64 / {ms32:.3f} ms f32 a map; f32 map "
              f"entries CUDA != CPU {n_map} of {H * W}; remap of a bench frame (f32) |CUDA - CPU| "
              f"{r_dev:.3e}, {ms_remap:.3f} ms; depth pixels differing after the nearest-neighbour "
              f"remap {n_depth} of {H * W}")
        check(d_dev <= 1e-10, f"{name}: f64 map CUDA and CPU differ by {d_dev}")
        check(d_32 <= 1e-2, f"{name}: f32 map is {d_32} px off the f64 map")
        check(r_dev <= 1e-3, f"{name}: the f32 remap differs by {r_dev}")

    # profile_trace on the card: one map and one remap, a chrome trace with
    # the kernels in it (a trace of whole frames runs to tens of MiB)
    from mba_vo_tpu_torch.utils.profiling import profile_trace

    with tempfile.TemporaryDirectory() as log_dir:
        with profile_trace(log_dir):
            remap(img.cuda(), build_undistort_map(gpu32[0], gpu32[2]))
            torch.cuda.synchronize()
        path = os.path.join(log_dir, "trace.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        n_kernels = sum(e.get("cat") == "kernel" for e in events)
        # each kernel's start less its launch's on the host's clock (by the
        # correlation id): the device clock's offset shows as a lag below 0
        launched = {e["args"]["correlation"]: e["ts"] for e in events
                    if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
        lags = [e["ts"] - launched[e["args"]["correlation"]] for e in events
                if e.get("cat") == "kernel"
                and e.get("args", {}).get("correlation") in launched]
        print(f"[9a] profile_trace of one f32 map and remap: {os.path.getsize(path)} bytes, "
              f"{len(events)} events, {n_kernels} device kernels; kernel start less its "
              f"launch " + (f"{min(lags):.1f} to {max(lags):.1f} us" if lags else "not seen"))
        check(n_kernels > 0, "profile_trace recorded no device kernel")

    # IMU synthesis at 1 kHz over 2 s of the bench spline (degree 4, 24
    # knots), and strapdown re-integration as tests/test_sensors_navstate.py
    params = trajectory.ImuParams(*(torch.tensor(v, dtype=f64) for v in (
        9.81, [-0.003, 0.004, 0.002], [0.02, -0.01, 0.005])))
    times = np.arange(0.0, 2.0, 1e-3)
    out = {}
    for dev in ("cuda", "cpu"):
        knots = bench_knots(dev, 24)
        p = trajectory.ImuParams(*(v.to(dev) for v in params))
        trajectory.sample_imu_sequence(knots, torch.zeros(1, dtype=f64, device=dev), 4, p)
        with timer.stage(f"9a sample_imu_sequence {dev}", sync_on=knots.t):
            out[dev] = trajectory.sample_imu_sequence(
                knots, torch.tensor(times, dtype=f64, device=dev), 4, p)
    (pg, vg, gg, ag), (pc, vc, gc, ac) = out["cuda"], out["cpu"]
    d_imu = max(max_diff(a, b) for a, b in ((pg.t, pc.t), (pg.q, pc.q), (vg, vc), (gg, gc),
                                            (ag, ac)))
    knots = bench_knots("cuda", 24)
    p = trajectory.ImuParams(*(v.cuda() for v in params))
    h, t_start, t_end = 1e-3, 0.3, 1.1
    steps = np.arange(t_start, t_end, h)
    _, _, gyro, acc = trajectory.sample_imu_sequence(
        knots, torch.tensor(steps + 0.5 * h, dtype=f64, device="cuda"), 4, p)
    p0, v0, _ = trajectory.sample_pose_velocity(knots, t_start, 4)
    state = nav.NavState(pose=p0, velocity=v0, bias_acc=p.bias_acc, bias_gyro=p.bias_gyro)
    g_w = torch.tensor([0.0, 0.0, -9.81], dtype=f64, device="cuda")
    with timer.stage("9a propagate_imu (800 steps)", sync_on=state.velocity):
        for k in range(len(steps)):
            state = nav.propagate_imu(state, acc[k], gyro[k], h, g_w)
    p_end, v_end, _ = trajectory.sample_pose_velocity(knots, float(steps[-1]) + h, 4)
    e_t = float(torch.linalg.norm(state.pose.t - p_end.t))
    e_v = float(torch.linalg.norm(state.velocity - v_end))
    e_q = float(torch.linalg.norm(lie.quat_log(lie.quat_multiply(
        lie.quat_conjugate(state.pose.q), p_end.q))))
    print(f"[9a] sample_imu_sequence, {len(times)} samples (1 kHz, 2 s, degree 4): max |CUDA - "
          f"CPU| {d_imu:.3e} (bound 1e-10); propagate_imu over 0.8 s on CUDA: |dt| {e_t:.3e} m "
          f"(bound 2e-3), |dv| {e_v:.3e} m/s (5e-3), |dq| {e_q:.3e} rad (1e-3)")
    check(d_imu <= 1e-10, f"IMU synthesis CUDA and CPU differ by {d_imu}")
    check(e_t < 2e-3 and e_v < 5e-3 and e_q < 1e-3, "the IMU re-integration drifted")

    # scene-flow fit: M = 512 points, T = 8 frames on a curved path
    rng = np.random.default_rng(11)
    M, T = 512, 8
    X0 = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M), rng.uniform(3, 6, M)], -1)
    flow = rng.uniform(-0.4, 0.4, (M, 3))
    ftimes = np.arange(T) * 0.1
    cam_t = np.stack([[0.3 * np.sin(1.3 * i), 0.25 * np.cos(0.9 * i) - 0.25,
                       0.1 * np.sin(0.7 * i)] for i in range(T)])
    cam_q = lie.quat_exp(torch.tensor([[0.02 * np.sin(i), 0.03 * i, 0.01 * np.cos(i)]
                                       for i in range(T)], dtype=f64)).numpy()
    Kd = np.array([400.0, 400.0, 320.0, 240.0])
    R = lie.quat_to_matrix(torch.tensor(cam_q)).numpy()
    obs = np.zeros((T, M, 2))
    for i in range(T):
        Pc = (X0 + flow * ftimes[i] - cam_t[i]) @ R[i]
        obs[i] = np.stack([Pc[:, 0] / Pc[:, 2] * Kd[0] + Kd[2], Pc[:, 1] / Pc[:, 2] * Kd[1] + Kd[3]],
                          -1)
    start = (X0 + rng.normal(0, 0.05, X0.shape), flow + rng.normal(0, 0.05, flow.shape))
    fits, ms = {}, {}
    for dev in ("cuda", "cpu"):
        t = lambda a: torch.tensor(a, dtype=f64, device=dev)  # noqa: E731
        pts = dp.make_dynamic_points(t(start[0]), 0.0, flow=t(start[1]))
        args = (t(cam_t), t(cam_q), t(ftimes), t(obs), t(np.ones((T, M))), t(Kd))
        t0 = time.perf_counter()
        with timer.stage(f"9a fit_scene_flow {dev}", sync_on=pts.points):
            fits[dev] = dp.fit_scene_flow(pts, *args, iterations=10)
        ms[dev] = 1e3 * (time.perf_counter() - t0)
    d_fit = max(max_diff(fits["cuda"].points, fits["cpu"].points),
                max_diff(fits["cuda"].flow, fits["cpu"].flow))
    err = max_diff(fits["cuda"].points, torch.tensor(X0))
    print(f"[9a] fit_scene_flow M={M}, T={T}, 10 iterations, f64: max |CUDA - CPU| {d_fit:.3e} "
          f"(bound 1e-8); |X0 - truth| {err:.3e} m; {ms['cuda']:.1f} ms CUDA, {ms['cpu']:.1f} ms "
          "CPU")
    check(d_fit <= 1e-8, f"scene-flow fit CUDA and CPU differ by {d_fit}")
    check(err <= 1e-6, f"scene-flow fit missed the truth by {err}")

    # two VGA cameras in one frame: pyramids, gradients and detection
    opts = DetectorOptions(score_threshold=5.0, cell_h=30, cell_w=30, max_keypoints=N_KP)
    imgs = (frame, smooth_texture(H, W, 1))
    for dtype in (f64, f32):
        fr = {dev: sensors.MultiCameraFrame(0.1, EXPOSURE) for dev in ("cuda", "cpu")}
        res = {}
        for dev, mf in fr.items():
            with timer.stage(f"9a MultiCameraFrame {dev} {dtype}", sync_on=res):
                for cid, im in enumerate(imgs):
                    mf.add_image(cid, torch.tensor(im, dtype=dtype), device=dev)
                    mf.compute_pyramid(cid, 3)
                    mf.compute_grad_pyramid(cid)
                    res[(dev, cid)] = [mf.detect_features(cid, lv, opts) for lv in range(3)]
        # the gradient magnitude's sqrt: correctly rounded on the card, not
        # always on the CPU (PERF.md section 7), so responses may differ by
        # an ulp while the keypoints they select agree
        equal, moved, resp_off, resp_rel = True, 0, 0, 0.0
        for cid in range(2):
            for a, b in zip(fr["cuda"].grad_pyramid(cid), fr["cpu"].grad_pyramid(cid)):
                equal &= torch.equal(a.cpu(), b)
            for (xy_g, r_g, m_g), (xy_c, r_c, m_c) in zip(res[("cuda", cid)], res[("cpu", cid)]):
                moved += int((xy_g.cpu() != xy_c).any(dim=-1).sum() + (m_g.cpu() != m_c).sum())
                resp_off += int((r_g.cpu() != r_c).sum())
                resp_rel = max(resp_rel, float(((r_g.cpu() - r_c).abs()
                                                / r_c.abs().clamp(min=1e-30)).max()))
        kps = int(sum(float(d[2].sum()) for cid in range(2) for d in res[("cuda", cid)]))
        name = str(dtype).split(".")[-1]
        print(f"[9a] MultiCameraFrame, two VGA cameras, {name}: pyramids and gradients CUDA == CPU "
              f"{equal}; keypoints or masks differing {moved} of {kps} over 3 levels; responses "
              f"differing {resp_off} (max relative {resp_rel:.2e})")
        if dtype == f64:
            check(equal and moved == 0 and resp_rel <= 1e-13,
                  "f64 MultiCameraFrame differs between CUDA and CPU")
            # whose sqrt rounds: the level-0 squared gradient norms of camera 0
            g = fr["cpu"].grad_pyramid(0)[0]
            sq = g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1]
            exact = torch.from_numpy(np.sqrt(sq.numpy()))   # numpy's is correctly rounded
            on_card, on_cpu = torch.sqrt(sq.cuda()).cpu(), torch.sqrt(sq)
            print(f"    f64 sqrt of {sq.numel()} squared gradient norms: CUDA != CPU "
                  f"{int((on_card != on_cpu).sum())}, CUDA != correctly rounded "
                  f"{int((on_card != exact).sum())}, CPU != correctly rounded "
                  f"{int((on_cpu != exact).sum())}")


def depth_diff(a, b):
    """(max relative |a - b| off the silhouettes, count beyond 1e-5 on the
    silhouettes, silhouette pixels): a pixel is on a silhouette where its 3x3
    neighbourhood spans a depth jump of more than 10 %."""
    pad = np.pad(a, 1, mode="edge")
    win = np.stack([pad[dy:dy + a.shape[0], dx:dx + a.shape[1]]
                    for dy in range(3) for dx in range(3)])
    edge = win.max(axis=0) > 1.1 * win.min(axis=0)
    rel = np.abs(b.astype(np.float64) - a) / np.maximum(np.abs(a), 1e-12)
    return float(rel[~edge].max()), int((rel[edge] > 1e-5).sum()), int(edge.sum())


def read_ate(est_path, seq):
    from mba_vo_tpu_torch.data import datasets as ds

    _, est, _ = ds.load_tum_trajectory(est_path)
    _, ref, _ = ds.load_tum_trajectory(os.path.join(seq, "groundtruth.txt"))
    n = min(len(est), len(ref))
    return float(np.sqrt(np.mean(np.sum((est[:n] - ref[:n]) ** 2, axis=1))))


def phase_scene_cli(root, cs, launches, timer, config):
    """9b: `cli synth --scene 3d` at its defaults on the card and at 3 frames
    on the CPU, compared; then `cli track` on the card's sequence in f32
    under bench options with --chunk 8 --viz-dir."""
    from mba_vo_tpu_torch.data import datasets as ds

    seq, seq_cpu = os.path.join(root, "scene3d"), os.path.join(root, "scene3d_cpu")
    with timer.stage("9b cli synth --scene 3d cuda (21 frames)"):
        synth_s, _ = run_cli(["synth", "--output", seq, "--scene", "3d", "--device", "cuda"])
    with timer.stage("9b cli synth --scene 3d cpu (3 frames)"):
        cpu_s, _ = run_cli(["synth", "--output", seq_cpu, "--scene", "3d", "--device", "cpu",
                            "--num-frames", str(SYNTH3D_FRAMES_CPU)])
    grey, grey_max, total = 0, 0, 0
    for d in ("images", "sharp"):
        for n in sorted(os.listdir(os.path.join(seq_cpu, d))):
            a = ds.load_gray_image(os.path.join(seq, d, n)).astype(int)
            b = ds.load_gray_image(os.path.join(seq_cpu, d, n)).astype(int)
            grey += int((a != b).sum())
            grey_max = max(grey_max, int(np.abs(a - b).max()))
            total += a.size
    rel, graze, sil = 0.0, 0, 0
    for n in sorted(os.listdir(os.path.join(seq_cpu, "depths"))):
        r, g, e = depth_diff(np.load(os.path.join(seq, "depths", n)),
                             np.load(os.path.join(seq_cpu, "depths", n)))
        rel, graze, sil = max(rel, r), graze + g, sil + e
    z0 = np.load(os.path.join(seq, "depths", "frame_0000.npy"))
    spread = float((z0.max() - z0.min()) / z0.mean())
    print(f"[9b] cli synth --scene 3d (VGA, 21 frames, 31 samples): {synth_s:.2f} s on CUDA; "
          f"{SYNTH3D_FRAMES_CPU} frames on the CPU {cpu_s:.2f} s; CUDA - CPU: {grey} of {total} "
          f"pixels differ (max {grey_max} grey level), depth max relative |diff| {rel:.3e} off the "
          f"silhouettes, {graze} of {sil} silhouette pixels beyond 1e-5; depth spread "
          f"(max - min) / mean {spread:.3f}, min {z0.min():.3f} m")
    check(grey_max <= 1, f"3d synth frames differ by {grey_max} grey levels")
    check(rel <= 1e-5 and graze <= 0.01 * sil, "3d synth depth maps differ")
    check(z0.min() > 0.3 and spread > 0.2, "3d synth must write varying depth maps")

    viz = os.path.join(root, "viz3d")
    est = os.path.join(root, "scene3d_track.txt")
    zero_counts(cs)
    with timer.stage("9b cli track 3d --chunk 8 --viz-dir"):
        wall, out = run_cli(track_argv(seq, est, "cuda", config,
                                       ["--chunk", "8", "--viz-dir", viz]))
    k1 = launches["cli track 3d VGA --chunk 8 --viz-dir (9b)"] = cs.LAUNCHES
    note_residual_launches("cli track 3d VGA --chunk 8 --viz-dir (9b)")
    ate3d = read_ate(est, seq)
    n_png = len([f for f in os.listdir(viz) if f.endswith(".png")])
    rejected = out.count("(rejected")
    m = re.search(r"wrote (\d+) overlays .*\(([0-9.]+) ms each; (\d+) frames outside", out)
    check(m is not None, "the 3d CLI run printed no overlay summary")
    uncovered = int(m.group(3))
    print(f"[9b] cli track on it, f32, bench options, --chunk 8 --viz-dir: {21 / wall:.3f} "
          f"frames/s ({wall:.2f} s), K1 launches {k1}; ATE {ate3d:.4e} m (bound {CLI_ATE_3D}); "
          f"{n_png} overlay PNGs for 21 frames (the bootstrap frame has none; {rejected} "
          f"rejected; {uncovered} outside their knot window), {m.group(2)} ms an overlay")
    check(k1 > 0, "the 3d CLI run never launched K1")
    check(ate3d < CLI_ATE_3D, f"3d CLI ATE {ate3d}")
    check(n_png == int(m.group(1)) == 20 - rejected - uncovered,
          f"{n_png} overlays written for {20 - rejected - uncovered} covered frames")
    return dict(wall=wall, ate=ate3d, launches=k1)


def phase_undistort_cli(root, cs, launches, timer, config, vga):
    """9c: rad-tan and unified copies of phase 8d's VGA sequence, tracked
    with --distortion / --camera-model unified beside the original (`vga`:
    phase 8d's results)."""
    import torch
    from mba_vo_tpu_torch.data import datasets as ds
    from mba_vo_tpu_torch.data.png import write_png
    from mba_vo_tpu_torch.ops.image import build_undistort_map, remap

    seq = os.path.join(root, "vga")
    cams = vga_cameras("cuda", torch.float32)
    res = {"undistorted": dict(ate=read_ate(os.path.join(root, "vga_0.txt"), seq),
                               wall=vga["tracker only"]["wall"],
                               launches=vga["tracker only"]["launches"])}
    flags = {"rad-tan": ["--distortion=" + ",".join(map(str, DIST))],
             "unified": ["--camera-model", "unified", "--xi", str(XI)]}
    for k, name in enumerate(flags):
        copy = os.path.join(root, f"vga_{name}")
        with timer.stage(f"9c make the {name} copy"):
            dmap = build_undistort_map(cams[2], cams[k])
            for sub in ("images", "sharp"):
                os.makedirs(os.path.join(copy, sub))
                for n in sorted(os.listdir(os.path.join(seq, sub))):
                    img = torch.tensor(ds.load_gray_image(os.path.join(seq, sub, n)),
                                       device="cuda")
                    out = remap(img, dmap).cpu().numpy()
                    write_png(os.path.join(copy, sub, n), np.clip(out, 0, 255).astype(np.uint8))
            for n in ("depths", "times.txt", "groundtruth.txt", "intrinsics.txt"):
                os.symlink(os.path.join(seq, n), os.path.join(copy, n))
        est = os.path.join(root, f"vga_{name}.txt")
        zero_counts(cs)
        with timer.stage(f"9c cli track {name} --chunk 8"):
            wall, _ = run_cli(track_argv(copy, est, "cuda", config, ["--chunk", "8", *flags[name]]))
        res[name] = dict(wall=wall, ate=read_ate(est, copy), launches=cs.LAUNCHES)
        launches[f"cli track VGA {' '.join(flags[name])} --chunk 8 (9c)"] = cs.LAUNCHES
        note_residual_launches(f"cli track VGA {' '.join(flags[name])} --chunk 8 (9c)")
    print("[9c] cli track f32, bench options, --chunk 8 on phase 8d's VGA sequence: " + "; ".join(
        f"{n} ATE {r['ate']:.4e} m, {21 / r['wall']:.3f} frames/s, K1 launches {r['launches']}"
        for n, r in res.items())
        + f" (bound {CLI_ATE_UNDISTORTED} m for the copies)")
    for name in flags:
        check(res[name]["launches"] > 0, f"the {name} run never launched K1")
        check(res[name]["ate"] < CLI_ATE_UNDISTORTED, f"{name}: ATE {res[name]['ate']}")
    return res


# tests/test_scene3d.py's recipe: 128 x 160 (fx 120), tests/test_tracker.py's
# world spline, 4 frames of 5 exposure samples, 3 levels of 5 virtual poses,
# 256 keypoints in 12-px cells
LADDER_BOUNDS = {"clean": 1e-2, "rung 1 depth": 2e-2, "rung 2 affine": 1e-2,
                 "rung 3 occluder": 2e-2, "rung 4 full stack": 3e-2}


def world_spline(device):
    """tests/test_tracker.py::world_spline (8 knots, 0.1 s), float64."""
    import torch
    from mba_vo_tpu_torch.core import lie
    from mba_vo_tpu_torch.core.spline import make_knots

    rng = np.random.default_rng(9)
    vel_t, vel_w = np.array([0.06, -0.04, 0.02]), np.array([0.02, 0.05, -0.08])
    kt, kq = [np.zeros(3)], [torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float64)]
    for _ in range(1, 8):
        kt.append(kt[-1] + vel_t * FRAME_DT + rng.normal(0, 3e-4, 3))
        q = lie.quat_multiply(kq[-1], lie.quat_exp(torch.tensor(
            vel_w * FRAME_DT + rng.normal(0, 5e-4, 3), dtype=torch.float64)))
        kq.append(q / torch.linalg.norm(q))
    return make_knots(torch.tensor(np.array(kt), dtype=torch.float64, device=device),
                      torch.stack(kq).to(device), 0.0, FRAME_DT)


def ladder(h, w, fx, dtype, cs, device="cuda"):
    """Each rung of tests/test_scene3d.py::TestRealismLadder and the clean
    scene through track_frame on `device`: {name: ATE}, K1 launches."""
    import torch
    from mba_vo_tpu_torch.core.spline import spline_pose_at
    from mba_vo_tpu_torch.data import scene3d
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    K = np.array([fx, fx, (w - 1) / 2, (h - 1) / 2])
    f64 = dict(dtype=torch.float64, device=device)
    traj, Kt = world_spline(device), torch.tensor(K, **f64)
    base = scene3d.default_scene(smooth_texture(h, w, 5), depth=DEPTH, dtype=torch.float64,
                                 device=device)

    def occluded(i):
        x = -0.35 * DEPTH / 2 + 0.1 * i * DEPTH / 2
        return scene3d.with_occluder(base, [x, 0.05, 0.55 * DEPTH], 0.07 * DEPTH)

    def disturb(i, img):
        return scene3d.apply_photometric_disturbance(img, gain=1.0 + 0.04 * i, bias=2.0 * i,
                                                     vignette=0.15)

    def noisy(z):
        return scene3d.degrade_depth(z, 5000.0, noise_sigma=0.005)

    rungs = {"clean": (lambda i: base, None, None, False),
             "rung 1 depth": (lambda i: base, noisy, None, False),
             "rung 2 plain": (lambda i: base, None, disturb, False),
             "rung 2 affine": (lambda i: base, None, disturb, True),
             "rung 3 occluder": (occluded, None, None, False),
             "rung 4 full stack": (occluded, noisy, disturb, True)}
    out = {}
    zero_counts(cs)
    for name, (scene_at, depth_fn, img_fn, affine) in rungs.items():
        sharp0, z0 = scene3d.render_scene(scene_at(0), torch.zeros(3, **f64),
                                          torch.tensor([0.0, 0.0, 0.0, 1.0], **f64), Kt, h, w)
        z0 = z0.cpu().numpy()
        if depth_fn is not None:
            z0 = depth_fn(z0)
        if img_fn is not None:
            sharp0 = img_fn(0, sharp0)
        cfg = bench_config(dtype, max_keypoints=256, cell=12, levels=3, virtual_poses=5,
                           min_abs_cost_decrease=1e-6, affine_brightness=affine)
        tracker = BlurAwareTracker(cfg, K, (h, w), device=device)
        tracker.track_frame(sharp0, sharp0, 0.0, EXPOSURE, z0)
        errs = []
        for i in range(1, 5):
            cap = i * FRAME_DT
            blurred = scene3d.synthesize_blurred_image_scene(scene_at(i), traj, DEG, cap, EXPOSURE,
                                                             5, Kt, h, w)
            if img_fn is not None:
                blurred = img_fn(i, blurred)
            est = tracker.track_frame(None, blurred, cap, EXPOSURE)
            errs.append(float(torch.linalg.norm(est.t.double() - spline_pose_at(traj, cap, DEG).t)))
        out[name] = float(np.sqrt(np.mean(np.square(errs))))
    return out, cs.LAUNCHES


def phase_ladder(cs, launches, timer):
    """9d: the realism ladder in f64 and f32 on the card, at the test's
    recipe (its bounds checked on the f64 runs) and at VGA; and the
    recipe's f32 run on the CPU beside it, where float32 rounds otherwise."""
    res = {}
    for label, (h, w, fx) in (("test recipe 128x160", (128, 160, 120.0)),
                              ("VGA", (H, W, FX))):
        for dtype in ("float64", "float32"):
            with timer.stage(f"9d ladder {label} {dtype}"):
                res[(label, dtype)], k1 = ladder(h, w, fx, dtype, cs)
            launches[f"realism ladder {label} {dtype}, track_frame (9d)"] = k1
            note_residual_launches(f"realism ladder {label} {dtype}, track_frame (9d)")
            check(k1 > 0, "the ladder never launched K1")
    for label in ("test recipe 128x160", "VGA"):
        r64, r32 = res[(label, "float64")], res[(label, "float32")]
        print(f"[9d] realism ladder, {label}, ATE m f64 / f32 (bound): " + "; ".join(
            f"{n} {r64[n]:.3e} / {r32[n]:.3e}" + (f" ({LADDER_BOUNDS[n]})" if n in LADDER_BOUNDS
                                                   else "") for n in r64))
    with timer.stage("9d ladder test recipe 128x160 float32 on the CPU"):
        host, _ = ladder(128, 160, 120.0, "float32", cs, device="cpu")
    print("    f32 at the test recipe on the CPU, ATE m: " + "; ".join(
        f"{n} {v:.3e}" for n, v in host.items()) + " (not checked)")
    r = res[("test recipe 128x160", "float64")]
    for name, bound in LADDER_BOUNDS.items():
        check(r[name] < bound, f"ladder {name}: f64 ATE {r[name]} >= {bound}")
    check(r["rung 2 affine"] < r["rung 2 plain"], "the affine residual did not beat the plain one")
    return res


# ----------------------------------------------------------------- phase 10

SHARDS = 2                # gloo ranks on cuda:0 (NCCL refuses two ranks on one card)
SHARD_FRAMES = 8          # frames of each sharded tracker run: phase 4's first 8
SHARD_TOL = 1e-9          # sharded against the single-process run, f64
SHARD_CLI_FRAMES = 9      # 10c-d: 10c's bootstrap frame and one chunk of 8
SHARD_TIMEOUT_S = 300


def _sharded_rank(rank, world, store, inputs_path, out_dir):
    """One rank of 10a-b: the bench scenario through track_frame,
    track_frames and track_frames_joint with shard_devices = world in f64
    (K1's, K2's and K3's launches counted from 0 before and read after;
    K1's and K2/K3's calls of track_frame held against the plain versions
    after the count), the same per-frame path in f32, timed, and the window
    BA of phase 8a with its landmarks sharded, each result saved for the
    parent."""
    import datetime

    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        from mba_vo_tpu_torch import interop
        from mba_vo_tpu_torch.backend import ba
        from mba_vo_tpu_torch.experiments import kernel_variants as kv
        from mba_vo_tpu_torch.experiments import residual_kernels as rk
        from mba_vo_tpu_torch.ops import cuda_ba, cuda_lm
        from mba_vo_tpu_torch.ops import cuda_residual as cr
        from mba_vo_tpu_torch.ops import cuda_sampling as cs
        from mba_vo_tpu_torch.ops import window_sampling as ws
        from mba_vo_tpu_torch.parallel.sharded_ba import (
            make_ba_mesh, run_bundle_adjustment_sharded, shard_ba_problem,
        )
        from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

        inp = torch.load(inputs_path, weights_only=False)
        img, frames = inp["img"], inp["frames"]
        cfg64 = bench_config("float64", shard_devices=world)
        out = {}

        zero_counts(cs)
        with kv.record_sampler_calls() as calls, rk.record_residual_calls() as k23_calls:
            tracker = BlurAwareTracker(cfg64, KVEC, img.shape, device="cuda")
            tracker.track_frame(img, img, 0.0, EXPOSURE, np.full(img.shape, DEPTH))
            out["track_frame"] = poses_array([tracker.track_frame(None, b, c, EXPOSURE)
                                              for c, b in frames])
        out["track_frame knots"] = torch.cat([tracker.knots.t, tracker.knots.q], 1).cpu().numpy()
        out["track_frame launches"] = cs.LAUNCHES
        out["track_frame k23 launches"] = cr.launch_counts()
        # K2 and K3 on every call of that path against the plain versions
        # (rk.hold raises past the tolerance): the calls and the largest
        # relative difference by kernel
        out["k23 held"] = {k: (len(c), max((rk.hold(x)[1] for x in c), default=0.0))
                           for k, c in windowed(k23_calls).items()}
        # K1 at this rank's shapes (its keypoint shard) against the plain
        # version, on every call the path made; after the count
        out["k1 shapes"] = sorted({tuple(c.windows.shape) + (c.local_xy.shape[1],)
                                   for c in calls})
        out["k1 max_abs_err"] = max(
            float((ws.window_bilinear(c.windows, c.local_xy, c.valid)
                   - ws.window_bilinear_plain(c.windows, c.local_xy, c.valid)).abs().max())
            for c in calls)
        for method, kw in (("track_frames", dict(chunk=8, inflight=2)),
                           ("track_frames_joint", dict(chunk=JCHUNK, inflight=3))):
            zero_counts(cs)
            if method == "track_frames_joint":
                cfg = bench_config("float64", max_num_iterations=4, shard_devices=world)
                p, _, tr = run_batch(cfg, "cuda", img, frames[:JCHUNK], method=method,
                                     window=inp["window"], **kw)
                k = tr._joint_knots
            else:
                p, _, tr = run_batch(cfg64, "cuda", img, frames, method=method, **kw)
                k = tr.knots
            out[method], out[f"{method} launches"] = p, cs.LAUNCHES
            out[f"{method} k23 launches"] = cr.launch_counts()
            out[f"{method} k9 launches"] = cuda_lm.LAUNCHES_KNOT_PRIOR
            out[f"{method} knots"] = torch.cat([k.t, k.q], 1).cpu().numpy()
            check(tr.mesh is not None and tr.mesh.size == world, "the tracker built no mesh")
        zero_counts(cs)
        p32, sec32, _ = run_tracker(bench_config("float32", shard_devices=world), "cuda", img,
                                    frames)
        out["f32"], out["f32 seconds"], out["f32 launches"] = p32, sec32, cs.LAUNCHES
        out["f32 k23 launches"] = cr.launch_counts()

        a = ba_problem_arrays()
        cuda_ba.zero_launch_counts()
        dense, sd = ba.run_bundle_adjustment(
            interop.ba_problem_from_arrays(**a, device="cuda"), ba.BAOptions())
        out["ba dense launches"] = cuda_ba.launch_counts()
        mesh = make_ba_mesh(world)
        torch.cuda.synchronize()
        cuda_ba.zero_launch_counts()
        t0 = time.perf_counter()
        shard, ss = run_bundle_adjustment_sharded(
            shard_ba_problem(interop.ba_problem_from_arrays(**a, device="cuda"), mesh),
            ba.BAOptions(), mesh)
        torch.cuda.synchronize()
        out["ba seconds"] = time.perf_counter() - t0
        out["ba sharded launches"] = cuda_ba.launch_counts()
        out["ba"] = dict(iterations=(ss.num_iterations, sd.num_iterations),
                         pose=float((shard.poses.t - dense.poses.t).abs().max()),
                         points=float((shard.map.points - dense.map.points).abs().max()),
                         points_shape=tuple(shard.map.points.shape))
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def run_sharded_ranks(inputs: dict, root: str) -> list:
    """SHARDS spawned ranks of _sharded_rank; a rank that fails fails here,
    and its peers are ended."""
    import torch
    import torch.multiprocessing as mp

    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "inputs.pt")
    torch.save(inputs, path)
    ctx = mp.start_processes(_sharded_rank, args=(SHARDS, os.path.join(root, "store"), path,
                                                  root),
                             nprocs=SHARDS, join=False, start_method="spawn")
    end = time.time() + SHARD_TIMEOUT_S
    while not ctx.join(timeout=2):
        if time.time() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the sharded ranks ran past {SHARD_TIMEOUT_S} s")
    return [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
            for r in range(SHARDS)]


def phase_sharded(root, cs, launches, img, frames, refs, fps_single, card):
    """10: keypoint and landmark sharding on torch.distributed, and the
    command line's input read-ahead, on the card."""
    import dataclasses
    import subprocess

    import torch
    from mba_vo_tpu_torch import cli
    from mba_vo_tpu_torch.data import datasets as ds
    from mba_vo_tpu_torch.data.png import read_png
    from mba_vo_tpu_torch.experiments.read_ahead import paeth_copy
    from mba_vo_tpu_torch.utils.config import tracker_config_to_dict

    t10 = time.perf_counter()
    # 10a-b: SHARDS gloo ranks on cuda:0
    fr = frames[:SHARD_FRAMES]
    ranks = run_sharded_ranks(dict(img=img, frames=fr, window=refs["window"]),
                              os.path.join(root, "sharded"))
    r0 = ranks[0]
    for name in ("track_frame", "track_frames", "track_frames_joint"):
        for key in (name, f"{name} knots"):
            check(all(np.array_equal(r[key], r0[key]) for r in ranks[1:]),
                  f"{key}: the ranks' bits differ")
        diff = float(np.abs(r0[name] - refs[name][:len(r0[name])]).max())
        per_rank = [r[f"{name} launches"] for r in ranks]
        path = f"sharded {name}, f64, {SHARDS} ranks (10a)"
        launches[path] = sum(per_rank)
        k23 = sharded_residual_launches(path, [r[f"{name} k23 launches"] for r in ranks])
        if name == "track_frame":
            err = max(r["k1 max_abs_err"] for r in ranks)
            print(f"[10a] K1 on every sampler call of the sharded track_frame path, at the "
                  f"ranks' shapes [N, C, win_h, win_w, S] {r0['k1 shapes']}, against the plain "
                  f"version: max |err| {err:.3e} (f64, bound 1e-12)")
            check(err <= 1e-12, f"K1 disagrees with the plain version at the shard's shapes: {err}")
            check(all(s[0] == N_KP // SHARDS for s in r0["k1 shapes"]),
                  f"K1 ran at other than the shard's keypoints: {r0['k1 shapes']}")
            held = {k: (sum(r["k23 held"][k][0] for r in ranks),
                        max(r["k23 held"][k][1] for r in ranks)) for k in r0["k23 held"]}
            print("[10a] K2, K3 and K5 on every call of the sharded track_frame path, every "
                  "rank, against the plain versions (f64; bounds 1e-12 rows, 1e-10 sums, of "
                  "each output's magnitude; K5 bit for bit): " + ", ".join(
                      f"{k} {n} calls, max {e:.3e}" for k, (n, e) in held.items()))
            check(all(n > 0 for n, _ in held.values()), f"a rank recorded no K2/K3 call: {held}")
        print(f"[10a] {name}, f64, shard_devices={SHARDS} ({SHARDS} gloo ranks on cuda:0), "
              f"{len(r0[name])} frames of the bench scenario: max |pose - single-process pose| "
              f"= {diff:.3e} (bound {SHARD_TOL:g}); knots and poses equal bit for bit on every "
              f"rank; K1 launches per rank {per_rank}; K2/K3 per rank {k23}")
        k9 = [r[f"{name} k9 launches"] for r in ranks] if name != "track_frame" else [0]
        if name == "track_frames_joint":
            # the prior reads only the knots, whole on every rank: K9 serves
            # the sharded LM, whose other stages run plain
            print(f"[10a] {name}: K9 (the knot prior) launches per rank {k9}")
            check(all(n > 0 for n in k9), f"a rank of the sharded {name} never launched K9")
        else:
            check(not any(k9), f"the sharded {name} launched K9: {k9}")
        check(np.isfinite(r0[name]).all(), f"sharded {name}: non-finite poses")
        check(diff <= SHARD_TOL, f"sharded {name} differs from the single-process run by {diff}")
        check(all(n > 0 for n in per_rank), f"a rank of the sharded {name} never launched K1")
    sec = [sum(r["f32 seconds"]) for r in ranks]
    d32 = float(np.abs(r0["f32"] - refs["f32"][:SHARD_FRAMES]).max())
    per_rank = [r["f32 launches"] for r in ranks]
    path = f"sharded track_frame, f32, {SHARDS} ranks (10a)"
    launches[path] = sum(per_rank)
    k23 = sharded_residual_launches(path, [r["f32 k23 launches"] for r in ranks])
    print(f"[10a] track_frame, f32, bench options, shard_devices={SHARDS}: {SHARD_FRAMES} frames "
          f"in {max(sec):.3f} s = {SHARD_FRAMES / max(sec):.3f} frames/s (slowest rank; median "
          f"{1e3 * statistics.median(ranks[0]['f32 seconds']):.1f} ms a frame on rank 0) against "
          f"{fps_single:.3f} frames/s in one process (5a); max |pose - 5a pose| {d32:.3e}; "
          f"K1 launches per rank {per_rank}; K2/K3 per rank {k23}; {card}")
    check(np.isfinite(r0["f32"]).all() and all(n > 0 for n in per_rank), "bad sharded f32 run")
    b = r0["ba"]
    print(f"[10b] run_bundle_adjustment_sharded, f64, window 7, 512 landmark slots ({SHARDS} "
          f"ranks of {512 // SHARDS}): iterations sharded / dense {b['iterations']}; max |pose "
          f"sharded - dense| {b['pose']:.3e}, points {b['points']:.3e} (bound 1e-8); "
          f"{1e3 * r0['ba seconds']:.1f} ms")
    check(b["iterations"][0] == b["iterations"][1] and b["pose"] <= 1e-8 and b["points"] <= 1e-8
          and b["points_shape"] == (512, 3), f"sharded BA differs from dense: {b}")
    dense_l = [r["ba dense launches"] for r in ranks]
    shard_l = [r["ba sharded launches"] for r in ranks]
    print(f"[10b] K10-K12 launches per rank: the dense BA on the kernels {dense_l} in "
          f"{b['iterations'][1]} iterations; the sharded BA (the plain stages, all-reduces "
          f"between them) {shard_l}")
    check(all(set(d.values()) == {b["iterations"][1]} for d in dense_l),
          f"the dense BA's K10-K12 launches {dense_l}")
    check(all(set(d.values()) == {0} for d in shard_l),
          f"the sharded BA launched K10-K12: {shard_l}")
    BA_LAUNCHES[f"run_bundle_adjustment_sharded, {SHARDS} ranks (10b)"] = {
        k: sum(d[k] for d in shard_l) for k in BA_KERNELS}
    BA_LAUNCHES["run_bundle_adjustment, dense, on each rank (10b)"] = {
        k: sum(d[k] for d in dense_l) for k in BA_KERNELS}
    check(all(r["ba"] == b for r in ranks[1:]), "the ranks' BA results differ")

    # 10c: the command line under torch.distributed.run, f64, on 8d's sequence
    seq = os.path.join(root, "vga")
    cfg64 = dataclasses.replace(bench_config("float64"), keyframe_max_flow_mag0=15.0,
                                keyframe_max_flow_mag1=30.0)
    config64 = os.path.join(seq, "config64.json")
    with open(config64, "w") as f:
        json.dump(tracker_config_to_dict(cfg64), f)
    extra = ["--chunk", "8", "--max-frames", str(SHARD_CLI_FRAMES)]
    single_s, _ = run_cli(track_argv(seq, os.path.join(root, "cli64.txt"), "cuda", config64,
                                     extra))
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (here, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(SHARDS), "-m", "mba_vo_tpu_torch.cli",
         *track_argv(seq, os.path.join(root, "cli64_sharded.txt"), "cuda", config64, extra),
         "--shard-devices", str(SHARDS)],
        cwd=here, env=env, capture_output=True, text=True, timeout=SHARD_TIMEOUT_S)
    sharded_s = time.perf_counter() - t0
    chosen = [ln for ln in run.stdout.splitlines() if ln.startswith("torch.distributed:")]
    check(run.returncode == 0, f"torch.distributed.run track failed ({run.returncode}):\n"
          f"{run.stdout[-3000:]}\n{run.stderr[-3000:]}")
    _, t1, q1 = ds.load_tum_trajectory(os.path.join(root, "cli64.txt"))
    _, t2, q2 = ds.load_tum_trajectory(os.path.join(root, "cli64_sharded.txt"))
    diff = float(np.abs(np.concatenate([t1 - t2, q1 - q2], 1)).max())
    print(f"[10c] python -m torch.distributed.run --nproc-per-node {SHARDS} -m "
          f"mba_vo_tpu_torch.cli track --shard-devices {SHARDS}, f64, bench options, --chunk 8, "
          f"{SHARD_CLI_FRAMES} frames of 8d's VGA sequence: max |TUM - single-process TUM| "
          f"{diff:.3e} (bound 1e-6); {sharded_s:.1f} s against {single_s:.1f} s in one process "
          f"(the launcher and each rank's start included); rank 0 said: {chosen}")
    check(len(t2) == SHARD_CLI_FRAMES and diff <= 1e-6, f"the sharded command line differs by {diff}")

    # 10d: the read-ahead on a Paeth-filtered copy of the sequence, f32, per
    # frame (--chunk 1: frame i + 1 decodes while frame i tracks; a chunked
    # call reads its whole batch before it tracks). One run a mode: the
    # comparison in alternating rounds is experiments/read_ahead.py's
    paeth = os.path.join(root, "vga_paeth")
    t0 = time.perf_counter()
    paeth_copy(seq, paeth)
    first = os.path.join(paeth, "images", sorted(os.listdir(os.path.join(paeth, "images")))[1])
    t1 = time.perf_counter()
    read_png(first)
    decode_ms = 1e3 * (time.perf_counter() - t1)
    check(np.array_equal(read_png(first), read_png(first.replace("vga_paeth", "vga"))),
          "the Paeth copy decodes to other pixels")
    config = os.path.join(seq, "config.json")
    res = {}
    for label, s, mode in (("filter 0, process", seq, "process"),
                           ("Paeth, calling thread", paeth, None),
                           ("Paeth, thread pool", paeth, "thread"),
                           ("Paeth, process pool", paeth, "process")):
        out = os.path.join(root, f"pf_{len(res)}.txt")
        cli.READ_AHEAD = mode
        try:
            wall, _ = run_cli(track_argv(s, out, "cuda", config, [
                "--chunk", "1", "--max-frames", str(SHARD_CLI_FRAMES)]))
        finally:
            cli.READ_AHEAD = "process"
        _, t, q = ds.load_tum_trajectory(out)
        res[label] = dict(fps=SHARD_CLI_FRAMES / wall, wall=wall,
                          poses=np.concatenate([t, q], 1))
    ref = res["filter 0, process"]["poses"]
    diffs = {k: float(np.abs(v["poses"] - ref).max()) for k, v in res.items()}
    print(f"[10d] cli track f32, bench options, --chunk 1, {SHARD_CLI_FRAMES} frames of 8d's "
          f"sequence re-encoded with the Paeth filter (one VGA frame decodes in {decode_ms:.1f} ms "
          f"on the card's host; copy made in {t1 - t0:.1f} s): frames/s " + "; ".join(
              f"{k} {v['fps']:.3f} ({v['wall']:.2f} s)" for k, v in res.items())
          + f"; max |TUM - filter-0 TUM| {max(diffs.values()):.3e}; {card}")
    check(max(diffs.values()) <= 1e-9, f"the read-ahead changed the trajectory: {diffs}")
    print(f"    phase 10 in {time.perf_counter() - t10:.1f} s")
    return res


def main() -> int:
    import torch

    # the port itself: without it (the script alone) there is nothing to run
    from mba_vo_tpu_torch.experiments import kernel_variants as kv
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.experiments import ba_kernels as bk
    from mba_vo_tpu_torch.ops import cuda_ba, cuda_build
    from mba_vo_tpu_torch.ops import cuda_image as ci
    from mba_vo_tpu_torch.ops import cuda_layout as cl
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.ops import cuda_residual as cr
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
    libs = cuda_build.build()
    print(f"[2] built K1, K1-v, K2, K3, K4, K5, K6-K8, K9 and K10-K12 in "
          f"{time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(str(p) for p in libs.values())}")
    for name, log in cuda_build.BUILD_LOG.items():
        # ptxas -v: one block of lines per kernel instantiation (IfE float,
        # IdE double)
        kernel = "?"
        for ln in log.splitlines():
            m = re.search(r"((?:window_bilinear(?:_[a-z]+)?|warp_tangents(?:_threads)?|"
                          r"blur_rows(?:_keypoint)?|frame_layout(?:_serial)?|"
                          r"image_bilinear(?:_branch|_interleaved)?|"
                          r"lm_(?:step_shfl|step_block|decide_keypoint|decide_block|"
                          r"commit_staged|commit_block)|knot_prior|ba_(?:build|step|commit))"
                          r"_kernel|normal_equations_(?:partials|combine|cluster))I([fd])"
                          r"((?:Li\d+E)*)", ln)
            if "Compiling entry function" in ln and m:
                ints = re.findall(r"Li(\d+)E", m.group(3))
                kernel = f"{m.group(1)} {'f32' if m.group(2) == 'f' else 'f64'}"
                if m.group(1) == "image_bilinear_kernel" and ints:
                    kernel += f", C = {ints[0]}"
                elif ints:
                    kernel += f", {ints[0]} block(s) a thread"
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
          + f"; K1 none (a block may use {cs.MAX_SHARED_BYTES} B); K2's and K3's earlier "
          f"designs static (above), built for up to {cr.MAX_TANGENTS} knot tangents")
    print(f"    K5's staged design stages the knots (warp 0 their rotations, warp 1 their "
          f"translations, at most {cl.LAYOUT_LOADS} values a lane, up to "
          f"{cl.MAX_LAYOUT_KNOTS} knots): " + "; ".join(
              f"K = {K}: " + " / ".join(
                  f"{(st := cl.layout_staging(K, b)).smem_bytes} B {t} ({st.loads_q} + "
                  f"{st.loads_t} loads a lane)" for t, b in item.items())
              for K in (DEG, JCHUNK + 3, cl.MAX_LAYOUT_KNOTS))
          + f"; K4's select design: {ci.IMAGE_THREADS} threads a block, "
          f"one sample a thread, i // S by (i m) >> k (S = {S_MAIN}: "
          f"m, k = {ci.sample_divisor(S_MAIN)})")
    print(f"    K6 (lm_step) shuffle design, {cuda_lm.LM_THREADS} threads, its sweeps in one "
          f"warp up to D = {cuda_lm.WARP_STEP_MAX_D}; dynamic shared memory, the factor and "
          "H1's copy there where they fit: " + "; ".join(f"D = {D}: " + " / ".join(
              f"{(sl := cuda_lm.step_layout(D, b)).smem} B {t}"
              + ("" if sl.shared_h1 else " (H1 read back)")
              + ("" if sl.shared else " (factor in global memory)")
              for t, b in item.items()) for D in (6, 12, 42, 66, 162, 240))
          + "; the block design (PR 12's): " + "; ".join(f"D = {D}: " + " / ".join(
              f"{cuda_lm.step_smem_bytes(D, b) or cuda_lm.step_rest_bytes(D, b)} B {t}"
              + ("" if cuda_lm.step_smem_bytes(D, b) else " (factor in global memory)")
              for t, b in item.items()) for D in (12, 42, 162, 240))
          + f", {cuda_lm.LM_THREADS} threads; K7's keypoint design "
          + ", ".join(f"N = {n}: {cuda_lm.decide_threads(n)} threads" for n in (1, 40, N_KP, 700))
          + f"; K7's block design and both K8 designs one CTA of {cuda_lm.LM_THREADS} "
          "threads, K8's staged design with no shared memory; K9 (knot_prior) one CTA of "
          f"{cuda_lm.PRIOR_THREADS} threads, dynamic shared memory " + "; ".join(
              f"K = {K}: " + " / ".join(f"{cuda_lm.prior_smem_bytes(K, b)} B {t}"
                                        for t, b in item.items()) for K in (3, 7, 11, 32)))
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    dev0 = torch.device("cuda", 0)

    def resident(W, lay, b):
        return sms * cuda_ba.step_blocks_per_sm(W, lay.landmarks_per_cta, b, lay.s_shared, dev0)

    def commit_smem(W, lay, b):
        # the library's bytes, held to the layout's arithmetic
        got = int(cuda_ba.library().ba_commit_smem_bytes(W, 512, lay.landmarks_per_cta, b))
        check(got == cuda_ba.commit_smem_bytes(W, lay.landmarks_per_cta, lay.ctas, b),
              f"K12's shared memory at W = {W}: the library's {got} B is not the layout's")
        return got
    print("    K10-K12 (ba_build, ba_step, ba_commit): a CTA of "
          f"{cuda_ba.BA_THREADS} threads a slice of the landmarks; K10 (band design) the "
          "last CTA by its ticket combining, one more CTA for the prior's edges; K11 "
          "(cooperative design) one cooperative launch, every CTA resident; K12 (cluster "
          f"design) one cluster of at most {cuda_ba.MAX_COMMIT_CLUSTER} CTAs of "
          f"{cuda_ba.COMMIT_THREADS} threads, rank k the slices k, k + G, ...; landmarks a "
          "CTA, CTAs at 512 slots, dynamic shared memory (K10 / K11 / K11's ticket design / "
          "K12's ticket design / K12), K11's resident CTAs and K12's cluster and the "
          "clusters that fit at once (the occupancy API, on "
          f"{sms} SMs) by window: " + "; ".join(
              f"W = {W}: " + " / ".join(
                  f"{(lay := cuda_ba.ba_layout(W, 512, b)).landmarks_per_cta} a CTA, "
                  f"{lay.ctas} CTAs, " + " / ".join(
                      f"{cuda_ba.smem_bytes(k, W, lay.landmarks_per_cta, b, s, ticket)}"
                      for k, s, ticket in (
                          (10, lay.s_shared, False), (11, lay.s_shared, False),
                          (11, cuda_ba.ticket_s_shared(W, lay.landmarks_per_cta, b), True),
                          (12, lay.s_shared, True)))
                  + f" / {commit_smem(W, lay, b)} B {t}"
                  + ("" if lay.s_shared else " (S in global memory)")
                  + f", {resident(W, lay, b)} resident, K12 {cuda_ba.commit_cluster(lay.ctas)} "
                  f"CTAs, {cuda_ba.commit_clusters(W, 512, lay.landmarks_per_cta, b, dev0)} "
                  "clusters at once"
                  for t, b in item.items()) for W in (7, 15, 30)))
    # the frame's calls (F = 1), a degree-4 joint chunk's (F = 4) and the widest
    for F, D in ((1, 12), (JCHUNK, 6 * (JCHUNK + 3)), (8, cr.MAX_TANGENTS)):
        M = F * N_KP * 8
        print(f"    dynamic shared memory at F={F}, D={D}: blur_rows (keypoint design, P=8, "
              f"V=5) " + " / ".join(
                  f"{(b := cr.blur_rows_layout(F, 8, 5, D, n)).smem_bytes} B {t} "
                  f"(tile {b.tile} x {b.stages} stage(s), {b.threads} threads)"
                  for t, n in item.items())
              + "; K3 (cluster design) " + " / ".join(
                  f"{(k := cr.normal_equations_layout(D, n, N_KP, M)).smem_bytes} B {t} "
                  f"({k.per_chunk} CTA(s) a chunk, {k.parts_a_round} part(s) a round, "
                  f"{k.tiles_a_step} tile(s) a step, {k.stages} stage(s))"
                  for t, n in item.items())
              + "; warp_tangents (knots design) " + " / ".join(
                  f"{(w := cr.warp_tangents_layout(8, 5, D, n)).smem_bytes} B {t} "
                  f"({w.keypoints} keypoints, {w.samples} samples and {w.groups} thread "
                  f"group(s) a block)" for t, n in item.items()))

    # ---- 2b. the card tests
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q", "-p",
         "no:cacheprovider", os.path.join(here, "tests", "test_torch_cuda.py"),
         os.path.join(here, "tests", "test_torch_cuda_ba.py")],
        cwd=here, capture_output=True, text=True, timeout=900)
    summary = [ln for ln in tests.stdout.splitlines() if " passed" in ln or " failed" in ln]
    print(f"[2b] card tests (tests/test_torch_cuda.py and tests/test_torch_cuda_ba.py, -m cuda): "
          f"{summary[-1] if summary else 'no summary'}; {time.perf_counter() - t0:.1f} s")
    if tests.returncode != 0:
        print(tests.stdout[-6000:], tests.stderr[-3000:])
    check(tests.returncode == 0, f"the card tests failed (exit {tests.returncode})")

    # ---- 3. kernels against plain, on the cases and on the tracker's inputs
    t0 = time.perf_counter()
    img, traj, frames = make_scenario("cuda", LONG_FRAMES)
    t1 = time.perf_counter()
    recorded, residual_calls, lm_calls = record_tracker_calls(img, traj, frames)
    print(f"[3] scenario: {LONG_FRAMES} blurred VGA frames rendered in {t1 - t0:.1f} s; "
          f"sampler, K2 and K3 calls recorded in {time.perf_counter() - t1:.1f} s: " + ", ".join(
              f"{label} {len(calls)} (C=3: {sum(c.C == 3 for c in calls)}, levels "
              f"{sorted({c.level for c in calls})})" for label, calls in recorded.items())
          + "; " + ", ".join(f"{label} {kernel} {len(calls)}"
                             for label, by_kernel in residual_calls.items()
                             for kernel, calls in by_kernel.items()))
    print("    K1 (and its band design) and K1-v (ring, every variant; staged) against "
          "the plain version")
    t0 = time.perf_counter()
    max_err, bitwise = phase_kernel(kv, recorded)
    equal = [label for label, same, _ in bitwise if same]
    differ = [(label, d) for label, same, d in bitwise if not same]
    print(f"    K1 band against K1: equal bit for bit on {len(equal)} of "
          f"{len(bitwise)} cases; " + ("differ on " + ", ".join(
              f"{label} (max {d:.3e})" for label, d in differ) if differ else "no case differs")
          + f"; K1 held in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("    K2 (warp_tangents, blur_rows), K3 (normal_equations), K5 (prepare_frame_layout) "
          "and K4 (image_bilinear_lk) against the plain version on every recorded call, and "
          "the direct path on the kernels against its plain chain")
    residual_err = hold_residual_calls(residual_calls)
    print(f"    phase 3's K2-K5 in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print("    K6-K9 (lm_step, lm_decide, lm_commit, knot_prior) against the plain stages on "
          "every recorded call")
    lm_err = hold_lm_calls(lm_calls)
    print(f"    phase 3's K6-K9 in {time.perf_counter() - t0:.1f} s")

    # ---- 4. slice, f64: CUDA against CPU
    launches0 = cs.LAUNCHES
    with (rk.record_residual_calls() as rows64, rk.record_lm_calls() as lm64,
          lm_probe() as probe64):
        p64, s64, _ = run_tracker(bench_config("float64"), "cuda", img, frames)
    check(cs.LAUNCHES > launches0, "the f64 CUDA run did not launch K1")
    residual_err64 = hold_residual_calls({"f64 track_frame": windowed(rows64)})
    lm_err64 = hold_lm_calls({"f64 track_frame": prior_calls("f64 track_frame", lm64, False)})
    with lm_probe(plain=True) as plain64:
        p64p, _, _ = run_tracker(bench_config("float64"), "cuda", img, frames)
    check_plain_stage_iterations("[4] f64 track_frame", probe64, plain64)
    d_plain = float(np.abs(p64 - p64p).max())
    print(f"    f64 poses on K6-K8 against the plain-stage tracker's: max |diff| {d_plain:.3e} "
          f"(bound 1e-9)")
    check(d_plain <= 1e-9, f"f64 poses differ from the plain-stage tracker's by {d_plain}")
    with rk.record_residual_calls() as direct64:
        run_tracker(bench_config("float64", sampling="direct"), "cuda", img, frames[:CPU_FRAMES])
    for kernel, err in hold_residual_calls({"f64 direct track_frame": direct64}).items():
        a, r = residual_err64.get(kernel, (0.0, 0.0))
        residual_err64[kernel] = (max(a, err[0]), max(r, err[1]))
    pcpu, scpu, _ = run_tracker(bench_config("float64"), "cpu", img, frames[:CPU_FRAMES])
    diff = float(np.abs(p64[:CPU_FRAMES] - pcpu).max())
    print(f"[4] f64 CUDA {LONG_FRAMES} frames in {sum(s64):.2f} s; f64 CPU "
          f"{CPU_FRAMES} frames in {sum(scpu):.2f} s; max |pose CUDA - pose CPU| "
          f"over {CPU_FRAMES} frames = {diff:.3e} (bound 1e-8)")
    check(np.isfinite(p64).all() and np.isfinite(pcpu).all(), "non-finite poses")
    check(diff <= 1e-8, f"f64 CUDA and CPU poses differ by {diff}")

    # ---- 5. slice, f32 on CUDA
    # 5a. the main path: bench.py's options (TrackerConfig defaults), from rest
    zero_counts(cs)
    p32, s32, it32 = run_tracker(bench_config("float32"), "cuda", img, frames)
    launches = {"track_frame": cs.LAUNCHES}
    k23 = note_residual_launches("track_frame")
    fps = LONG_FRAMES / sum(s32)
    ate64, ate32 = ate(p64, traj, frames), ate(p32, traj, frames)
    print(f"[5a] main path, f32 CUDA, bench options, from rest: {LONG_FRAMES} frames "
          f"in {sum(s32):.3f} s = {fps:.3f} frames/s (median "
          f"{1e3 * statistics.median(s32):.2f} ms/frame, first frame "
          f"{1e3 * s32[0]:.2f} ms; {card}); K1 launches {cs.LAUNCHES} "
          f"({cs.LAUNCHES / LONG_FRAMES:.1f} per frame)")
    print(f"    ATE f32 {ate32:.4e} m, f64 (phase 4) {ate64:.4e} m; LM iterations "
          f"per level (coarse to fine) of the first 4 frames {it32[:4]}")
    check(p32.shape == (LONG_FRAMES, 7) and np.isfinite(p32).all(), "bad f32 poses")
    check(cs.LAUNCHES > 0, "the per-frame main path never launched K1")
    check(not skipped(k23), f"the per-frame main path skipped K2-K8: {k23}")
    print(f"    K2-K8 launches on that path: " + ", ".join(
        f"{k} {n} ({n / LONG_FRAMES:.1f} per frame)" for k, n in k23.items()))
    total, evals, probe = launches_an_evaluation(bench_config("float32"), img,
                                                 frames[:CPU_FRAMES])
    per_eval = {"windowed": total / max(evals, 1)}
    reads = {"windowed": probe["reads"] / max(sum(probe["iterations"]), 1)}
    check(probe["reads"] == sum(probe["iterations"]), f"5a: host reads {probe}")
    total_p, evals_p, _ = launches_an_evaluation(bench_config("float32"), img,
                                                 frames[:CPU_FRAMES],
                                                 plain=("prepare_frame_layout",))
    per_iter = {"windowed": launches_an_iteration(bench_config("float32"), img,
                                                  frames[:CPU_FRAMES])}
    per_eval["windowed, plain layout"] = total_p / max(evals_p, 1)
    print(f"    kernel launches of {CPU_FRAMES} frames of track_frame, keyframe included "
          f"(torch.profiler): {total} = {total / CPU_FRAMES:.0f} a frame over {evals} LM "
          f"evaluations = {per_eval['windowed']:.1f} an evaluation; with the plain layout in "
          f"place of K5: {total_p} over {evals_p} = "
          f"{per_eval['windowed, plain layout']:.1f} an evaluation ({card}); host reads an "
          f"LM iteration {reads['windowed']:.2f} ({probe['reads']} over "
          f"{sum(probe['iterations'])} iterations); launches of one LM iteration alone "
          f"{per_iter['windowed']:.1f}")

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
    with lm_probe() as probe_a:
        a1, _, _ = run_batch(bench_config("float64"), "cuda", img, frames, chunk=8, inflight=1)
    with lm_probe(plain=True) as plain_a:
        a1p, _, _ = run_batch(bench_config("float64"), "cuda", img, frames, chunk=8, inflight=1)
    check_plain_stage_iterations("[6a] f64 track_frames", probe_a, plain_a)
    check(float(np.abs(a1 - a1p).max()) <= 1e-9, "6a: f64 poses differ from the plain stages'")
    diff = float(np.abs(a2 - p64).max())
    check(diff <= 1e-8, f"f64 track_frames and track_frame poses differ by {diff}")
    check(np.array_equal(a1, a2), "inflight=1 and inflight=2 give different poses")
    zero_counts(cs)
    a32, sec, _ = run_batch(bench_config("float32"), "cuda", img, frames, chunk=8, inflight=2)
    launches["track_frames"] = cs.LAUNCHES
    k23 = note_residual_launches("track_frames")
    print(f"[6a] track_frames(chunk=8, inflight=2): max |f64 pose - track_frame pose| = "
          f"{diff:.3e} (bound 1e-8), inflight 1 == 2 exactly; f32 {LONG_FRAMES} frames in "
          f"{sec:.3f} s = {LONG_FRAMES / sec:.3f} frames/s, K1 launches {cs.LAUNCHES} "
          f"({cs.LAUNCHES / LONG_FRAMES:.1f} per frame), ATE {ate(a32, traj, frames):.4e} m")
    check(a32.shape == (LONG_FRAMES, 7) and np.isfinite(a32).all(), "bad f32 poses")
    d32 = float(np.abs(a32 - p32).max())
    check(d32 <= 1e-6, f"f32 track_frames and track_frame poses differ by {d32}")
    check(cs.LAUNCHES > 0, "track_frames never launched K1")
    check(not skipped(k23), f"track_frames skipped K2-K8: {k23}")

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
    joint64 = {}
    for deg in (4, 2):
        t0 = time.perf_counter()
        cfg_j = bench_config("float64", spline_degree=deg, max_num_iterations=4)
        win = moving_window(traj, frames, JCHUNK, deg)
        args = dict(method="track_frames_joint", window=win, chunk=JCHUNK, inflight=3)
        with lm_probe() as probe_j, rk.record_lm_calls() as lm_j:
            jc, _, tc = run_batch(cfg_j, "cuda", img, frames[:JCHUNK], **args)
        with lm_probe(plain=True) as plain_j:
            jp, _, _ = run_batch(cfg_j, "cuda", img, frames[:JCHUNK], **args)
        check_plain_stage_iterations(f"[6c] f64 track_frames_joint degree {deg}", probe_j,
                                     plain_j)
        # K6-K9 on every call of the f64 joint run, into phase 4's f64 figures
        label = f"[6c] f64 track_frames_joint degree {deg}"
        for kernel, err in hold_lm_calls({label: prior_calls(label, lm_j, True)}).items():
            if kernel == "prior bits":
                pb = lm_err64.setdefault(kernel, dict(err))
                if pb is not err:
                    pb.update(calls=pb["calls"] + err["calls"],
                              bit_equal=pb["bit_equal"] + err["bit_equal"],
                              ulps=max(pb["ulps"], err["ulps"]))
            elif kernel != "forward":
                a, r = lm_err64.get(kernel, (0.0, 0.0))
                lm_err64[kernel] = (max(a, err[0]), max(r, err[1]))
        check(float(np.abs(jc - jp).max()) <= 1e-9, "6c: f64 poses differ from the plain "
                                                    "stages'")
        jh, _, th = run_batch(cfg_j, "cpu", img, frames[:JCHUNK], **args)
        joint64[deg] = jc
        diff = float(np.abs(jc - jh).max())
        kdiff = float((tc._joint_knots.t.cpu() - th._joint_knots.t).abs().max())
        print(f"[6c] track_frames_joint degree {deg}, f64, {JCHUNK} frames, "
              f"{tc._joint_knots.num_knots} knots: max |pose CUDA - pose CPU| = {diff:.3e}, "
              f"knots {kdiff:.3e} (bound 1e-8); {time.perf_counter() - t0:.1f} s")
        check(np.isfinite(jc).all(), "non-finite joint poses")
        check(diff <= 1e-8 and kdiff <= 1e-8, f"joint f64 CUDA and CPU differ by {diff}, {kdiff}")
    zero_counts(cs)
    j32, sec, _ = run_batch(bench_config("float32"), "cuda", img, frames,
                            method="track_frames_joint", chunk=JCHUNK, inflight=3,
                            window=moving_window(traj, frames, JCHUNK, DEG))
    jl = launches["track_frames_joint"] = cs.LAUNCHES
    k23 = note_residual_launches("track_frames_joint")
    n_chunks = LONG_FRAMES // JCHUNK
    cfg_p = bench_config("float32", max_num_iterations=4)
    k9_before = cuda_lm.LAUNCHES_KNOT_PRIOR
    with lm_probe() as probe_jp:
        total = kernel_launches(lambda: run_batch(
            cfg_p, "cuda", img, frames[:JCHUNK], method="track_frames_joint",
            window=moving_window(traj, frames, JCHUNK, DEG), chunk=JCHUNK))
    k9 = cuda_lm.LAUNCHES_KNOT_PRIOR - k9_before
    reads["joint"] = probe_jp["reads"] / max(sum(probe_jp["iterations"]), 1)
    check(probe_jp["reads"] == sum(probe_jp["iterations"]), f"6c: host reads {probe_jp}")
    # K9: one launch at each level's start and one an iteration
    check(k9 == probe_jp["prior"] > 0, f"6c: K9 launched {k9} times, the levels' starts and "
                                       f"iterations {probe_jp['prior']}")
    evals = cs.LAUNCHES - jl
    per_eval["joint"] = total / max(evals, 1)
    per_iter["joint"] = launches_an_iteration(None, img, frames, run=lambda: run_batch(
        cfg_p, "cuda", img, frames[:JCHUNK], method="track_frames_joint",
        window=moving_window(traj, frames, JCHUNK, DEG), chunk=JCHUNK))
    print(f"[6c] track_frames_joint(chunk={JCHUNK}, inflight=3), f32, degree {DEG}: "
          f"{LONG_FRAMES} frames in {sec:.3f} s = {1e3 * sec / n_chunks:.1f} ms/chunk ({card}), "
          f"{LONG_FRAMES / sec:.3f} frames/s; K1 launches {jl} "
          f"({jl / n_chunks:.1f} per chunk, one per LM evaluation at S = "
          f"{JCHUNK * S_MAIN}); ATE {ate(j32, traj, frames):.4e} m (track_frame f32 "
          f"{ate32:.4e} m)")
    print(f"    kernel launches of one chunk with the LM cut to 4 iterations a level, "
          f"bootstrap included (torch.profiler): {total} over {evals} LM evaluations = "
          f"{per_eval['joint']:.1f} per evaluation ({card}), host reads an LM iteration "
          f"{reads['joint']:.2f}; the target under 80 an evaluation "
          f"{'held' if per_eval['joint'] < 80 else 'missed'}; launches of one LM iteration "
          f"alone {per_iter['joint']:.1f}; K9 {k9} launches = one at the "
          f"start of each level with the prior and one an LM iteration there "
          f"({probe_jp['prior']}); K2-K9 launches of the timed run: " + ", ".join(
              f"{k} {n}" for k, n in k23.items()))
    check(j32.shape == (LONG_FRAMES, 7) and np.isfinite(j32).all(), "bad joint f32 poses")
    check(jl > 0, "track_frames_joint never launched K1")
    check(not skipped(k23, prior=True), f"track_frames_joint skipped K2-K9: {k23}")

    # 6d. sampling="direct" and affine_brightness (frames under a gain that
    # drifts by 2 % and a bias that drifts by 1 grey level a frame), four
    # frames each through track_frames, f64 CUDA against CPU
    gained = [(c, (1.0 + 0.02 * (i + 1)) * b + 1.0 * (i + 1))
              for i, (c, b) in enumerate(frames[:CPU_FRAMES])]
    for label, cfg_d, fr in (
            ("sampling=direct", bench_config("float64", sampling="direct"), frames[:CPU_FRAMES]),
            ("affine_brightness", bench_config("float64", affine_brightness=True), gained)):
        t0 = time.perf_counter()
        zero_counts(cs)
        with lm_probe() as probe_d:
            dc, _, _ = run_batch(cfg_d, "cuda", img, fr, chunk=4)
        path = f"track_frames {label}, f64 (6d)"
        launches[path] = cs.LAUNCHES
        k25 = note_residual_launches(path)
        with lm_probe(plain=True) as plain_d:
            dp, _, _ = run_batch(cfg_d, "cuda", img, fr, chunk=4)
        check_plain_stage_iterations(f"[6d] {label} f64", probe_d, plain_d)
        check(float(np.abs(dc - dp).max()) <= 1e-9, f"6d {label}: f64 poses differ from the "
                                                    f"plain stages'")
        dh, _, _ = run_batch(cfg_d, "cpu", img, fr, chunk=4)
        diff = float(np.abs(dc - dh).max())
        direct = label == "sampling=direct"
        print(f"[6d] {label}, f64, {len(fr)} frames: max |pose CUDA - pose CPU| = {diff:.3e} "
              f"(bound 1e-8), ATE {ate(dc, traj, fr):.4e} m; {time.perf_counter() - t0:.1f} s; "
              f"launches of the CUDA run: K1 {cs.LAUNCHES}, " + ", ".join(
                  f"{k} {n}" for k, n in k25.items()))
        check(np.isfinite(dc).all(), f"{label}: non-finite poses")
        check(diff <= 1e-8, f"{label}: f64 CUDA and CPU poses differ by {diff}")
        check(ate(dc, traj, fr) < 2e-3, f"{label}: ATE {ate(dc, traj, fr)} m")
        check(not skipped(k25, direct), f"{label}: a kernel of the path was not launched: {k25}")
        check((cs.LAUNCHES == 0) == direct, f"{label}: K1 launches {cs.LAUNCHES}")

    # 6e. sampling="direct" in f32 at full width, from rest, as 5a tracks it
    t0 = time.perf_counter()
    cfg_direct = bench_config("float32", sampling="direct")
    zero_counts(cs)
    pd32, sd32, itd32 = run_tracker(cfg_direct, "cuda", img, frames)
    path = "track_frame sampling=direct, f32 (6e)"
    launches[path] = cs.LAUNCHES
    k25 = note_residual_launches(path)
    total, evals, probe = launches_an_evaluation(cfg_direct, img, frames[:CPU_FRAMES])
    per_eval["direct"] = total / max(evals, 1)
    reads["direct"] = probe["reads"] / max(sum(probe["iterations"]), 1)
    check(probe["reads"] == sum(probe["iterations"]), f"6e: host reads {probe}")
    per_iter["direct"] = launches_an_iteration(cfg_direct, img, frames[:CPU_FRAMES])
    total_e, evals_e, _ = launches_an_evaluation(
        cfg_direct, img, frames[:CPU_FRAMES], plain=("compute_residuals", "prepare_frame_layout"))
    per_eval["direct, eager"] = total_e / max(evals_e, 1)
    print(f"[6e] sampling=direct, f32 CUDA, bench options, from rest: {LONG_FRAMES} frames in "
          f"{sum(sd32):.3f} s = {LONG_FRAMES / sum(sd32):.3f} frames/s (5a's windowed path "
          f"{fps:.3f}; median {1e3 * statistics.median(sd32):.2f} ms/frame; {card}); ATE "
          f"{ate(pd32, traj, frames):.4e} m (5a {ate32:.4e} m); LM iterations per level of the "
          f"first 4 frames {itd32[:4]}; launches: K1 {cs.LAUNCHES}, " + ", ".join(
              f"{k} {n}" for k, n in k25.items()))
    print(f"    kernel launches an LM evaluation ({CPU_FRAMES} frames, keyframe included, "
          f"torch.profiler): direct on the kernels {per_eval['direct']:.1f} ({total} over "
          f"{evals}); direct eager (its plain chain and the plain layout on the card) "
          f"{per_eval['direct, eager']:.1f} ({total_e} over {evals_e}); windowed (5a) "
          f"{per_eval['windowed']:.1f}, with the plain layout "
          f"{per_eval['windowed, plain layout']:.1f}; host reads an LM iteration "
          f"{reads['direct']:.2f}; launches of one LM iteration alone {per_iter['direct']:.1f}; "
          f"{time.perf_counter() - t0:.1f} s")
    check(pd32.shape == (LONG_FRAMES, 7) and np.isfinite(pd32).all(), "bad direct f32 poses")
    check(not skipped(k25, direct=True) and cs.LAUNCHES == 0,
          f"the direct path skipped a kernel or launched K1: K1 {cs.LAUNCHES}, {k25}")

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

    # K2, K3 and K5 on phase 3's recorded calls of the windowed paths (K3's
    # calls with J), K4 on the direct path's
    t0 = time.perf_counter()
    residual_rows = {}
    for label, by_kernel in residual_calls.items():
        for kernel, calls in by_kernel.items():
            if (label == "direct f32") == (kernel == "image_bilinear_lk"):
                residual_rows[label, kernel] = rk.time_rows(label, rk.full_calls(calls),
                                                            out=indent)
    print(f"    K2-K5 timed in {time.perf_counter() - t0:.1f} s ({card})")
    k1_floor = design("K1")
    # warp_tangents' rows: the knots design, the old path whole (the torch
    # chain, then the earlier thread design), that design alone, plain
    names = {"earlier": "old path", "earlier kernel": "thread design alone"}
    for (label, kernel), timed in residual_rows.items():
        if kernel not in rk.EARLIER:
            continue
        print(f"    {label} {kernel}, device time against the bound and one launch's floor "
              f"(K1 at N = S = 1: {1e3 * k1_floor['floor_warm_ms']:.2f} / "
              f"{1e3 * k1_floor['floor_ms']:.2f} us warm / cold): " + "; ".join(
                  f"{names.get(r['name'], r['name']) if kernel == 'warp_tangents' else r['name']} "
                  f"{1e3 * r['device_ms']:.2f} / {1e3 * r['device_cold_ms']:.2f} "
                  f"us = {r['device_ms'] / k1_floor['floor_warm_ms']:.2f} / "
                  f"{r['device_cold_ms'] / k1_floor['floor_ms']:.2f} floors, bound "
                  f"{100 * r['bound_ms'] / r['device_ms']:.1f} / "
                  f"{100 * r['bound_ms'] / r['device_cold_ms']:.1f} %, a call "
                  f"{1e3 * r['ms']:.2f} us" for r in timed)
              + (f"; {'grid_sample' if kernel == 'image_bilinear_lk' else 'cuBLAS Jw.T @ Jw'} "
                 f"{1e3 * timed[0]['library_device_ms']:.2f} / "
                 f"{1e3 * timed[0]['library_device_cold_ms']:.2f} us"
                 if timed[0]["library_ms"] is not None else ""))
    # the knots design's targets: no slower warm than the thread design alone
    # at the frame (9.04 us, PERF.md section 6), within 2x its bound at the
    # joint chunk
    frame_w, joint_w = (residual_rows[label, "warp_tangents"][0] for label in
                        ("tracker S=40", "joint degree 4"))
    print(f"    warp_tangents targets: frame {1e3 * frame_w['device_ms']:.2f} us warm against "
          f"9.04 ({'met' if frame_w['device_ms'] <= 9.04e-3 else 'not met'}); joint chunk "
          f"{1e3 * joint_w['device_ms']:.2f} us warm against 2 x bound "
          f"{2e3 * joint_w['bound_ms']:.2f} ("
          f"{'met' if joint_w['device_ms'] <= 2 * joint_w['bound_ms'] else 'not met'}); {card}")
    # K4's and K5's redesigns' targets (PERF.md section 6): K4 no slower than
    # grid_sample warm and cold on the direct path's C = 3 calls; K5 at most
    # 3.0 us warm at the frame and 3.2 at the joint chunk
    k4 = residual_rows["direct f32", "image_bilinear_lk"][0]
    k4_met = (k4["device_ms"] <= k4["library_device_ms"]
              and k4["device_cold_ms"] <= k4["library_device_cold_ms"])
    k5 = [residual_rows[label, "prepare_frame_layout"][0]
          for label in ("tracker S=40", "joint degree 4")]
    k4_rows = {r["name"]: r for r in residual_rows["direct f32", "image_bilinear_lk"]}
    print(f"    K4 target: {1e3 * k4['device_ms']:.2f} / {1e3 * k4['device_cold_ms']:.2f} us "
          f"warm / cold against grid_sample {1e3 * k4['library_device_ms']:.2f} / "
          f"{1e3 * k4['library_device_cold_ms']:.2f} ({'met' if k4_met else 'not met'}), "
          f"against 2.5 us warm ({'met' if k4['device_ms'] <= 2.5e-3 else 'not met'}); the "
          f"interleaved row {1e3 * k4_rows['interleaved']['device_ms']:.2f} us warm, not "
          f"launched (its planes: "
          f"{1e3 * k4['plane']['host_ms']:.2f} us of host to save "
          f"{1e3 * k4['plane']['saved_device_ms']:.2f} of device); K5 "
          f"targets: frame {1e3 * k5[0]['device_ms']:.2f} us warm against 3.0 "
          f"({'met' if k5[0]['device_ms'] <= 3.0e-3 else 'not met'}), joint chunk "
          f"{1e3 * k5[1]['device_ms']:.2f} against 3.2 "
          f"({'met' if k5[1]['device_ms'] <= 3.2e-3 else 'not met'}); {card}")

    # K6-K8 on phase 3's recorded calls: the frame's (6K = 12) and the
    # degree-4 joint chunk's (6K = 42); K9 on the joint chunk's, beside its
    # old path
    t0 = time.perf_counter()
    lm_rows = {(label, kernel): rk.time_lm_rows(label, calls, out=indent)
               for label in ("tracker S=40", "joint degree 4")
               for kernel, calls in lm_calls[label].items()}
    print(f"    K6-K9 timed in {time.perf_counter() - t0:.1f} s ({card})")
    # K6's and K7's redesigns' predictions (PERF.md section 6): K6 at most 8 us
    # warm at the frame and 25 at the joint chunk, under the library's; K7 at
    # most 3.5 / 5.5 us warm / cold at both
    k6 = [lm_rows[label, "lm_step"][0] for label in ("tracker S=40", "joint degree 4")]
    k7 = [lm_rows[label, "lm_decide"][0] for label in ("tracker S=40", "joint degree 4")]

    def held(ok):
        return "held" if ok else "missed"

    print(f"    K6 predictions: frame {1e3 * k6[0]['device_ms']:.2f} us warm against 8 "
          f"({held(k6[0]['device_ms'] <= 8e-3)}), joint chunk {1e3 * k6[1]['device_ms']:.2f} "
          f"against 25 ({held(k6[1]['device_ms'] <= 25e-3)}) and the library's "
          f"{1e3 * k6[1]['library_device_ms']:.2f} "
          f"({held(k6[1]['device_ms'] < k6[1]['library_device_ms'])}); K7: " + ", ".join(
              f"{name} {1e3 * r['device_ms']:.2f} / {1e3 * r['device_cold_ms']:.2f} against "
              f"3.5 / 5.5 ({held(r['device_ms'] <= 3.5e-3 and r['device_cold_ms'] <= 5.5e-3)})"
              for name, r in zip(("frame", "joint chunk"), k7)) + f"; {card}")
    # K8's redesign's targets (PERF.md section 6): at most 3.0 / 4.5 us warm /
    # cold at the frame and 3.3 / 5.5 at the joint chunk, a call through the
    # level's binding at most 65 us at the frame
    k8 = [lm_rows[label, "lm_commit"][0] for label in ("tracker S=40", "joint degree 4")]
    k8_block = lm_rows["tracker S=40", "lm_commit"][1]
    print("    K8 targets: " + ", ".join(
        f"{name} {1e3 * r['device_ms']:.2f} / {1e3 * r['device_cold_ms']:.2f} us against "
        f"{w} / {c} ({held(r['device_ms'] <= w * 1e-3)} / "
        f"{held(r['device_cold_ms'] <= c * 1e-3)})"
        for name, r, w, c in zip(("frame", "joint chunk"), k8, (3.0, 3.3), (4.5, 5.5)))
        + f"; a call through the binding at the frame {1e3 * k8[0]['binding_ms']:.2f} us "
        f"against 65 ({held(k8[0]['binding_ms'] <= 65e-3)}; the public wrapper's "
        f"{1e3 * k8[0]['ms']:.2f}, timed in turn); floors (K = F = N = 1) " + ", ".join(
            f"{name} {1e3 * r['floor_device_ms']:.2f} / {1e3 * r['floor_device_cold_ms']:.2f}"
            for name, r in (("staged", k8[0]), ("block", k8_block))) + f"; {card}")

    # K9's target (PERF.md section 6): at most 4 us warm at the joint chunk
    # (K = 7), beside one launch's floor at K = 3
    k9_rows = lm_rows["joint degree 4", rk.PRIOR]
    k9 = k9_rows[0]
    print(f"    K9 target: joint chunk (K = {k9['D'] // 6}) {1e3 * k9['device_ms']:.2f} / "
          f"{1e3 * k9['device_cold_ms']:.2f} us warm / cold against 4 warm "
          f"({held(k9['device_ms'] <= 4e-3)}); its floor (K = 3) "
          f"{1e3 * k9['floor_device_ms']:.2f} / {1e3 * k9['floor_device_cold_ms']:.2f}; the old "
          f"path (torch.func.jacfwd) {1e3 * k9_rows[1]['device_ms']:.2f} / "
          f"{1e3 * k9_rows[1]['device_cold_ms']:.2f}, a call {1e3 * k9_rows[1]['ms']:.2f} against "
          f"K9's {1e3 * k9['ms']:.2f}; {card}")

    def prior_entry():
        kernel = rk.PRIOR
        k, old, p = lm_rows["joint degree 4", kernel]
        by_path = {path: n.get(kernel, 0) for path, n in RESIDUAL_LAUNCHES.items()}
        # the prior is on only where the weight is > 0: the joint path
        on = [path for path, n in by_path.items() if n]
        check(on == ["track_frames_joint"], f"K9 launched on {on}")
        return dict(name=kernel, route="cuda", source="mba_vo_tpu_torch/csrc/knot_prior.cu",
                    replaces="mba_vo_tpu/solver/lm.py:253", launches=sum(by_path.values()),
                    max_abs_err=lm_err[kernel][0], max_rel_err=lm_err[kernel][1],
                    max_rel_err_f64=lm_err64[kernel][1],
                    held=dict(f32=lm_err["prior bits"], f64=lm_err64["prior bits"],
                              rule="bit for bit where the transcendentals round alike, else "
                                   "within 1e-6 (f32) / 1e-13 (f64) of each output's "
                                   "magnitude"),
                    ms=k["ms"], device_ms=k["device_ms"], device_cold_ms=k["device_cold_ms"],
                    plain_ms=p["ms"], plain_device_ms=p["device_ms"],
                    plain_device_cold_ms=p["device_cold_ms"], bound_ms=k["bound_ms"],
                    bound_by=k["bound_by"], library_ms=None,
                    library="none: no single PyTorch call computes this function",
                    floor_device_ms=k["floor_device_ms"],
                    floor_device_cold_ms=k["floor_device_cold_ms"], D=k["D"], calls=k["calls"],
                    design="one CTA: a thread a knot pair into shared memory, then every "
                           "thread strided over H's and g's entries, warp 0 the cost",
                    old_path=dict(design="torch.func.jacfwd of the prior residual, then "
                                         "J^T p and J^T J by the library",
                                  ms=old["ms"], device_ms=old["device_ms"],
                                  device_cold_ms=old["device_cold_ms"]),
                    launches_by_path={q: n for q, n in by_path.items() if n})

    def lm_entry(kernel):
        def times(label, which=0):
            rows_of = lm_rows[label, kernel]
            k, p = rows_of[which], rows_of[-1]
            return dict(ms=k["ms"], device_ms=k["device_ms"],
                        device_cold_ms=k["device_cold_ms"], plain_ms=p["ms"],
                        plain_device_ms=p["device_ms"],
                        plain_device_cold_ms=p["device_cold_ms"], bound_ms=k["bound_ms"],
                        bound_by=k["bound_by"], library_ms=rows_of[0]["library_ms"],
                        library_device_ms=rows_of[0]["library_device_ms"],
                        library_device_cold_ms=rows_of[0]["library_device_cold_ms"],
                        D=k["D"], calls=k["calls"],
                        **{f: k[f] for f in ("floor_device_ms", "floor_device_cold_ms",
                                             "binding_ms") if f in k})
        by_path = {path: n.get(kernel, 0) for path, n in RESIDUAL_LAUNCHES.items()}
        more = {}
        if kernel == "lm_step":
            more["library"] = ("torch.linalg.cholesky_ex + torch.cholesky_solve: two calls, "
                               "the solve alone")
            more["held"] = ("step and model change bit for bit against "
                            "residual_kernels.lm_step_kernel_order in both designs; "
                            "max_abs_err and max_rel_err: the step against lm_step_plain's "
                            "library solve; forward_error: each step against a float64 "
                            "solve of the same system, K6's refined step within "
                            "kappa_2 u, the library's within 3 D kappa_2 u, on the calls "
                            "where that bound is under 1 (checked_*)")
            more["forward_error"] = dict(f32=lm_err["forward"], f64=lm_err64["forward"])
            more["design"] = ("shuffle: every thread takes each pivot itself, the sweeps "
                              "by shuffles in one warp up to D = 64")
        if kernel in rk.LM_EARLIER:
            design_of = {"lm_step": "block: 256 threads, thread 0 takes each pivot and row, "
                                    "block barriers (bit-equal)",
                         "lm_decide": "block: 256 threads, four block-tree sums, three "
                                      "passes over the patch costs",
                         "lm_commit": "block: 256 threads, the flags, then the residual "
                                      "count by a nine-barrier tree, then the branch's "
                                      "loads, then thread 0 reads the scalars again "
                                      "(bit-equal)"}
            if kernel == "lm_decide":
                more["design"] = "keypoint: a thread a keypoint, three one-barrier sums"
            if kernel == "lm_commit":
                more["design"] = (f"staged, {cuda_lm.LM_THREADS} threads: every load in "
                                  "one first batch, each warp's own residual count by "
                                  "shuffles, no barrier, the scalar tail while the stores "
                                  "drain")
                more["binding"] = ("binding_ms: a call through the level's CommitBinding "
                                   "(the LM's host call); ms: lm_commit_cuda, every tensor "
                                   "checked; the two timed in turn in one loop")
            # its launches on the main path's runs, read beside the new design's
            # (the sharded ranks run the plain stages)
            earlier = sum(n.get(kernel, 0) for n in EARLIER_LAUNCHES.values())
            check(earlier == 0, f"a path launched {kernel}'s block design {earlier} times")
            more["before"] = dict(name=kernel + "_block", design=design_of[kernel],
                                  source="mba_vo_tpu_torch/csrc/lm_step.cu", route="cuda",
                                  launches=earlier, launches_read_on=len(EARLIER_LAUNCHES),
                                  **times("tracker S=40", 1),
                                  joint_degree_4=times("joint degree 4", 1))
        return dict(name=kernel, route="cuda", source="mba_vo_tpu_torch/csrc/lm_step.cu",
                    replaces="mba_vo_tpu/solver/lm.py:373", launches=sum(by_path.values()),
                    max_abs_err=lm_err[kernel][0], max_rel_err=lm_err[kernel][1],
                    max_rel_err_f64=lm_err64[kernel][1], **times("tracker S=40"),
                    joint_degree_4=times("joint degree 4"),
                    launches_by_path={p: n for p, n in by_path.items() if n}, **more)

    def residual_entry(kernel, source, replaces, earlier=None, name=None,
                       label="tracker S=40", joint=True, **extra):
        def times(label, which=0):
            rows_of = residual_rows[label, kernel]
            k, p = rows_of[which], rows_of[-1]
            return dict(ms=k["ms"], device_ms=k["device_ms"],
                        device_cold_ms=k["device_cold_ms"], plain_ms=p["ms"],
                        plain_device_ms=p["device_ms"],
                        plain_device_cold_ms=p["device_cold_ms"], bound_ms=k["bound_ms"],
                        bound_by=k["bound_by"], library_ms=rows_of[0]["library_ms"],
                        library_device_ms=rows_of[0]["library_device_ms"],
                        library_device_cold_ms=rows_of[0]["library_device_cold_ms"],
                        D=k["D"], calls=k["calls"])
        by_path = {path: n[kernel] for path, n in RESIDUAL_LAUNCHES.items()}
        more = {}
        if earlier is not None:
            # the earlier design: timed beside the new one (phase 7), equal to it
            # bit for bit on every recorded call (phase 3; warp_tangents' to the
            # tolerances, fed by the torch chain), launched by no path
            which = 2 if kernel == "warp_tangents" else 1
            more["before"] = dict(earlier, **times(label, which))
            if joint:
                more["before"]["joint_degree_4"] = times("joint degree 4", which)
            # the other timed rows (K4's interleaved plane),
            # each equal to the kernel bit for bit on the calls it was timed on
            others = residual_rows[label, kernel][which + 1:-1]
            if others:
                more["variants"] = [dict(name=r["name"], ms=r["ms"], device_ms=r["device_ms"],
                                         device_cold_ms=r["device_cold_ms"]) for r in others]
        if kernel == "warp_tangents":
            more["old_path"] = dict(
                design="the torch chain of the pose Jacobian, then the thread design",
                **times("tracker S=40", 1), joint_degree_4=times("joint degree 4", 1))
        if joint:
            more["joint_degree_4"] = times("joint degree 4")
        if kernel in rk.BIT_EQUAL_PLAIN:
            more["bit_equal_to_plain"] = True
        k1_n1 = {k: v for k, v in residual_rows[label, kernel][0].items() if k.startswith("k1_n1")}
        return dict(name=name or kernel, route="cuda", source=source, replaces=replaces,
                    launches=sum(by_path.values()), max_abs_err=residual_err[kernel][0],
                    max_rel_err=residual_err[kernel][1],
                    max_rel_err_f64=residual_err64[kernel][1], **times(label),
                    launches_by_path={p: n for p, n in by_path.items() if n}, **k1_n1, **more,
                    **extra)

    def ba_entry(kernel):
        def times(label):
            r = ba_rows[label][kernel]
            return {k: r[k] for k in ("ms", "device_ms", "device_cold_ms", "plain_ms",
                                      "bound_ms", "bound_by", "library_ms", "library_device_ms",
                                      "library_device_cold_ms", "calls", "W", "M", "dtype")}

        def split(label, method):
            return BA_SPLIT.get((label, kernel, method))
        replaces = {"ba_build": "mba_vo_tpu/backend/ba.py:185",
                    "ba_step": "mba_vo_tpu/backend/ba.py:232",
                    "ba_commit": "mba_vo_tpu/backend/ba.py:337"}[kernel]
        by_path = {p: n[kernel] for p, n in BA_LAUNCHES.items() if n[kernel]}
        held = {label: dict(max_rel_err=g["worst"][kernel], iterations=g["iterations"],
                            **({"within_1e-12": g["step_within"],
                                "checked": g["step_checked"], "share_of_bound": g["step_share"],
                                "kappa_2": g["kappa"], "kappa_2_V": g["kappa_V"]}
                               if kernel == "ba_step" else {}),
                            **({"decisions_equal": g["iterations"] - len(g["flips"])}
                               if kernel == "ba_commit" else {}))
                for label, g in BA_HELD.items()}
        # the earlier ticket design: timed beside the launched one in turn,
        # held against it (K10 and K12 bit for bit, K11 within its roundoff
        # bound), launched by no path
        earlier = sum(n.get(kernel, 0) for n in EARLIER_LAUNCHES.values())
        check(earlier == 0, f"a path launched {kernel}'s ticket design {earlier} times")
        launched, method = bk.DESIGNS[kernel]
        more = dict(design={
            "ba_build": "band: the prior's edges on a CTA of their own beside the slices', "
                        "the last CTA summing only, H_o's band only",
            "ba_step": "cooperative: grid barriers, the partials summed a share a CTA, S "
                       "factored by 6 x 6 blocks with its right-hand side as a row and "
                       "reciprocal pivots, every CTA back-substituting its own slice",
            "ba_commit": "cluster: one thread-block cluster of min(C, 16) CTAs, no ticket; "
                         "the prior and dp's check on a warp of their own beside the "
                         "observations, each slice's sums stored into every rank's shared "
                         "memory before the cluster's barrier, summed in slice order by "
                         "every CTA, each rank committing its own slices of X"}[kernel])
        more["phases"] = {label: split(label, launched) for label in ba_rows}
        more["before"] = dict(
            name=kernel + "_ticket", route="cuda",
            design="ticket (the earlier design): the last CTA by an integer ticket finishing "
                   "the stage",
            source="mba_vo_tpu_torch/csrc/bundle_adjust.cu", launches=earlier,
            launches_read_on=len(EARLIER_LAUNCHES),
            held={label: dict(bit_equal=g[kernel + "_equal"], max_rel_err=g[kernel],
                              **({"within_1e-12": g["step_within"],
                                  "checked": g["step_checked"],
                                  "share_of_bound": g["step_share"]}
                                 if kernel == "ba_step" else {}))
                  for label, g in BA_DESIGNS_HELD.items()},
            **{k: ba_rows["8a window 7"][kernel]["ticket"][k]
               for k in ("ms", "device_ms", "device_cold_ms")},
            loop_benchmark=ba_rows["8c loop benchmark"][kernel]["ticket"],
            phases={label: split(label, method) for label in ba_rows})
        if kernel == "ba_step":
            more["library"] = ("torch.linalg.cholesky_ex + torch.cholesky_solve on the same "
                               "reduced camera system S: two calls, the solve alone")
            more["rule"] = ("within the larger of 1e-12 of each output's magnitude and "
                            "what roundoff in K11's sums can move it by "
                            "(experiments/ba_kernels.py's step_bounds: 2 D u times the "
                            "magnitudes of S's and its right-hand side's terms through "
                            "||S^-1||, and through |V^-1| and kappa_2(V) for dx) where S is "
                            "definite beyond its roundoff; NaN where it is indefinite beyond "
                            "it; else unchecked (counted)")
        return dict(name=kernel, route="cuda", source="mba_vo_tpu_torch/csrc/bundle_adjust.cu",
                    replaces=replaces, launches=sum(by_path.values()),
                    max_abs_err=max(g["worst"][kernel] for g in BA_HELD.values()),
                    **times("8a window 7"), loop_benchmark=times("8c loop benchmark"),
                    launches_by_path=by_path, held=held, **more)

    # ---- 8. the command line and the keyframe backend
    t8 = time.perf_counter()
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "runtime"))
    import bindings

    print("    the runtime library (k-d tree) "
          + ("is built" if bindings.native_available() else
             "could not be built: the k-d tree's pure-Python path serves the same indices"))
    solvers = phase_backend_solvers(img, cand[0][3])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        phase_cli_cuda_vs_cpu(root, cs, launches)
        loop = phase_loop_benchmark(cs, launches, root)
        vga = phase_vga_cli(root, cs, launches)
        print(f"    phase 8 in {time.perf_counter() - t8:.1f} s")
        # K10-K12 timed on 8a's and 8c's recorded iterations
        t0 = time.perf_counter()
        recorded = (("8a window 7", solvers["ba_calls"]),
                    ("8c loop benchmark", loop["ba_calls"]))
        ba_rows = {label: bk.time_ba_rows(label, calls, out=indent) for label, calls in recorded}
        print(f"    K10-K12 timed in {time.perf_counter() - t0:.1f} s ({card})")
        # where the time goes in K10-K12, both designs, by phase
        t0 = time.perf_counter()
        for label, calls in recorded:
            for kernel, methods in bk.DESIGNS.items():
                for method in methods:
                    got = bk.phase_split(kernel, method, calls)
                    BA_SPLIT[label, kernel, method] = got
                    print(f"    {label} {kernel} {method} design, phases (median over "
                          f"{min(len(calls), 20)} launches of the harness-only build, us): "
                          + ", ".join(f"{k} {v:.2f}" for k, v in got.items()))
        # the earlier ticket designs against the launched ones (K10 and K12 bit
        # for bit, K11 within its roundoff bound: hold_designs raises past it)
        # on every 8a iteration and 8c's first 200
        for label, calls in recorded:
            got = bk.hold_designs_calls(calls[:200])
            BA_DESIGNS_HELD[label] = got
            print(f"    {label}: the ticket designs against the launched ones on "
                  f"{got['iterations']} iterations: K10 bit-equal on {got['ba_build_equal']}; "
                  f"K11 bit-equal on {got['ba_step_equal']}, within 1e-12 of each output's "
                  f"magnitude on {got['step_within']}, within its roundoff bound (at most "
                  f"{got['step_share']:.3e} of it) on "
                  f"{got['step_checked'] - got['step_within']}, unchecked on "
                  f"{got['iterations'] - got['step_checked']}; K12 bit-equal on "
                  f"{got['ba_commit_equal']}; largest differences {got['ba_build']:.3e} / "
                  f"{got['ba_step']:.3e} / {got['ba_commit']:.3e} of each output's magnitude")
            for kernel in ("ba_build", "ba_commit"):
                check(got[kernel + "_equal"] == got["iterations"],
                      f"{label}: {kernel}'s ticket design differs from the launched one")
        print(f"    phase split and designs held in {time.perf_counter() - t0:.1f} s")

        # ---- 9. the models, the non-planar scene, undistortion, overlays
        from mba_vo_tpu_torch.utils.profiling import StageTimer

        t9 = time.perf_counter()
        timer = StageTimer()
        config = os.path.join(root, "vga", "config.json")
        phase_models(timer, frames[0][1])
        phase_scene_cli(root, cs, launches, timer, config)
        phase_undistort_cli(root, cs, launches, timer, config, vga)
        phase_ladder(cs, launches, timer)
        print(f"[9] stages (StageTimer, each ended by a device synchronisation; {card}):")
        for line in timer.report().splitlines():
            print("    " + line)
        print(f"    phase 9 in {time.perf_counter() - t9:.1f} s")

        # ---- 10. sharding on torch.distributed, the command line's read-ahead
        refs = {"track_frame": p64, "track_frames": a2, "track_frames_joint": joint64[DEG],
                "f32": p32, "window": moving_window(traj, frames, JCHUNK, DEG)}
        phase_sharded(root, cs, launches, img, frames, refs, fps, card)

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
        residual_entry("warp_tangents", "mba_vo_tpu_torch/csrc/residual_rows.cu",
                       "mba_vo_tpu/ops/residual.py:430",
                       earlier=dict(name="warp_tangents_threads",
                                    design="one thread a sample, from the poses and pose "
                                           "tangents of the torch chain",
                                    source="mba_vo_tpu_torch/csrc/residual_rows.cu")),
        residual_entry("blur_rows", "mba_vo_tpu_torch/csrc/residual_rows.cu",
                       "mba_vo_tpu/ops/residual.py:449",
                       earlier=dict(name="blur_rows_threads", design="one thread a row",
                                    source="mba_vo_tpu_torch/csrc/residual_rows.cu")),
        residual_entry("normal_equations", "mba_vo_tpu_torch/csrc/normal_equations.cu",
                       "mba_vo_tpu/ops/residual.py:568",
                       earlier=dict(name="normal_equations_split",
                                    design="two launches: partials, then their combination",
                                    source="mba_vo_tpu_torch/csrc/normal_equations.cu")),
        residual_entry("prepare_frame_layout", "mba_vo_tpu_torch/csrc/frame_layout.cu",
                       "mba_vo_tpu/ops/residual.py:348", name="frame_layout",
                       earlier=dict(name="frame_layout_serial",
                                    design="the segment found before its knots are loaded, the "
                                           "pose's chain in one thread: four dependent trips",
                                    source="mba_vo_tpu_torch/csrc/frame_layout.cu")),
        residual_entry("image_bilinear_lk", "mba_vo_tpu_torch/csrc/image_bilinear.cu",
                       "mba_vo_tpu/ops/residual.py:273", name="image_bilinear",
                       earlier=dict(name="image_bilinear_branch",
                                    design="one thread a sample, 64-bit indices, a branch "
                                           "before the taps",
                                    source="mba_vo_tpu_torch/csrc/image_bilinear.cu"),
                       label="direct f32", joint=False, direct_path_max_rel_err=dict(
                           f32=residual_err["direct path"][1],
                           f64=residual_err64["direct path"][1]),
                       by_level=k4["levels"], first_call=k4["first_call"], plane=k4["plane"]),
        lm_entry("lm_step"), lm_entry("lm_decide"), lm_entry("lm_commit"), prior_entry(),
        ba_entry("ba_build"), ba_entry("ba_step"), ba_entry("ba_commit"),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
