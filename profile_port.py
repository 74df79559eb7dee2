"""Profile of the PyTorch port's main path on one NVIDIA GPU.

Run from the root of the repository:

    python3 profile_port.py [--frames 4] [--warmup 8] [--out FILE]
    python3 profile_port.py --joint [--chunk 4] [--out FILE]
    python3 profile_port.py --k3-designs [--frames 16]
    python3 profile_port.py --warp-designs [--frames 16] [--chunk 4]
    python3 profile_port.py --layout-designs [--frames 16] [--chunk 4]
    python3 profile_port.py --direct [--frames 16]
    python3 profile_port.py --lm-designs [--frames 16]

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

``--k3-designs`` weighs K3's two designs on the per-frame path: the cluster
design (one launch a call), which the tracker launches, and the split
design (two launches a call), which it launched before. They give the same
bits, so two trackers given the same frames do the same work. It prints
the host's time to issue one call of each at the frame's shape (blocks of
100 calls without waiting, the designs alternating), then the wall ms per
LM evaluation of each tracker over ``--frames`` frames, tracked by both in
turn (the order alternating a frame), their paired difference, the largest
pose difference of the two, and each tracker's kernel launches per LM
evaluation on one more frame under the profiler.

``--warp-designs`` weighs K2's first entry the same way: the knots design
(one launch from the spline knots to the warp tangents), which the tracker
launches, against the old path (the pose Jacobian's torch chain,
``virtual_poses_and_tangents``, then the earlier thread design). It prints the
host's time to issue one call of each at the frame's shape, then two
trackers on the same ``--frames`` frames (wall ms per LM evaluation, their
paired difference, the largest pose difference) and each tracker's kernel
launches per LM evaluation on one more frame under the profiler; then the
same launches per evaluation for a joint chunk (``--chunk`` frames from a
moving window) at degree 4 and at degree 2.

``--layout-designs`` weighs the patch layout the same way: K5 (one launch
from the knots to the pixels, their validity and the observations), which
the tracker launches, against its plain version run on the card
(``prepare_frame_layout_plain``, the eager ops it replaces), at the frame
and at the joint chunks.

``--direct`` weighs the direct path (``sampling="direct"``) the same way:
on the kernels (K5, K2's two entries, K4), as the tracker runs it, against
the eager path it replaces (its plain chain, ``compute_residuals_plain``,
and the plain layout, on the card), the trackers configured for the direct
path. The LM evaluations are counted as calls of either path's residual
function.

``--lm-designs`` weighs the LM iteration's stages the same way: K6-K8
(``solver.lm.lm_step``, ``lm_decide``, ``lm_commit`` on the card: three
launches and one host read an iteration), as the tracker runs them, against
their plain versions run on the card (``lm_step_plain`` and the others:
the eager ops they replace), the host's time to issue one iteration's three
stages at the frame's shape first; then K8's host call the same way, the
level's ``CommitBinding`` (the tracker's K8) against ``lm_commit_cuda``
checking every tensor on every call.
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import sys
import time

import numpy as np

from chip_smoke import (
    DEG, DEPTH, EXPOSURE, KVEC, bench_config, counting_evaluations, make_scenario,
    moving_window, plain_stages,
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


def _joint_tracker(chunks: int, chunk: int, degree: int = DEG):
    """An f32 tracker past its keyframe on a window that already moves
    (chip_smoke.py's ``moving_window``), the scenario's first ``chunks`` x
    ``chunk`` frames, and ``track(frames)``: one synchronised
    ``track_frames_joint`` call."""
    import torch

    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    img, traj, frames = make_scenario("cuda", chunks * chunk)
    h, w = img.shape
    tracker = BlurAwareTracker(bench_config("float32", spline_degree=degree), KVEC, (h, w),
                               device="cuda")
    tracker.track_frame(img, img, 0.0, EXPOSURE, np.full((h, w), DEPTH))
    interop.install_tracker_state(tracker, moving_window(traj, frames, chunk, degree))

    def track(part):
        tracker.track_frames_joint([b for _, b in part], [t for t, _ in part],
                                   [EXPOSURE] * len(part), chunk=chunk, inflight=1)
        torch.cuda.synchronize()

    return frames, track


def profile_joint(args) -> int:
    """One joint chunk to warm up (the first solve initialises the dense
    solver's library), one timed unprofiled, the next under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from mba_vo_tpu_torch.ops import cuda_sampling as cs

    c = args.chunk
    frames, track = _joint_tracker(3, c)
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


@contextlib.contextmanager
def _k3_design(name: str):
    """The tracker's K3 calls go to the ``name`` design ("cluster" or
    "split") inside the block."""
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    launched = cr.normal_equations_cuda
    if name == "split":
        cr.normal_equations_cuda = cr.normal_equations_split_cuda
    try:
        yield
    finally:
        cr.normal_equations_cuda = launched


def _weigh_designs(args, designs, switch, issue, what: str, **config) -> None:
    """Two designs of one kernel on the per-frame path, ``switch(d)``
    sending the tracker's calls to design ``d`` inside its block: the
    host's time to issue one ``issue()`` under each (blocks of 100 calls
    without waiting, the designs alternating), then two trackers
    (bench_config's, with ``config`` on top) on the same ``args.frames``
    frames, tracked by both in turn (the order alternating a frame): wall ms
    per LM evaluation, its paired difference and the largest pose difference
    of the two; then each tracker's kernel launches per LM evaluation on one
    more frame under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    host = {d: [] for d in designs}
    for i in range(40):
        for d in (designs if i % 2 == 0 else designs[::-1]):
            with switch(d):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(100):
                    issue()
                host[d].append((time.perf_counter() - t0) / 100)
                torch.cuda.synchronize()
    print(f"host time to issue one {what} call at the frame's shape (median of 40 blocks of "
          "100): " + "; ".join(f"{d} {1e6 * statistics.median(host[d][2:]):.2f} us"
                               for d in designs))

    img, _traj, frames = make_scenario("cuda", args.frames + 2)
    h, w = img.shape
    trackers = {}
    for d in designs:
        trackers[d] = BlurAwareTracker(bench_config("float32", **config), KVEC, (h, w),
                                       device="cuda")
        with switch(d):
            trackers[d].track_frame(img, img, 0.0, EXPOSURE, np.full((h, w), DEPTH))
    torch.cuda.synchronize()

    def track(d, cap, blur):
        with switch(d), counting_evaluations() as evals:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pose = trackers[d].track_frame(None, blur, cap, EXPOSURE)
            torch.cuda.synchronize()
            return time.perf_counter() - t0, evals[0], pose

    first, second = designs
    ms_eval = {d: [] for d in designs}
    diffs, apart = [], 0.0
    for i, (cap, blur) in enumerate(frames[:-1]):
        got = {d: track(d, cap, blur) for d in (designs if i % 2 == 0 else designs[::-1])}
        (ta, ea, pa), (tb, eb, pb) = got[first], got[second]
        apart = max(apart, float((pa.t - pb.t).abs().max()), float((pa.q - pb.q).abs().max()))
        if i == 0:
            continue        # the first frame after the keyframe warms up
        ms_eval[first].append(1e3 * ta / ea)
        ms_eval[second].append(1e3 * tb / eb)
        diffs.append(1e6 * (tb / eb - ta / ea))
    print(f"per-frame path, f32, {len(diffs)} frames, largest pose difference of the two "
          f"trackers {apart:.3e}; wall ms per LM evaluation (median over frames): " + "; ".join(
              f"{d} {statistics.median(ms_eval[d]):.3f}" for d in designs)
          + f"; {second} less {first}, paired a frame: median "
          f"{statistics.median(diffs):.1f} us per evaluation (frames: "
          f"{[round(x, 1) for x in diffs]})")
    cap, blur = frames[-1]
    for d in designs:
        with switch(d), counting_evaluations() as counted, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trackers[d].track_frame(None, blur, cap, EXPOSURE)
            torch.cuda.synchronize()
        evals = counted[0]
        launch = _launches(prof.key_averages())
        print(f"frame, {d}: {launch} kernel launches over {evals} LM evaluations = "
              f"{launch / max(evals, 1):.1f} per evaluation")


def compare_k3(args) -> int:
    """K3's cluster and split designs (the module docstring)."""
    import torch

    from mba_vo_tpu_torch.ops import cuda_residual as cr

    # the frame's shape: F = 1, N = 512, P = 8, D = 12
    gen = torch.Generator(device="cuda").manual_seed(0)
    r = 20 * torch.randn((1, 512, 8), device="cuda", generator=gen)
    J = 30 * torch.randn((1, 512, 8, 12), device="cuda", generator=gen)
    kp_w = torch.ones(512, device="cuda")
    _weigh_designs(args, ("cluster", "split"), _k3_design,
                   lambda: cr.normal_equations_cuda(r, J, kp_w, 20.0, False), "K3")
    return 0


@contextlib.contextmanager
def _warp_design(name: str):
    """The tracker's warp_tangents calls go to the ``name`` design ("knots"
    or "old path") inside the block."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import residual

    launched = residual.warp_tangents
    if name == "old path":
        residual.warp_tangents = rk.earlier_fn("warp_tangents")
    try:
        yield
    finally:
        residual.warp_tangents = launched


def _joint_launches(design: str, degree: int, chunk: int, switch=None) -> tuple:
    """(kernel launches, LM evaluations) of one joint chunk at ``degree``
    under ``design`` (of ``switch``, by default warp_tangents' designs),
    after a chunk to warm up, from a moving window."""
    from torch.profiler import ProfilerActivity, profile

    frames, track = _joint_tracker(2, chunk, degree)
    with (switch or _warp_design)(design):
        track(frames[:chunk])
        with counting_evaluations() as evals, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            track(frames[chunk:])
    return _launches(prof.key_averages()), evals[0]


def compare_warp(args) -> int:
    """K2's first entry, the knots design against the old path, at the frame
    and at a joint chunk (the module docstring)."""
    import torch

    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.ops import residual

    designs = ("knots", "old path")
    # the frame's shape: 2 knots at degree 2, F = 1, V = 5, N = 512, P = 8
    gen = torch.Generator(device="cuda").manual_seed(0)
    opts = dict(device="cuda", dtype=torch.float32)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.001, -0.002, 0.001, 1.0]], **opts)
    knots = make_knots(0.01 * torch.randn((2, 3), generator=gen, **opts),
                       q / q.norm(dim=1, keepdim=True), 0.05, 0.1)
    kp = torch.rand((512, 2), generator=gen, **opts) * torch.tensor([639.0, 479.0], **opts)
    pix = (kp.floor()[None, :, None, :]
           + torch.randint(-2, 3, (1, 512, 8, 2), generator=gen, device="cuda").float())
    call = (knots, torch.full((1,), 0.1, **opts), torch.full((1,), 0.03, **opts), 5, 2, True,
            torch.full((512,), 2.0, **opts), torch.tensor(KVEC, **opts), pix.contiguous(),
            (kp.floor() - 16).clamp(min=0).long(), 480, 640)
    _weigh_designs(args, designs, _warp_design, lambda: residual.warp_tangents(*call),
                   "warp_tangents")
    for degree in (4, 2):
        for d in designs:
            launch, evals = _joint_launches(d, degree, args.chunk)
            print(f"joint chunk of {args.chunk}, degree {degree}, {d}: {launch} kernel launches "
                  f"over {evals} LM evaluations = {launch / max(evals, 1):.1f} per evaluation")
    return 0


def _layout_design(name: str):
    """The tracker's layout calls go to K5 ("kernel") or to its plain
    version ("plain") inside the block."""
    return plain_stages(("prepare_frame_layout",) if name == "plain" else ())


def _direct_design(name: str):
    """The direct path's evaluations run on the kernels ("kernels") or as
    the eager chain they replace ("eager": compute_residuals_plain and the
    plain layout) inside the block."""
    return plain_stages(("compute_residuals", "prepare_frame_layout") if name == "eager"
                         else ())


def _frame_call():
    """(knots, level data) at the frame's shape on the card: 2 moving knots
    at degree 2, F = 1, V = 5, N = 512, P = 8, a VGA keyframe, its gradient
    image and a noisy copy as the current frame."""
    import torch

    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.ops import residual
    from mba_vo_tpu_torch.ops.image import image_gradients
    from mba_vo_tpu_torch.tracker.patterns import PATTERNS

    gen = torch.Generator(device="cuda").manual_seed(0)
    opts = dict(device="cuda", dtype=torch.float32)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.001, -0.002, 0.001, 1.0]], **opts)
    knots = make_knots(0.01 * torch.randn((2, 3), generator=gen, **opts),
                       q / q.norm(dim=1, keepdim=True), 0.05, 0.1)
    knots = knots._replace(t0=knots.t0.cuda(), dt=knots.dt.cuda())
    img = 255 * torch.rand((480, 640), generator=gen, **opts)
    data = residual.TrackingLevelData(
        img_ref=img, grad_ref=image_gradients(img).contiguous(),
        cur_imgs=(img + torch.randn((480, 640), generator=gen, **opts))[None],
        cap_times=torch.full((1,), 0.1, **opts), exp_times=torch.full((1,), 0.03, **opts),
        kp_xy=torch.rand((512, 2), generator=gen, **opts) * torch.tensor([639.0, 479.0], **opts),
        kp_z=torch.full((512,), 2.0, **opts), kp_mask=torch.ones(512, **opts),
        pattern=torch.as_tensor(PATTERNS["dso8"](), device="cuda"),
        K=torch.tensor(KVEC, **opts))
    return knots, data


def compare_layout(args) -> int:
    """The patch layout, K5 against its plain version on the card, at the
    frame and at joint chunks (the module docstring)."""
    from mba_vo_tpu_torch.ops import residual

    designs = ("kernel", "plain")
    knots, data = _frame_call()
    _weigh_designs(args, designs, _layout_design,
                   lambda: residual.prepare_frame_layout(knots, data, 5, 2),
                   "prepare_frame_layout")
    for degree in (4, 2):
        for d in designs:
            launch, evals = _joint_launches(d, degree, args.chunk, _layout_design)
            print(f"joint chunk of {args.chunk}, degree {degree}, layout {d}: {launch} kernel "
                  f"launches over {evals} LM evaluations = {launch / max(evals, 1):.1f} per "
                  f"evaluation")
    return 0


def compare_direct(args) -> int:
    """The direct path on the kernels against the eager chain it replaces,
    on the card (the module docstring)."""
    from mba_vo_tpu_torch.ops import residual

    knots, data = _frame_call()
    _weigh_designs(args, ("kernels", "eager"), _direct_design,
                   lambda: residual.compute_residuals(knots, data, 5, 2, True),
                   "direct compute_residuals (with J)", sampling="direct")
    return 0


@contextlib.contextmanager
def _lm_design(name: str):
    """The LM iteration's stages run K6-K8 ("kernels") or their plain
    versions on the card's tensors ("plain stages") inside the block."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.solver import lm

    stages = ("lm_step", "lm_decide", "lm_commit")
    saved = {k: getattr(lm, k) for k in stages}
    if name == "plain stages":
        for k in stages:
            setattr(lm, k, rk.lm_plain_fn(k))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(lm, k, fn)


def compare_lm(args) -> int:
    """The LM iteration's stages on K6-K8 against their plain versions on
    the card (the module docstring): the host's time to issue one
    iteration's three stages at the frame's shape (D = 12, N = 512, F = 1,
    P = 8), then the paired trackers."""
    import torch

    from mba_vo_tpu_torch.solver import lm

    gen = torch.Generator(device="cuda").manual_seed(0)
    opts = dict(device="cuda", dtype=torch.float32)
    A = torch.randn((12, 12), generator=gen, **opts)
    H = A @ A.T / 12 + torch.eye(12, **opts)
    g = 0.1 * torch.randn(12, generator=gen, **opts)
    t = 0.01 * torch.randn((2, 3), generator=gen, **opts)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0], [0.001, -0.002, 0.001, 1.0]], **opts)
    q = q / q.norm(dim=1, keepdim=True)
    sc = torch.zeros(lm.S_SIZE, **opts)
    sc[lm.S_COST:lm.S_CAND + 1] = 5.0
    sc[lm.S_RADIUS], sc[lm.S_DECREASE], sc[lm.S_ACD] = 1e4, 2.0, 1e10
    patch = torch.rand((1, 512), generator=gen, **opts) + 0.5
    ones = torch.ones(512, **opts)
    cost = patch.sum() * 4096
    state = lm.LMState(t, q, H.clone(), g.clone(), sc, ones.clone(), ones.clone(),
                       patch * 1e-3)
    o = lm.LMOptions()

    def iteration():
        st = state
        H1, _, ct, cq, scalars = lm.lm_step(st.H, st.g, st.scalars, st.t, st.q, o.solver)
        st = st._replace(scalars=scalars)
        scalars, mask, w = lm.lm_decide(cost, patch, st.kp_w, ones, st.scalars, 8, o)
        st = st._replace(scalars=scalars)
        return lm.lm_commit(st, H1, ct, cq, cost, g * 4096, H * 4096, patch, mask, w, 8, o,
                            True)

    _weigh_designs(args, ("kernels", "plain stages"), _lm_design, iteration,
                   "LM iteration (its three stages, no evaluation)")

    # K8's host call: the level's binding against the public wrapper
    from mba_vo_tpu_torch.ops import cuda_lm

    binding = cuda_lm.CommitBinding(state, 8, **lm.commit_options(o))

    @contextlib.contextmanager
    def commit_design(name: str):
        """K8 through the level's binding ("K8 bound", the tracker's route) or
        through lm_commit_cuda ("K8 checked in full": the dispatcher called
        without the binding it is given)."""
        saved = lm.lm_commit
        if name == "K8 checked in full":
            lm.lm_commit = lambda *a, binding=None: saved(*a)
        try:
            yield
        finally:
            lm.lm_commit = saved

    def bound_iteration():
        st = state
        H1, _, ct, cq, scalars = lm.lm_step(st.H, st.g, st.scalars, st.t, st.q, o.solver)
        st = st._replace(scalars=scalars)
        scalars, mask, w = lm.lm_decide(cost, patch, st.kp_w, ones, st.scalars, 8, o)
        st = st._replace(scalars=scalars)
        return lm.lm_commit(st, H1, ct, cq, cost, g * 4096, H * 4096, patch, mask, w, 8, o,
                            True, binding=binding)

    _weigh_designs(args, ("K8 bound", "K8 checked in full"), commit_design, bound_iteration,
                   "LM iteration (its three stages, no evaluation; K8's host call)")
    return 0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mba_vo_tpu_torch.ops import cuda_build
    from mba_vo_tpu_torch.ops import cuda_sampling as cs
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--joint", action="store_true",
                    help="profile track_frames_joint instead of track_frame")
    ap.add_argument("--chunk", type=int, default=4, help="frames per joint chunk")
    ap.add_argument("--k3-designs", action="store_true",
                    help="weigh K3's cluster and split designs on the per-frame path")
    ap.add_argument("--warp-designs", action="store_true",
                    help="weigh K2's first entry from the knots against the old path")
    ap.add_argument("--layout-designs", action="store_true",
                    help="weigh the patch layout K5 against its plain version")
    ap.add_argument("--direct", action="store_true",
                    help="weigh the direct path on the kernels against its eager chain")
    ap.add_argument("--lm-designs", action="store_true",
                    help="weigh the LM iteration on K6-K8 against its plain stages")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("profile_port: needs one CUDA GPU", file=sys.stderr)
        return 1
    print(card_line())
    cuda_build.build()
    if args.joint:
        return profile_joint(args)
    if args.k3_designs:
        return compare_k3(args)
    if args.warp_designs:
        return compare_warp(args)
    if args.layout_designs:
        return compare_layout(args)
    if args.direct:
        return compare_direct(args)
    if args.lm_designs:
        return compare_lm(args)
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
