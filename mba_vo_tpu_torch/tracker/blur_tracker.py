"""The blur-aware direct tracker: per-frame, chunked and joint multi-frame
orchestration.

Counterpart of ``mba_vo_tpu/tracker/blur_tracker.py``. Per frame
(``track_frame``):

  1. first frame: becomes the keyframe; the spline starts as identity knots
     spanning one exposure;
  2. later frames: constant-velocity prediction right-composes every knot
     and re-anchors the window at [t_cap - tau/2, ...];
  3. coarse-to-fine LM over the pyramid (``solver.lm.optimize_level``);
  4. keyframe decision from average optical flow and blur-kernel length,
     applied before the next frame is tracked; on a keyframe the tracked
     pose folds into the keyframe chain and the spline re-anchors to
     identity. With ``auto_recover`` a frame whose statistics are
     non-finite or insane is rejected and the pre-frame state restored.

The reference defers the keyframe decision to the next ``track_frame`` so
its device->host copy overlaps device work, and redoes the frame when the
decision changed the state. Eager torch has nothing to overlap, so the port
resolves the pending decision first and tracks the frame once: the result
is what the reference's redo reproduces.

``track_frames`` tracks a batch in chunks with the same results as
``track_frame`` per frame; ``track_frames_joint`` optimises each chunk as
one LM problem over a sliding knot window. Both keep the reference's host
protocol: chunks dispatched ahead of their statistics, optimistic state
advance, one device-to-host copy of a chunk's statistics, and a rollback to
any frame of a chunk when a keyframe or a failure fires. The reference
dispatches asynchronously, so ``inflight > 1`` overlaps the copy of one
chunk's statistics with the next chunk's compute. The LM here is a host
loop that syncs on every branch decision, so a dispatched chunk has
finished when its dispatch returns and ``inflight > 1`` overlaps nothing
yet: the protocol and its results are kept, and which mechanism (streams,
CUDA graphs) makes speculation pay on a GPU is left to a profile.

With a ``backend`` (``backend.vo_backend.VOBackend``) every new keyframe
is handed to it: the first keyframe without taking a result back, every
later one adopting the backend's refined pose as the keyframe anchor, from
the per-frame, the chunked and the joint path alike.

With ``shard_devices = n > 1`` the tracker runs in each of n processes of
a ``torch.distributed`` group (``parallel.mesh.make_mesh``): every rank
holds every keypoint and runs the whole tracker, and the LM of each level
sees the rank's keypoint slice and all-reduces its normal equations
(``parallel.sharded.optimize_level_shardmapped``). The level's outlier
mask and patch costs are gathered back to all keypoints, so every rank
makes the same keyframe and failure decisions.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.lie import quat_conjugate, quat_rotate
from ..core.spline import (
    SplineKnots,
    extrapolate_knot,
    identity_knots,
    make_knots,
    slide_control_window,
    spline_pose_at,
    spline_pose_at_times,
    spline_transform_by_right,
    spline_transform_to,
)
from ..core.transform import (
    Pose, pose_compose, pose_exp, pose_identity, pose_inverse, pose_log,
)
from ..ops.image import gradient_magnitude, image_gradients, image_pyramid
from ..ops.residual import TrackingLevelData
from ..ops.window_sampling import extract_windows, stack_image_channels
from ..solver.lm import LMOptions, optimize_level
from ..utils.failure import FailureEvent, stats_healthy
from .detector import DetectorOptions, detect_semidense
from .patterns import PATTERNS


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Tracker configuration; the fields and defaults of the reference's
    TrackerConfig."""

    num_pyramid_levels: int = 3
    num_virtual_poses: Tuple[int, ...] = (5, 5, 5)  # per level, fine->coarse
    patch_pattern: str = "dso8"
    max_keypoints: int = 512
    spline_degree: int = 2
    huber_a: float = 20.0
    max_chi_square_error: float = 3.0
    max_num_iterations: int = 50
    min_step_quality: float = 0.5
    min_abs_cost_decrease: float = 1e-3
    # "windowed" = per-keypoint keyframe windows (kernel K1 on CUDA);
    # "direct" = per-sample gather from the whole keyframe image
    sampling: str = "windowed"
    sampling_window: int = 32
    # knot smoothness prior; None = off for degree 2, 10.0 for degree 4
    knot_prior_weight: Optional[float] = None
    precision: str = "default"
    compensated_sum: bool = False
    # reject a frame whose statistics are non-finite or whose average flow
    # exceeds max_sane_flow px, restoring the pre-frame state
    auto_recover: bool = True
    max_sane_flow: float = 1e4
    keyframe_max_flow_mag0: float = 15.0
    keyframe_max_flow_mag1: float = 30.0
    keyframe_max_blur_kernel_mag: float = 3.0
    detector: DetectorOptions = DetectorOptions()
    min_keypoint_depth: float = 1e-2
    # cull keypoints whose patch support can leave the image
    keypoint_border_margin: int = 4
    dtype: str = "float32"
    # keypoint-sharded LM over the first n ranks of the default process
    # group (0/1 = one process; see the module docstring)
    shard_devices: int = 0
    # per-frame closed-form gain/bias elimination in the residual
    # (ops.residual.affine_correct)
    affine_brightness: bool = False

    def lm_options(self) -> LMOptions:
        w = self.knot_prior_weight
        if w is None:
            w = 0.0 if self.spline_degree <= 2 else 10.0
        return LMOptions(
            max_iterations=self.max_num_iterations,
            min_step_quality=self.min_step_quality,
            min_abs_cost_decrease=self.min_abs_cost_decrease,
            huber_a=self.huber_a,
            max_chi_square_error=self.max_chi_square_error,
            sampling=self.sampling,
            window=self.sampling_window,
            knot_prior_weight=w,
            precision=self.precision,
            compensated_sum=self.compensated_sum,
            affine_brightness=self.affine_brightness,
        )


def process_keyframe_levels(
    img0: torch.Tensor, depth: torch.Tensor, *, num_levels: int,
    det: DetectorOptions, margin: int, min_depth: float, window: int,
) -> List[dict]:
    """Keyframe pipeline: pyramid, gradients, per-level semi-dense detection,
    depth gathered at full-resolution coordinates (x = kpt.x * 2^lv + 0.5),
    border/min-depth masking and the per-level window caches.
    Returns one dict per level (img, grad, kp_xy, kp_z, kp_mask, wincache)."""
    dtype = img0.dtype
    Hd, Wd = depth.shape
    levels = []
    for lv, img in enumerate(image_pyramid(img0, num_levels)):
        grad = image_gradients(img)
        kp_xy, _resp, mask = detect_semidense(gradient_magnitude(grad), lv, det)
        scale = 2 ** lv
        # clamped: a keypoint on the last row/column rounds past the map
        xi = torch.clamp((kp_xy[:, 0] * scale + 0.5).to(torch.int64), 0, Wd - 1)
        yi = torch.clamp((kp_xy[:, 1] * scale + 0.5).to(torch.int64), 0, Hd - 1)
        z = depth[yi, xi].to(dtype)
        h_lv, w_lv = img.shape
        in_interior = (
            (kp_xy[:, 0] >= margin)
            & (kp_xy[:, 0] <= w_lv - 1 - margin)
            & (kp_xy[:, 1] >= margin)
            & (kp_xy[:, 1] <= h_lv - 1 - margin)
        )
        kp_mask = mask * (z >= min_depth).to(dtype) * in_interior.to(dtype)
        kp_xy = kp_xy.to(dtype)
        wins, starts = extract_windows(stack_image_channels(img, grad), kp_xy, window)
        levels.append(dict(img=img, grad=grad, kp_xy=kp_xy, kp_z=z,
                           kp_mask=kp_mask, wincache=(wins, starts)))
    return levels


def _keyframe_flow_stats(knots: SplineKnots, kp_xy, kp_z, kp_mask, K,
                         cap_time, exp_time, degree: int):
    """Average flow magnitude and blur-kernel length over level-0 keypoints."""
    P3d_ref = torch.stack(
        [
            kp_z * (kp_xy[:, 0] - K[2]) / K[0],
            kp_z * (kp_xy[:, 1] - K[3]) / K[1],
            kp_z,
        ],
        dim=-1,
    )
    # mid exposure, exposure start, exposure end
    times = torch.stack(
        [cap_time, cap_time - 0.5 * exp_time, cap_time + 0.5 * exp_time]
    )
    p = spline_pose_at_times(knots, times, degree)  # t [3,3], q [3,4]
    inv_q = quat_conjugate(p.q)
    P = quat_rotate(inv_q[:, None, :], P3d_ref[None] - p.t[:, None, :])  # [3,N,3]
    kpt = torch.stack(
        [P[..., 0] / P[..., 2] * K[0] + K[2], P[..., 1] / P[..., 2] * K[1] + K[3]],
        dim=-1,
    )  # [3, N, 2]
    n = torch.clamp(kp_mask.sum(), min=1.0)
    flow_sq = torch.sum(((kpt[0] - kp_xy) ** 2).sum(-1) * kp_mask) / n
    kern_sq = torch.sum(((kpt[1] - kpt[2]) ** 2).sum(-1) * kp_mask) / n
    return torch.sqrt(flow_sq), torch.sqrt(kern_sq)


def _pre_track(knots: SplineKnots, neigh_velocity, dt_frame, window_t0, knot_dt):
    """Constant-velocity prediction + window re-anchor."""
    d = pose_exp(neigh_velocity * dt_frame)
    knots = knots._replace(t0=window_t0, dt=knot_dt)
    return spline_transform_by_right(knots, d)


def _post_track(knots: SplineKnots, T_prev: Pose, cap_time, dt_frame,
                kp_xy, kp_z, kp_mask, K, exp_time, degree: int):
    """Pose at capture time, neighbour-frame velocity and keyframe
    statistics."""
    pose_cap = spline_pose_at(knots, cap_time, degree)
    d_neigh = pose_compose(pose_inverse(T_prev), pose_cap)
    neigh_velocity = pose_log(d_neigh) / torch.clamp(dt_frame, min=1e-9)
    avg_flow, avg_kernel = _keyframe_flow_stats(
        knots, kp_xy, kp_z, kp_mask, K, cap_time, exp_time, degree
    )
    return pose_cap, neigh_velocity, avg_flow, avg_kernel


def _keyframe_anchor(knots: SplineKnots, T_keyframe: Pose, pose_cap: Pose,
                     cap_time, degree: int):
    """Fold the tracked pose into the keyframe chain and re-anchor the spline
    to identity at capture time."""
    new_Tkf = pose_compose(T_keyframe, pose_cap)
    ident = pose_identity(knots.t.dtype, device=knots.t.device)
    return spline_transform_to(knots, cap_time, ident, degree), new_Tkf


def _run_level(knots, data, num_vir, degree, lm_opts, cache, lv, mesh=None):
    """One pyramid level of the coarse-to-fine cascade, shared by the
    per-frame and the joint path.

    ``mesh``: a ``parallel.mesh.Mesh`` routes the LM through the
    keypoint-sharded path (TrackerConfig.shard_devices).

    With ``affine_brightness`` the coarser levels run pure intensity, and
    the finest level runs pure intensity to convergence first and then an
    affine pass from that optimum: started far from the solution, the
    gain/bias-eliminated objective has shallow spurious optima."""
    def call(k, opts):
        if mesh is not None:
            from ..parallel.sharded import optimize_level_shardmapped

            fn = optimize_level_shardmapped(mesh, num_vir, degree, opts, cache is not None)
            return fn(k, data, cache)
        return optimize_level(k, data, num_vir, degree, opts, cache=cache)

    if lm_opts.affine_brightness:
        pure = dataclasses.replace(lm_opts, affine_brightness=False)
        if lv != 0:
            return call(knots, pure)
        knots, _ = call(knots, pure)
    return call(knots, lm_opts)


def _frame_step(knots: SplineKnots, neigh_velocity, T_prev: Pose, scalars,
                cur_img, kf_levels, pattern, K0, num_levels: int,
                num_virtual_poses, degree: int, lm_opts: LMOptions, mesh=None):
    """Track ONE frame against the fixed keyframe state: prediction, current
    pyramid, coarse-to-fine LM, pose/velocity/keyframe statistics.

    scalars: [5] tensor (dt_frame, cap_time, exp_time, window_t0, knot_dt)
    in the tracker's dtype, as the reference packs them."""
    dt_frame, cap_time, exp_time, window_t0, knot_dt = scalars.unbind()
    knots = _pre_track(knots, neigh_velocity, dt_frame, window_t0, knot_dt)

    pyr = image_pyramid(cur_img, num_levels)
    summaries = []
    for i in range(num_levels):
        lv = num_levels - 1 - i
        kl = kf_levels[lv]
        data = _level_data(kl, pyr[lv][None], cap_time[None], exp_time[None],
                           pattern, K0, lv)
        knots, summary = _run_level(knots, data, num_virtual_poses[lv], degree,
                                    lm_opts, kl["wincache"], lv, mesh)
        summaries.append((lv, summary))

    kl0 = kf_levels[0]
    pose_cap, neigh_velocity, avg_flow, avg_kernel = _post_track(
        knots, T_prev, cap_time, dt_frame, kl0["kp_xy"], kl0["kp_z"],
        kl0["kp_mask"], K0, exp_time, degree,
    )
    # [flow, blur kernel, finest-level LM cost]: a corrupted frame leaves a
    # non-finite cost even where the rejected-step path keeps knots finite
    stats = torch.stack([avg_flow, avg_kernel,
                         summaries[-1][1].final_cost.to(avg_flow.dtype)])
    return knots, pose_cap, neigh_velocity, stats, summaries


def _level_data(kl: dict, cur_imgs, cap_times, exp_times, pattern, K0, lv: int):
    return TrackingLevelData(
        img_ref=kl["img"], grad_ref=kl["grad"], cur_imgs=cur_imgs,
        cap_times=cap_times, exp_times=exp_times, kp_xy=kl["kp_xy"],
        kp_z=kl["kp_z"], kp_mask=kl["kp_mask"], pattern=pattern,
        K=K0 / (2.0 ** lv),
    )


def _track_chunk(knots: SplineKnots, neigh_velocity, T_prev: Pose,
                 T_keyframe: Pose, scalars, cur_imgs, kf_levels, pattern, K0,
                 num_levels: int, num_virtual_poses, degree: int,
                 lm_opts: LMOptions, mesh=None):
    """Track a chunk of consecutive frames against a fixed keyframe, each
    frame from its predecessor's state (the reference's ``lax.scan`` over
    the frame step, as a loop).

    scalars: [C, 5] per-frame rows as in :func:`_frame_step`; cur_imgs: the
    C frames. Returns (host_pack [C, 10] on the device = per frame (flow,
    blur kernel, LM cost, result t[3], result q[4]), iters: per frame the LM
    iterations of each level coarse to fine, states: per frame the
    post-frame (knots, velocity, pose at capture), which lets the caller
    put the tracker back to any frame of the chunk)."""
    rows, iters, states = [], [], []
    for sc, img in zip(scalars, cur_imgs):
        knots, pose_cap, neigh_velocity, stats, summaries = _frame_step(
            knots, neigh_velocity, T_prev, sc, img, kf_levels, pattern, K0,
            num_levels, num_virtual_poses, degree, lm_opts, mesh,
        )
        T_prev = pose_cap
        result = pose_compose(T_keyframe, pose_cap)
        rows.append(torch.cat([stats, result.t, result.q]))
        iters.append([s.num_iterations for _, s in summaries])
        states.append((knots, neigh_velocity, pose_cap))
    return torch.stack(rows), iters, states


def _track_joint_window(knots: SplineKnots, T_keyframe: Pose, n_slide: int,
                        caps, exps, cur_imgs, kf_levels, pattern, K0,
                        num_levels: int, num_virtual_poses, degree: int,
                        lm_opts: LMOptions, mesh=None):
    """Joint multi-frame window tracking: ONE LM problem over a C-frame
    chunk with a sliding K-knot spline window.

      1. the window advances ``n_slide`` knots, each by pop-front + append
         of the constant-velocity extrapolation of the last two knots;
      2. every frame's exposure lies inside the fixed-dt window (caps and
         exps are per-frame tensors: no uniform spacing is assumed), so the
         multi-frame residual couples consecutive frames through shared
         knots;
      3. coarse-to-fine LM over the whole window;
      4. per-frame statistics (flow, blur kernel, the frame's share of the
         finest level's final patch costs) come back in one packed tensor.

    cur_imgs: [C, H, W]. Returns (knots, host_pack [C, 10] on the device =
    per frame (flow, kernel, cost, result t[3], result q[4]))."""
    dtype = knots.t.dtype
    for _ in range(n_slide):
        p = extrapolate_knot(knots)
        knots = slide_control_window(knots, p.t, p.q)

    pyr = image_pyramid(cur_imgs, num_levels)
    summary = None
    for i in range(num_levels):
        lv = num_levels - 1 - i
        data = _level_data(kf_levels[lv], pyr[lv], caps, exps, pattern, K0, lv)
        knots, summary = _run_level(knots, data, num_virtual_poses[lv], degree,
                                    lm_opts, kf_levels[lv]["wincache"], lv, mesh)
    # per-frame photometric costs, so the health check can tell which frame
    # of the chunk diverged
    frame_costs = summary.patch_costs.sum(dim=1).to(dtype)  # [C]

    pose_caps = spline_pose_at_times(knots, caps, degree)
    results = pose_compose(
        Pose(t=T_keyframe.t[None], q=T_keyframe.q[None]), pose_caps)
    kl0 = kf_levels[0]
    stats = [_keyframe_flow_stats(knots, kl0["kp_xy"], kl0["kp_z"],
                                  kl0["kp_mask"], K0, c, e, degree)
             for c, e in zip(caps, exps)]
    flow = torch.stack([f for f, _ in stats])
    kern = torch.stack([k for _, k in stats])
    host_pack = torch.cat(
        [flow[:, None], kern[:, None], frame_costs[:, None], results.t, results.q],
        dim=1,
    )
    return knots, host_pack


def _first_events(stats, costs, c: int, cfg: TrackerConfig, has_candidate):
    """(bad, reason, fired) of a chunk's first ``c`` frames: the first frame
    that fails the health check (-1: none) with its reason, and the first
    frame before it whose statistics fire the keyframe criterion and that
    has keyframe candidate data (-1: none). On the same frame the failure
    wins; an earlier keyframe beats a later failure."""
    bad, reason = -1, None
    if cfg.auto_recover:
        for r in range(c):
            ok, why = stats_healthy(float(stats[r, 0]), float(stats[r, 1]),
                                    cfg.max_sane_flow, float(costs[r]))
            if not ok:
                bad, reason = r, why
                break
    fired = -1
    for r in range(c if bad < 0 else bad):
        flow, kern = float(stats[r, 0]), float(stats[r, 1])
        is_kf = (
            flow > cfg.keyframe_max_flow_mag0
            and kern < cfg.keyframe_max_blur_kernel_mag
        ) or flow > cfg.keyframe_max_flow_mag1
        if is_kf and has_candidate(r):
            fired = r
            break
    return bad, reason, fired


class BlurAwareTracker:
    """Frame-to-keyframe blur-aware tracking with a global keyframe chain.

    ``device``: where every tensor of the tracker lives ("cuda" by default).
    A CUDA device without a visible GPU raises; the tracker never moves to
    the CPU on its own. On CUDA, TF32 is switched off so float32 means
    float32.

    ``config.shard_devices = n > 1`` builds ``mesh`` over the first n ranks
    of the initialised default process group (every rank of it constructs
    the tracker); the keypoint count must be a multiple of n.
    """

    def __init__(self, config: TrackerConfig, K: np.ndarray,
                 im_hw: Tuple[int, int], backend=None, device="cuda"):
        self.mesh = None
        if config.shard_devices and config.shard_devices > 1:
            from ..parallel.mesh import make_mesh

            n = int(config.shard_devices)
            if config.detector.max_keypoints % n:
                raise ValueError(
                    f"detector.max_keypoints ({config.detector.max_keypoints}) must be "
                    f"a multiple of shard_devices ({n}): keypoint shards must be equal "
                    "(parallel.mesh pad-and-mask)")
            self.mesh = make_mesh(n)
        if config.sampling not in ("windowed", "direct"):
            raise ValueError(f"unknown sampling {config.sampling!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "BlurAwareTracker(device='cuda') but no CUDA device is "
                    "visible; pass device='cpu' to run on the CPU")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = config
        self.backend = backend
        self.dtype = torch.float32 if config.dtype == "float32" else torch.float64
        self.K0 = torch.as_tensor(np.asarray(K), dtype=self.dtype, device=self.device)
        self.im_hw = im_hw
        self.pattern = torch.as_tensor(PATTERNS[config.patch_pattern](),
                                       device=self.device)

        self.keyframe_levels: List[dict] = []
        self.knots: Optional[SplineKnots] = None
        self.is_first_frame = True
        self.prev_timestamp = 0.0
        self.T_prev_b2w = pose_identity(self.dtype, device=self.device)
        self.T_keyframe = pose_identity(self.dtype, device=self.device)
        self.neigh_velocity = torch.zeros(6, dtype=self.dtype, device=self.device)
        # set when a frame's deferred decision resolves (flush): after
        # track_frame it lags one frame behind
        self.avg_kernel_length = 1e3
        # after track_frame: [(level, LMSummary)] coarse to fine; after
        # track_frames: [(level, LM iterations)] of the last committed frame
        self.last_summaries: list = []
        # per-frame (flow, blur kernel) of the frames committed by the last
        # track_frames / track_frames_joint call, aligned with its poses
        # ((0, 0) for a bootstrap frame, NaN for a rejected frame)
        self.last_track_stats: Optional[np.ndarray] = None
        # optional per-frame commit hook of track_frames and
        # track_frames_joint: cb(batch_index, knots_or_None), called while
        # the keyframe the frame was tracked against is still installed,
        # with that frame's knot window (None for a rejected frame)
        self.frame_callback = None
        # joint multi-frame window and the host float dt it was created with
        self._joint_knots: Optional[SplineKnots] = None
        self._joint_dt: Optional[float] = None
        # deferred keyframe decision of the last tracked frame: (stats,
        # pose_cap, cap_time, sharp_img, depth_map, pre-frame snapshot)
        self._pending: Optional[tuple] = None
        self.failure_log: list = []

    def _tensor(self, x) -> torch.Tensor:
        """An image, depth map or scalar array on the tracker's device in its
        dtype; a tensor is cast and moved (an undistorted frame stays on
        the device it was remapped on)."""
        if isinstance(x, torch.Tensor):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.tensor(np.asarray(x), dtype=self.dtype, device=self.device)

    # ------------------------------------------------------------ keyframe

    def process_keyframe(self, sharp_img: np.ndarray, depth_map: np.ndarray):
        """Pyramids + gradients + semi-dense detection + depth ingestion +
        window-cache extraction for a new keyframe."""
        if sharp_img is None or depth_map is None:
            raise ValueError(
                "keyframe processing needs a sharp image and a depth map")
        cfg = self.cfg
        self.keyframe_levels = process_keyframe_levels(
            self._tensor(sharp_img), self._tensor(depth_map),
            num_levels=cfg.num_pyramid_levels, det=cfg.detector,
            margin=cfg.keypoint_border_margin,
            min_depth=cfg.min_keypoint_depth, window=cfg.sampling_window,
        )

    # ------------------------------------------------------------- tracking

    def track_frame(
        self,
        sharp_img: Optional[np.ndarray],
        blur_img: np.ndarray,
        cap_time: float,
        exp_time: float,
        depth_map: Optional[np.ndarray] = None,
    ) -> Pose:
        """Track one frame; returns the global body-to-world pose at capture
        time. sharp_img/depth_map are the frame's keyframe candidate data."""
        cfg = self.cfg
        if self.is_first_frame:
            self.is_first_frame = False
            self.process_keyframe(sharp_img, depth_map)
            self.prev_timestamp = cap_time
            # degree knots = one spline segment spanning the exposure
            self.knots = identity_knots(
                max(2, cfg.spline_degree), t0=cap_time,
                dt=max(exp_time, 1e-3), dtype=self.dtype, device=self.device,
            )
            if self.backend is not None:
                # the first keyframe anchors the chain: nothing to adopt
                self.backend.on_keyframe(sharp_img, depth_map, self.T_keyframe, cap_time)
            return self.T_keyframe

        # resolve the previous frame's keyframe/failure decision first
        self.flush()
        dt_frame = cap_time - self.prev_timestamp
        out = self._submit(self._tensor(blur_img), cap_time, exp_time, dt_frame)

        snapshot = (self.knots, self.neigh_velocity, self.T_prev_b2w,
                    self.prev_timestamp)
        (self.knots, pose_cap, result, self.neigh_velocity, stats,
         self.last_summaries) = out
        self.T_prev_b2w = pose_cap
        self._pending = (stats, pose_cap, cap_time, sharp_img, depth_map,
                         snapshot)
        self.prev_timestamp = cap_time
        return result

    def _bootstrap_batch(self, blur_imgs, cap_times, exp_times, get_sharp,
                         get_depth, results, committed_stats) -> int:
        """Shared head of the batch entry points: the first frame of a fresh
        tracker becomes the keyframe through track_frame, and any deferred
        single-frame decision is resolved. Returns the next frame index."""
        i = 0
        if self.is_first_frame:
            results.append(self.track_frame(
                get_sharp(0), blur_imgs[0], float(cap_times[0]),
                float(exp_times[0]), get_depth(0)))
            # the bootstrap frame has no tracked statistics
            committed_stats.append(np.array([0.0, 0.0]))
            if self.frame_callback is not None:
                self.frame_callback(0, self.knots)
            i = 1
        self.flush()
        return i

    def _reject(self, results, committed_stats, cap_time: float, reason: str,
                avg_flow: float, avg_kernel: float):
        """Give a rejected frame its output slot (the last good global pose
        again), NaN statistics and a failure-log entry."""
        results.append(results[-1] if results else self.T_keyframe)
        committed_stats.append(np.array([np.nan, np.nan]))
        if self.frame_callback is not None:
            self.frame_callback(len(results) - 1, None)
        self.failure_log.append(FailureEvent(
            cap_time=cap_time, reason=reason, avg_flow=avg_flow,
            avg_kernel=avg_kernel))

    def track_frames(
        self,
        blur_imgs,
        cap_times,
        exp_times,
        sharp_imgs=None,
        depth_maps=None,
        chunk: int = 8,
        inflight: int = 2,
    ) -> List[Pose]:
        """Track a batch of frames in chunks of ``chunk`` frames.

        Same results as calling :meth:`track_frame` per frame. A chunk runs
        against a fixed keyframe; the host reads its per-frame statistics in
        one device-to-host copy and, if frame j fires the keyframe criterion
        or fails the health check, commits the frames before the event, puts
        the tracker back to that frame's state and re-tracks the rest.
        ``inflight`` chunks are dispatched ahead of their statistics, each
        from its predecessor's final state (optimistic advance); an event
        discards them. ``inflight=1`` is the strictly sequential schedule
        and gives the same results (see the module docstring on what
        speculation overlaps in this port).

        blur_imgs: [T, H, W] array or list; cap_times/exp_times: [T] floats;
        sharp_imgs/depth_maps: optional per-frame keyframe candidate data
        (lists, entries may be None). Returns the T global body-to-world
        poses as ``Pose``s of tensors on the tracker's device, as
        ``track_frame`` does; a rejected frame repeats the last good pose.
        """
        cfg = self.cfg
        n = len(cap_times)
        get_sharp = (lambda i: sharp_imgs[i]) if sharp_imgs is not None else (
            lambda i: None)
        get_depth = (lambda i: depth_maps[i]) if depth_maps is not None else (
            lambda i: None)

        results: List[Pose] = []
        committed_stats: List[np.ndarray] = []
        cb = self.frame_callback
        i_next = self._bootstrap_batch(blur_imgs, cap_times, exp_times,
                                       get_sharp, get_depth, results,
                                       committed_stats)
        inflight = max(1, int(inflight))
        pending: deque = deque()

        def _dispatch(i0: int):
            c = min(chunk, n - i0)
            scal = np.empty((c, 5), np.float64)
            prev_t = self.prev_timestamp
            for r in range(c):
                cap, exp = float(cap_times[i0 + r]), float(exp_times[i0 + r])
                dt = cap - prev_t
                scal[r] = (dt, cap, exp, cap - 0.5 * exp, self._knot_dt(dt, exp))
                prev_t = cap
            imgs = [self._tensor(blur_imgs[j]) for j in range(i0, i0 + c)]
            pre_chunk = (self.knots, self.neigh_velocity, self.T_prev_b2w,
                         self.prev_timestamp)
            out = _track_chunk(
                self.knots, self.neigh_velocity, self.T_prev_b2w,
                self.T_keyframe, self._tensor(scal), imgs,
                self.keyframe_levels, self.pattern, self.K0,
                cfg.num_pyramid_levels, cfg.num_virtual_poses,
                cfg.spline_degree, cfg.lm_options(), self.mesh,
            )
            # optimistic advance: the next chunk starts from this one's end
            self.knots, self.neigh_velocity, self.T_prev_b2w = out[2][-1]
            self.prev_timestamp = float(cap_times[i0 + c - 1])
            return i0, c, out, pre_chunk

        def _commit(pack_dev, stats_np, states, r):
            results.append(Pose(t=pack_dev[r, 3:6], q=pack_dev[r, 6:10]))
            committed_stats.append(stats_np[r])
            if cb is not None:
                cb(len(results) - 1, states[r][0])

        while i_next < n or pending:
            while i_next < n and len(pending) < inflight:
                entry = _dispatch(i_next)
                i_next += entry[1]
                pending.append(entry)

            i, c, (pack_dev, iters, states), pre_chunk = pending.popleft()
            # ONE device->host copy per chunk
            pack = pack_dev.cpu().numpy()
            stats_np, costs_np = pack[:, :2], pack[:, 2]
            bad, reason, fired = _first_events(
                stats_np, costs_np, c, cfg,
                lambda r: get_sharp(i + r) is not None
                and get_depth(i + r) is not None)

            if bad >= 0 and fired < 0:
                # commit the frames before the failure, restore the state of
                # the last good frame, and go on after the rejected one
                for r in range(bad):
                    _commit(pack_dev, stats_np, states, r)
                if bad > 0:
                    self.knots, self.neigh_velocity, self.T_prev_b2w = states[bad - 1]
                    self.prev_timestamp = float(cap_times[i + bad - 1])
                else:
                    (self.knots, self.neigh_velocity, self.T_prev_b2w,
                     self.prev_timestamp) = pre_chunk
                self._reject(results, committed_stats, float(cap_times[i + bad]),
                             reason, float(stats_np[bad, 0]), float(stats_np[bad, 1]))
                # later chunks extended the rejected trajectory
                pending.clear()
                i_next = i + bad + 1
                continue

            commit = c if fired < 0 else fired + 1
            for r in range(commit):
                _commit(pack_dev, stats_np, states, r)
            last = commit - 1
            n_lv = cfg.num_pyramid_levels
            self.last_summaries = [
                (n_lv - 1 - k, int(iters[last][k])) for k in range(n_lv)]
            self.avg_kernel_length = float(stats_np[last, 1])

            if fired >= 0:
                # roll back to the fired frame: the optimistic state and any
                # later chunk went past it
                self.knots, self.neigh_velocity, pose_cap_last = states[last]
                self.prev_timestamp = float(cap_times[i + last])
                j = i + fired
                self.process_keyframe(get_sharp(j), get_depth(j))
                self.knots, self.T_keyframe = _keyframe_anchor(
                    self.knots, self.T_keyframe, pose_cap_last,
                    torch.tensor(float(cap_times[j]), dtype=self.dtype,
                                 device=self.device),
                    cfg.spline_degree,
                )
                self.T_prev_b2w = pose_identity(self.dtype, device=self.device)
                self._backend_keyframe(get_sharp(j), get_depth(j), float(cap_times[j]))
                pending.clear()
                i_next = i + commit
            # no event: the optimistic advance is the committed state
        self.last_track_stats = (
            np.stack(committed_stats) if committed_stats else None)
        return results

    def _joint_valid_range(self, knots: SplineKnots) -> Tuple[float, float]:
        """Host mirror of the joint window's valid sample range: the
        non-extrapolated support [t0, t0 + (K - degree + 1) dt] of the
        segment clamp in core.spline.spline_segment_start_and_u. t0 and dt
        are read as the stored dtype holds them (float32 rounds dt by about
        1e-8 relative), so the host slides the window where the device-side
        spline needs it."""
        deg = self.cfg.spline_degree
        t0 = knots.t0.item()
        dt = knots.dt.item()
        return t0, t0 + (knots.num_knots - deg + 1) * dt

    def track_frames_joint(
        self,
        blur_imgs,
        cap_times,
        exp_times,
        sharp_imgs=None,
        depth_maps=None,
        chunk: int = 4,
        inflight: int = 3,
    ) -> List[Pose]:
        """Joint multi-frame window tracking.

        Chunks of ``chunk`` frames are optimised as ONE LM problem over a
        sliding (chunk + degree - 1)-knot spline window (see
        :func:`_track_joint_window`), under the protocol of
        :meth:`track_frames`:

          * a keyframe decision fires from the chunk's statistics; the
            window re-anchors to identity at the fired frame, the pose folds
            into the global chain and the rest re-tracks against the new
            keyframe;
          * an unhealthy frame is rejected: the frames before it are
            committed, the pre-chunk window restored, the last good pose
            held, and tracking resumes after the gap (the knot slide absorbs
            it). Non-finite input frames are screened on the host and never
            enter a chunk, since one would poison every frame of it;
          * frame timing and exposures may vary: the knot interval is fixed
            when the window is created and the host slides the window an
            integer number of knots per chunk;
          * a short last chunk is padded by repeating its last frame. The
            repeated frames are residuals of the one LM problem, so the
            padding is part of the result;
          * ``inflight`` chunks are dispatched ahead of their statistics; an
            event discards them, and ``inflight=1`` gives the same results.

        The first frame of a fresh tracker bootstraps the keyframe through
        ``track_frame``. Returns the global body-to-world poses of all
        frames as ``Pose``s of tensors on the tracker's device; a rejected
        frame repeats the last good pose.
        """
        cfg = self.cfg
        n = len(cap_times)
        get_sharp = (lambda i: sharp_imgs[i]) if sharp_imgs is not None \
            else (lambda i: None)
        get_depth = (lambda i: depth_maps[i]) if depth_maps is not None \
            else (lambda i: None)

        results: List[Pose] = []
        committed_stats: List[np.ndarray] = []
        cb = self.frame_callback
        i = self._bootstrap_batch(blur_imgs, cap_times, exp_times, get_sharp,
                                  get_depth, results, committed_stats)

        # window geometry: K = chunk + degree - 1 knots, exactly the knots a
        # chunk's exposures observe under uniform timing
        deg = cfg.spline_degree
        K = chunk + deg - 1
        dts = np.diff(np.asarray(cap_times, np.float64))
        med = float(np.median(dts)) if len(dts) else 0.0
        max_exp = float(np.max(np.asarray(exp_times)))
        dt = float(max(med, max_exp, 1e-3))
        # recreation gate: against the HOST float dt the window was created
        # with and a loose relative tolerance, not against the dtype-rounded
        # knots.dt (float32 storage would make a tight gate fire on every
        # call and reset the window at every batch boundary)
        prev_dt = self._joint_dt
        rebuild = (
            self._joint_knots is None
            or self._joint_knots.num_knots != K
            or prev_dt is None
            or abs(prev_dt - dt) > 0.25 * prev_dt
        )
        if not rebuild and (chunk - 1) * med + max_exp > chunk * prev_dt * (1 + 1e-9):
            # the kept timing must still cover a full chunk of the incoming
            # cadence within the window's `chunk` knot intervals
            rebuild = True
        if not rebuild:
            dt = prev_dt
        else:
            t0 = float(cap_times[i if i < n else 0]) - 0.5 * max_exp
            old = self._joint_knots
            if old is not None:
                # re-timing with live state: rebuild the window constant at
                # the current pose (sampled at the resume frame's capture,
                # clamped into the old window's support)
                lo, hi = self._joint_valid_range(old)
                t_c = float(np.clip(float(cap_times[min(i, n - 1)]), lo, hi))
                p = spline_pose_at(old, t_c, deg)
                self._joint_knots = make_knots(
                    p.t[None, :].repeat(K, 1), p.q[None, :].repeat(K, 1),
                    t0=t0, dt=dt)
            else:
                self._joint_knots = identity_knots(
                    K, t0=t0, dt=dt, dtype=self.dtype, device=self.device)
            self._joint_dt = dt
        max_slide = 4 * K

        base = cfg.lm_options()
        # a cold multi-frame window's first Gauss-Newton step often
        # overshoots: retry with a smaller radius instead of ending the
        # level; a light knot prior keeps weakly observed knots conditioned
        # under non-uniform timing; the patch layout is re-anchored per
        # iteration because a window goes cold at a keyframe switch
        lm_opts = dataclasses.replace(
            base, retry_rejected_steps=True,
            knot_prior_weight=max(base.knot_prior_weight, 1.0),
            hoist_layout=False,
        )

        inflight = max(1, int(inflight))
        pending: deque = deque()
        i_next = i
        bad_cache: Dict[int, bool] = {}

        def _input_bad(j: int) -> bool:
            if j not in bad_cache:
                img = blur_imgs[j]
                bad_cache[j] = not bool(
                    torch.isfinite(img).all() if isinstance(img, torch.Tensor)
                    else np.isfinite(np.asarray(img)).all())
            return bad_cache[j]

        def _dispatch(i0: int, c: int):
            idx = list(range(i0, i0 + c)) + [i0 + c - 1] * (chunk - c)
            caps = np.asarray([float(cap_times[j]) for j in idx])
            exps = np.asarray([float(exp_times[j]) for j in idx])
            # integer knot slide so every exposure fits the valid range
            lo, hi = self._joint_valid_range(self._joint_knots)
            need_hi = float(caps[-1] + 0.5 * exps[-1])
            need_lo = float(caps[0] - 0.5 * exps[0])
            # 1e-6-knot tolerance: hi comes from window times stored in the
            # tracker's dtype, and an early slide can push need_lo out
            m = max(0, int(np.ceil((need_hi - hi) / dt - 1e-6)))
            if m > max_slide:
                raise RuntimeError(
                    f"joint window must slide {m} > {max_slide} knots: the "
                    "frame-time gap exceeds the window's reach; re-bootstrap "
                    "or increase chunk size")
            if need_lo < lo + m * dt - 1e-6 * dt:
                raise RuntimeError(
                    "joint window cannot cover the chunk: exposure span "
                    f"[{need_lo:.4f}, {need_hi:.4f}] vs window "
                    f"[{lo + m * dt:.4f}, {hi + m * dt:.4f}]: chunk span "
                    "exceeds (K - degree + 1) knot intervals")
            imgs = torch.stack([self._tensor(blur_imgs[j]) for j in idx])
            snapshot = self._joint_knots
            knots_fin, pack_dev = _track_joint_window(
                self._joint_knots, self.T_keyframe, m, self._tensor(caps),
                self._tensor(exps), imgs, self.keyframe_levels, self.pattern,
                self.K0, cfg.num_pyramid_levels, cfg.num_virtual_poses, deg,
                lm_opts, self.mesh,
            )
            self._joint_knots = knots_fin   # optimistic advance
            return i0, c, knots_fin, pack_dev, snapshot

        while i_next < n or pending:
            while i_next < n and len(pending) < inflight:
                if cfg.auto_recover and _input_bad(i_next):
                    pending.append(("reject", i_next))
                    i_next += 1
                    continue
                c = min(chunk, n - i_next)
                if cfg.auto_recover:
                    for k in range(1, c):
                        if _input_bad(i_next + k):
                            c = k
                            break
                pending.append(("chunk",) + _dispatch(i_next, c))
                i_next += c

            head = pending.popleft()
            if head[0] == "reject":
                self._reject(results, committed_stats, float(cap_times[head[1]]),
                             "non-finite input frame", float("nan"), float("nan"))
                continue

            _tag, i, c, knots_fin, pack_dev, snapshot = head
            pack = pack_dev.cpu().numpy()    # ONE copy per chunk
            stats_np, costs_np = pack[:, :2], pack[:, 2]
            bad, reason, fired = _first_events(
                stats_np, costs_np, c, cfg,
                lambda r: get_sharp(i + r) is not None
                and get_depth(i + r) is not None)

            commit = bad if (bad >= 0 and fired < 0) else (
                c if fired < 0 else fired + 1)
            for r in range(commit):
                results.append(Pose(t=pack_dev[r, 3:6], q=pack_dev[r, 6:10]))
                committed_stats.append(stats_np[r])
                if cb is not None:
                    cb(len(results) - 1, knots_fin)

            if bad >= 0 and fired < 0:
                # the healthy frames before the failure were optimised
                # together with it and are committed all the same; restore
                # the pre-chunk window and resume after the rejected frame
                self._joint_knots = snapshot
                self._reject(results, committed_stats, float(cap_times[i + bad]),
                             reason, float(stats_np[bad, 0]), float(stats_np[bad, 1]))
                pending.clear()
                i_next = i + bad + 1
                continue

            self.avg_kernel_length = float(stats_np[commit - 1, 1])
            if fired >= 0:
                # keyframe switch: fold pose(cap_fired) into the global
                # chain, re-anchor the WINDOW to identity there, process the
                # new keyframe, and re-track the rest against it
                j = i + fired
                cap_j = torch.tensor(float(cap_times[j]), dtype=self.dtype,
                                     device=self.device)
                pose_j = spline_pose_at(knots_fin, cap_j, deg)
                self.process_keyframe(get_sharp(j), get_depth(j))
                self.T_keyframe = pose_compose(self.T_keyframe, pose_j)
                self._joint_knots = spline_transform_to(
                    knots_fin, cap_j,
                    pose_identity(self.dtype, device=self.device), deg)
                self._backend_keyframe(get_sharp(j), get_depth(j), float(cap_times[j]))
                pending.clear()
                i_next = i + commit
            # no event: the optimistic knot advance is the committed state
        self.last_track_stats = (
            np.stack(committed_stats) if committed_stats else None)
        return results

    def _knot_dt(self, dt_frame: float, exp_time: float) -> float:
        """Per-frame knot interval: the frame interval for degree 2 (never
        below the exposure), the exposure itself for degree 4."""
        if self.cfg.spline_degree >= 4:
            return max(exp_time, 1e-3)
        return max(dt_frame, exp_time, 1e-3)

    def _submit(self, blur: torch.Tensor, cap_time: float, exp_time: float,
                dt_frame: float):
        """Track one frame against the current state without mutating it."""
        cfg = self.cfg
        scalars = torch.tensor(
            [dt_frame, cap_time, exp_time, cap_time - 0.5 * exp_time,
             self._knot_dt(dt_frame, exp_time)],
            dtype=self.dtype, device=self.device,
        )
        knots, pose_cap, neigh_velocity, stats, summaries = _frame_step(
            self.knots, self.neigh_velocity, self.T_prev_b2w, scalars, blur,
            self.keyframe_levels, self.pattern, self.K0,
            cfg.num_pyramid_levels, cfg.num_virtual_poses, cfg.spline_degree,
            cfg.lm_options(), self.mesh,
        )
        result = pose_compose(self.T_keyframe, pose_cap)
        return knots, pose_cap, result, neigh_velocity, stats, summaries

    def flush(self) -> bool:
        """Apply the deferred keyframe/failure decision of the last tracked
        frame (no-op when none is pending). Returns True iff it changed the
        tracker state (keyframe installed or frame rejected). Called inside
        track_frame; call it at sequence end if the final frame's keyframe
        state matters."""
        if self._pending is None:
            return False
        stats, pose_cap, cap_time, sharp_img, depth_map, snapshot = self._pending
        self._pending = None
        cfg = self.cfg
        avg_flow, avg_kernel, lm_cost = stats.tolist()

        if cfg.auto_recover:
            ok, reason = stats_healthy(avg_flow, avg_kernel, cfg.max_sane_flow,
                                       lm_cost)
            if not ok:
                (self.knots, self.neigh_velocity, self.T_prev_b2w,
                 self.prev_timestamp) = snapshot
                self.failure_log.append(FailureEvent(
                    cap_time=cap_time, reason=reason,
                    avg_flow=avg_flow, avg_kernel=avg_kernel,
                ))
                return True

        self.avg_kernel_length = avg_kernel
        is_keyframe = (
            avg_flow > cfg.keyframe_max_flow_mag0
            and self.avg_kernel_length < cfg.keyframe_max_blur_kernel_mag
        ) or avg_flow > cfg.keyframe_max_flow_mag1
        if is_keyframe and sharp_img is not None and depth_map is not None:
            self.process_keyframe(sharp_img, depth_map)
            self.knots, self.T_keyframe = _keyframe_anchor(
                self.knots, self.T_keyframe, pose_cap,
                torch.tensor(cap_time, dtype=self.dtype, device=self.device),
                cfg.spline_degree,
            )
            self.T_prev_b2w = pose_identity(self.dtype, device=self.device)
            self._backend_keyframe(sharp_img, depth_map, cap_time)
            return True
        return False

    def _backend_keyframe(self, sharp_img, depth_map, cap_time: float):
        """Hand the freshly installed keyframe to the backend and adopt its
        refined pose (float64 arrays) as the new chain anchor."""
        if self.backend is None:
            return
        refined = self.backend.on_keyframe(sharp_img, depth_map, self.T_keyframe, cap_time)
        if refined is not None:
            self.T_keyframe = Pose(t=self._tensor(refined.t), q=self._tensor(refined.q))
