"""The blur-aware direct tracker: per-frame orchestration.

Counterpart of ``mba_vo_tpu/tracker/blur_tracker.py`` (``track_frame`` and
what it runs). Per frame:

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

Not ported yet (each raises ``NotImplementedError``; see ROADMAP.md):
``track_frames``, ``track_frames_joint``, ``sampling="direct"``,
``affine_brightness``, ``shard_devices > 1`` and a ``backend``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.lie import quat_conjugate, quat_rotate
from ..core.spline import (
    SplineKnots,
    identity_knots,
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


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported to mba_vo_tpu_torch yet (see ROADMAP.md)")


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
    sampling: str = "windowed"  # only "windowed" is ported
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
    shard_devices: int = 0  # not ported beyond 0/1
    affine_brightness: bool = False  # not ported

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


def _run_level(knots, data, num_vir, degree, lm_opts, cache, lv):
    """One pyramid level of the coarse-to-fine cascade (the reference's
    affine cascade is not ported)."""
    return optimize_level(knots, data, num_vir, degree, lm_opts, cache=cache)


def _frame_step(knots: SplineKnots, neigh_velocity, T_prev: Pose, scalars,
                cur_img, kf_levels, pattern, K0, num_levels: int,
                num_virtual_poses, degree: int, lm_opts: LMOptions):
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
        data = TrackingLevelData(
            img_ref=kl["img"],
            grad_ref=kl["grad"],
            cur_imgs=pyr[lv][None],
            cap_times=cap_time[None],
            exp_times=exp_time[None],
            kp_xy=kl["kp_xy"],
            kp_z=kl["kp_z"],
            kp_mask=kl["kp_mask"],
            pattern=pattern,
            K=K0 / (2.0 ** lv),
        )
        knots, summary = _run_level(knots, data, num_virtual_poses[lv], degree,
                                    lm_opts, kl["wincache"], lv)
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


class BlurAwareTracker:
    """Frame-to-keyframe blur-aware tracking with a global keyframe chain.

    ``device``: where every tensor of the tracker lives ("cuda" by default).
    A CUDA device without a visible GPU raises; the tracker never moves to
    the CPU on its own. On CUDA, TF32 is switched off so float32 means
    float32.
    """

    def __init__(self, config: TrackerConfig, K: np.ndarray,
                 im_hw: Tuple[int, int], backend=None, device="cuda"):
        if backend is not None:
            raise _not_ported("a VO backend (backend=)")
        if config.shard_devices and config.shard_devices > 1:
            raise _not_ported("keypoint sharding (shard_devices > 1)")
        if config.affine_brightness:
            raise _not_ported("affine_brightness")
        if config.sampling != "windowed":
            raise _not_ported(f"sampling={config.sampling!r}")
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "BlurAwareTracker(device='cuda') but no CUDA device is "
                    "visible; pass device='cpu' to run on the CPU")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = config
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
        self.last_summaries: list = []
        # deferred keyframe decision of the last tracked frame: (stats,
        # pose_cap, cap_time, sharp_img, depth_map, pre-frame snapshot)
        self._pending: Optional[tuple] = None
        self.failure_log: list = []

    def _tensor(self, x) -> torch.Tensor:
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

    def track_frames(self, *args, **kwargs):
        raise _not_ported("track_frames (chunked dispatch and speculation)")

    def track_frames_joint(self, *args, **kwargs):
        raise _not_ported("track_frames_joint (joint multi-frame window)")

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
            cfg.lm_options(),
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
            return True
        return False
