"""Blur-aware photometric residual, Jacobian and normal-equation assembly.

Counterpart of ``mba_vo_tpu/ops/residual.py``. A blurred frame is the
temporal average of V virtual sharp images along the spline inside the
exposure window; the residual at patch pixel x of frame f is

    r = (1/V) sum_v I_ref(warp(T_c2r(t_v), x)) - I_f(x)

and the Gauss-Newton system is assembled over the global knot tangent
[all t-knots (3K); all omega-knots (3K)] with Huber row scaling.

The Jacobian is the chain rule written out. Forward mode through the
retraction and the spline, in closed form (``core.spline``'s ``*_jvp``
helpers), gives the [F, V, 7, 6K] pose Jacobian (:func:`pose_jacobians`);
the warp carries it to the [N, S, 2, 6K] Jacobian of the reference-view
sample positions (:func:`warp_tangents`, kernel K2's first entry, which
on the card computes the poses and their tangents from the knots
itself); one
C = 3 call of the window sampler K1 gives each sample's value and
Lucas-Kanade gradient; and J = mean_v(dI/dx * dx/d(delta) + dI/dy *
dy/d(delta)), masked by the patch-pixel validity (:func:`blur_rows`, K2's
second entry). No derivative passes through the sampler kernel. The
Huber normal equations are kernel K3 (:func:`normal_equations`). Each
kernel's plain PyTorch version is here beside its dispatcher, which sends
CUDA tensors to the kernel (``ops.cuda_residual``) and CPU tensors to the
plain version.

The direct path (``sampling="direct"``, :func:`compute_residuals`) gathers
every sample from the whole keyframe image instead of a window. On the card
it runs the windowed path's kernels with the window corners at the origin:
K2's :func:`warp_tangents` (whose positions are then whole-image ones and
whose in-image flags are the direct path's mask), the whole-image
Lucas-Kanade sampler K4 (``ops.image.image_bilinear_lk``) and K2's
:func:`blur_rows` (:func:`compute_residuals_direct`). Its plain version
(:func:`compute_residuals_plain`, which CPU tensors take) writes the
reference's chain out: the warp JVP over the 7 pose components gives G =
dI/d(pose7) per sample, and J = mean_v(G . d(pose7)/d(delta)).

The patch layout (:func:`prepare_frame_layout`: each frame's mid-exposure
pose, the keypoints' integer patch pixels, their validity and the observed
intensities), which every path computes once an evaluation, is kernel K5 on
the card (``ops.cuda_layout``), its plain version
:func:`prepare_frame_layout_plain` on the CPU.

``affine=True`` eliminates a per-frame gain and bias in closed form
(:func:`affine_correct`). The windowed path carries the Jacobian through
the elimination (:func:`affine_correct_jvp`); the direct path pairs the
corrected residual with the Jacobian at frozen gain and bias, as the
reference does.

``group`` is the reference's ``axis_name``: under keypoint sharding
(``parallel.sharded``) each rank holds a contiguous slice of the keypoints,
and every sum over the keypoint axis (the normal equations, the cost, its
residual count and the affine fit's moments and their tangents) is
all-reduced over that ``torch.distributed`` group
(``utils.collectives.allreduce``). ``patch_costs`` stay shard-local.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..core.lie import quat_conjugate, quat_rotate
from ..utils.collectives import allreduce
from ..core.spline import (
    SplineKnots,
    spline_pose_at_times,
    spline_pose_at_times_jvp,
    spline_retract_jvp,
    virtual_pose_times,
)
from . import cuda_layout, cuda_residual
from .image import image_bilinear_lk, in_bounds, sample_lk_with_gradient
from .warp import frontoparallel_warp, frontoparallel_warp_jvp
from .window_sampling import (
    extract_windows,
    sample_windows,
    sample_windows_lk,
    stack_image_channels,
)


class TrackingLevelData(NamedTuple):
    """Everything one pyramid level of the tracker needs, as dense tensors.

    img_ref:   [H, W]     sharp keyframe image at this level
    grad_ref:  [H, W, 2]  its central-difference gradient image
    cur_imgs:  [F, H, W]  blurred current frames at this level
    cap_times: [F]        capture (mid-exposure) times
    exp_times: [F]        exposure durations
    kp_xy:     [N, 2]     keypoint positions (level coordinates)
    kp_z:      [N]        keypoint depths in the keyframe
    kp_mask:   [N]        1.0 for live keypoints, 0.0 for padding
    pattern:   [P, 2]     integer patch-pixel offsets
    K:         [4]        level-scaled pinhole intrinsics fx, fy, cx, cy
    """

    img_ref: torch.Tensor
    grad_ref: torch.Tensor
    cur_imgs: torch.Tensor
    cap_times: torch.Tensor
    exp_times: torch.Tensor
    kp_xy: torch.Tensor
    kp_z: torch.Tensor
    kp_mask: torch.Tensor
    pattern: torch.Tensor
    K: torch.Tensor


class Evaluation(NamedTuple):
    """One evaluation of the objective at a knot configuration.

    cost:        scalar Huber cost (normalized by live residual count)
    gradient:    [6K] or None
    hessian:     [6K, 6K] or None
    patch_costs: [F, N] per-patch Huber costs (the outlier statistic)
    """

    cost: torch.Tensor
    gradient: Optional[torch.Tensor]
    hessian: Optional[torch.Tensor]
    patch_costs: torch.Tensor


# ----------------------------------------------------------------- virtual poses


def sample_virtual_poses(
    knots: SplineKnots, cap_times: torch.Tensor, exp_times: torch.Tensor,
    num_vir: int, degree: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Poses T_c2r at V uniformly spaced times inside each frame's exposure.
    Returns (t [F, V, 3], q [F, V, 4])."""
    times = virtual_pose_times(cap_times, exp_times, num_vir)  # [F, V]
    p = spline_pose_at_times(knots, times.reshape(-1), degree)
    F = times.shape[0]
    return p.t.reshape(F, num_vir, 3), p.q.reshape(F, num_vir, 4)


def virtual_poses_and_tangents(
    knots: SplineKnots, cap_times: torch.Tensor, exp_times: torch.Tensor,
    num_vir: int, degree: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`sample_virtual_poses` and the derivative of each pose
    7-vector along the 6K seeds of the global knot tangent at zero
    retraction, seed-major: (t [F, V, 3], q [F, V, 4], dpose [6K, F, V, 7]),
    tangent layout [3K translations; 3K rotations]. One forward-mode pass
    in closed form (``core.spline.spline_pose_at_times_jvp``), whose primal
    is the poses themselves."""
    K = knots.num_knots
    times = virtual_pose_times(cap_times, exp_times, num_vir)   # [F, V]
    F = times.shape[0]
    opts = dict(dtype=knots.t.dtype, device=knots.t.device)
    z = torch.zeros((K, 3), **opts)
    seeds = torch.eye(6 * K, **opts).reshape(6 * K, 2, K, 3)   # [translations; rotations]
    k, dkt, dkq = spline_retract_jvp(knots, z, z, seeds[:, 0], seeds[:, 1])
    p, dt, dq = spline_pose_at_times_jvp(k, dkt, dkq, times.reshape(-1), degree)
    dpose = torch.cat([dt, dq], dim=-1).reshape(6 * K, F, num_vir, 7)
    return p.t.reshape(F, num_vir, 3), p.q.reshape(F, num_vir, 4), dpose


def pose_jacobians(
    knots: SplineKnots, cap_times: torch.Tensor, exp_times: torch.Tensor,
    num_vir: int, degree: int,
) -> torch.Tensor:
    """d(pose 7-vector)/d(global knot tangent) at zero retraction:
    [F, V, 7, 6K] with tangent layout [3K translations; 3K rotations]
    (:func:`virtual_poses_and_tangents`, laid out as the reference's
    ``jacfwd``)."""
    return virtual_poses_and_tangents(knots, cap_times, exp_times, num_vir,
                                      degree)[2].permute(1, 2, 3, 0)


# ----------------------------------------------------------------- patch layout


def patch_anchors(
    pose_mid_t: torch.Tensor, pose_mid_q: torch.Tensor,
    kp_xy: torch.Tensor, kp_z: torch.Tensor, K: torch.Tensor,
) -> torch.Tensor:
    """Project each keypoint into each current frame via the mid-exposure
    pose: [F, N, 2]. A layout decision, not part of the objective, so it is
    detached."""
    P3dr = torch.stack(
        [
            kp_z * (kp_xy[:, 0] - K[2]) / K[0],
            kp_z * (kp_xy[:, 1] - K[3]) / K[1],
            kp_z,
        ],
        dim=-1,
    )  # [N, 3]
    q_r2c = quat_conjugate(pose_mid_q)  # [F, 4]
    t_r2c = -quat_rotate(q_r2c, pose_mid_t)  # [F, 3]
    P3dc = quat_rotate(q_r2c[:, None, :], P3dr[None, :, :]) + t_r2c[:, None, :]
    xy = torch.stack(
        [
            P3dc[..., 0] / P3dc[..., 2] * K[0] + K[2],
            P3dc[..., 1] / P3dc[..., 2] * K[1] + K[3],
        ],
        dim=-1,
    )
    return xy.detach()


def patch_pixel_grid(anchors: torch.Tensor, pattern: torch.Tensor) -> torch.Tensor:
    """Integer pixel positions [F, N, P, 2] = floor(anchor) + pattern."""
    base = torch.floor(anchors)  # [F, N, 2]
    return base[:, :, None, :] + pattern[None, None, :, :].to(anchors.dtype)


def _current_intensity(cur_imgs: torch.Tensor, pix: torch.Tensor) -> torch.Tensor:
    """Observed intensities at integer pixel positions [F, N, P, 2].

    Indices are clamped into the image (out-of-image pixels are masked by
    the caller); without the clamp torch raises on the CPU and reads out of
    bounds on CUDA.
    """
    F, H, W = cur_imgs.shape
    x = torch.clamp(pix[..., 0], -1, W).to(torch.int64).clamp(0, W - 1)
    y = torch.clamp(pix[..., 1], -1, H).to(torch.int64).clamp(0, H - 1)
    f = torch.arange(F, device=cur_imgs.device)[:, None, None]
    return cur_imgs[f, y, x]


# -------------------------------------------------------------------- residuals


def _affine_fit(pred, obs, valid, group=None):
    """Per-frame least-squares gain/bias of ``pred ~ a * obs + b`` over the
    valid pixels, and the moments the derivative reuses. With ``group`` the
    moment sums run over every rank's keypoints, so every shard fits the
    same global (a, b)."""
    def frame_sum(x):
        return allreduce(x.sum(dim=(1, 2)), group)

    v = valid.to(pred.dtype)
    n = torch.clamp(frame_sum(v), min=1.0)                          # [F]
    mx = frame_sum(obs * v) / n
    my = frame_sum(pred * v) / n
    dx = (obs - mx[:, None, None]) * v
    dy = (pred - my[:, None, None]) * v
    var = frame_sum(dx * dx) / n
    cov = frame_sum(dx * dy) / n
    ok = var > 1e-6
    a = torch.where(ok, cov / torch.where(ok, var, torch.ones_like(var)),
                    torch.ones_like(var))
    b = torch.where(ok, my - a * mx, torch.zeros_like(var))
    return a, b, (v, n, mx, dx, var, ok)


def affine_correct(pred: torch.Tensor, obs: torch.Tensor,
                   valid: torch.Tensor, group=None) -> torch.Tensor:
    """Per-frame affine-brightness-eliminated residual.

    For each frame f, (a, b) = argmin sum_valid (pred - a*obs - b)^2 in
    closed form, then r = pred - a*obs - b: the profile likelihood over a
    per-frame gain and bias, which absorbs exposure drift without adding
    unknowns to the LM state. A textureless frame (variance of obs <= 1e-6)
    keeps (a, b) = (1, 0), the uncorrected residual.

    pred, obs, valid: [F, N, P]. Returns [F, N, P] residuals (0 where
    invalid). ``group``: the keypoint shards' process group (see
    :func:`_affine_fit`).
    """
    a, b, _ = _affine_fit(pred, obs, valid, group)
    r = pred - a[:, None, None] * obs - b[:, None, None]
    return torch.where(valid, r, torch.zeros_like(r))


def affine_correct_jvp(pred: torch.Tensor, obs: torch.Tensor,
                       valid: torch.Tensor, dpred: torch.Tensor, group=None):
    """:func:`affine_correct` and its derivative along D tangents of ``pred``.

    dpred: [F, N, P, D]. Returns (r [F, N, P], dr [F, N, P, D]). The fitted
    gain and bias depend on ``pred``, so the tangents pass through them:
    dmy = sum(dpred v)/n, dcov = sum(dx dpred)/n, da = dcov/var and
    db = dmy - da*mx where the fit is live (0 where it fell back to
    (1, 0)), and dr = dpred - da*obs - db on the valid pixels. With
    ``group`` the tangents' moment sums are all-reduced like the moments
    themselves (the reference gets them from ``linearize`` through its
    psum).
    """
    a, b, (v, n, mx, dx, var, ok) = _affine_fit(pred, obs, valid, group)
    r = pred - a[:, None, None] * obs - b[:, None, None]
    r = torch.where(valid, r, torch.zeros_like(r))
    dmy = allreduce((dpred * v[..., None]).sum(dim=(1, 2)), group) / n[:, None]   # [F, D]
    dcov = allreduce((dpred * dx[..., None]).sum(dim=(1, 2)), group) / n[:, None]
    safe_var = torch.where(ok, var, torch.ones_like(var))
    da = torch.where(ok[:, None], dcov / safe_var[:, None], torch.zeros_like(dcov))
    db = torch.where(ok[:, None], dmy - da * mx[:, None], torch.zeros_like(dmy))
    dr = dpred - da[:, None, None, :] * obs[..., None] - db[:, None, None, :]
    return r, torch.where(valid[..., None], dr, torch.zeros_like(dr))


def compute_residuals_plain(
    knots: SplineKnots, data: TrackingLevelData, num_vir: int, degree: int,
    with_jacobian: bool, affine: bool = False, group=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Plain version of the direct path (:func:`compute_residuals`): the
    reference's chain written out in torch (the pose Jacobian, the warp JVP
    over the 7 pose components, one gather of the three image planes and an
    einsum).

    The prediction and the Jacobian are averaged over the V virtual poses;
    patch pixels outside the current image are masked out. With ``affine``
    the residual is gain/bias-corrected and J is the Jacobian at frozen
    gain and bias: it is not carried through :func:`affine_correct`.
    """
    pt, pq = sample_virtual_poses(
        knots, data.cap_times, data.exp_times, num_vir, degree
    )  # [F, V, 3], [F, V, 4]
    pix, valid, obs = prepare_frame_layout(knots, data, num_vir, degree)

    warp_args = (
        pt[:, None, None, :, :],            # [F,1,1,V,3]
        pq[:, None, None, :, :],            # [F,1,1,V,4]
        data.kp_z[None, :, None, None],     # [1,N,1,1]
        data.K,
        pix[:, :, :, None, :],              # [F,N,P,1,2]
    )
    if with_jacobian:
        # the 7 unit tangents of the pose vector (t; q): [7, 1,1,1,1, 3|4]
        eye = torch.eye(7, dtype=pt.dtype, device=pt.device)[:, None, None, None, None]
        ref_xy, dxy = frontoparallel_warp_jvp(
            *warp_args, dpose_t=eye[..., :3], dpose_q=eye[..., 3:])
        I, gx, gy = sample_lk_with_gradient(data.img_ref, data.grad_ref, ref_xy)
        G = (gx * dxy[..., 0] + gy * dxy[..., 1]).permute(1, 2, 3, 4, 0)  # [F,N,P,V,7]
        Jp = pose_jacobians(knots, data.cap_times, data.exp_times, num_vir, degree)
        J = torch.einsum("fnpvc,fvck->fnpk", G, Jp) / num_vir
        J = torch.where(valid[..., None], J, torch.zeros_like(J))
    else:
        ref_xy = frontoparallel_warp(*warp_args)          # [F,N,P,V,2]
        I, _gx, _gy = sample_lk_with_gradient(data.img_ref, data.grad_ref, ref_xy)
        J = None

    pred = I.mean(dim=-1)  # [F, N, P]
    if affine:
        r = affine_correct(pred, obs, valid, group)
    else:
        r = torch.where(valid, pred - obs, torch.zeros_like(pred))
    return r, J, valid


def compute_residuals_direct(
    knots: SplineKnots, data: TrackingLevelData, num_vir: int, degree: int,
    with_jacobian: bool, affine: bool = False, group=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """The direct path as the card runs it, through the dispatchers of its
    stages (each the kernel on CUDA tensors, the plain version on CPU
    tensors): the layout (:func:`prepare_frame_layout`, K5), K2's
    :func:`warp_tangents` with every window corner at the origin, so that
    its positions are whole-image positions and its in-image flags the
    direct path's mask, K4 (``image_bilinear_lk``: C = 3 with the Jacobian,
    1 without) and K2's :func:`blur_rows`. Returns what
    :func:`compute_residuals_plain` returns; J sums the blur over the knot
    tangents as the windowed path does, not through the 7 pose components.

    With ``affine`` the residual is gain/bias-corrected and J is the
    Jacobian at frozen gain and bias (the reference's pairing, as in the
    plain version): ``blur_rows`` gives (pred, dpred) unmasked, r =
    :func:`affine_correct` and J = dpred where valid.
    """
    H, W = data.img_ref.shape
    pix, valid, obs = prepare_frame_layout(knots, data, num_vir, degree)
    starts = torch.zeros((pix.shape[1], 2), dtype=torch.int64, device=pix.device)
    loc, _vs, dxy = warp_tangents(knots, data.cap_times, data.exp_times, num_vir, degree,
                                  with_jacobian, data.kp_z, data.K, pix, starts, H, W)
    if with_jacobian:
        val, gx, gy = image_bilinear_lk(data.img_ref, data.grad_ref, loc, 3)
    else:
        val = image_bilinear_lk(data.img_ref, data.grad_ref, loc, 1)
        gx = gy = val                          # unread: there are no tangent seeds
    rows, drows = blur_rows(val, gx, gy, dxy, obs, valid, num_vir, affine)
    if not affine:
        return rows, (drows if with_jacobian else None), valid
    J = torch.where(valid[..., None], drows, torch.zeros_like(drows)) if with_jacobian else None
    return affine_correct(rows, obs, valid, group), J, valid


def compute_residuals(knots, data, num_vir, degree, with_jacobian, affine=False, group=None):
    """Residuals r [F,N,P], Jacobian J [F,N,P,6K] (or None) and the
    valid-pixel mask [F,N,P], gathering every sample from the whole
    keyframe image (``sampling="direct"``): :func:`compute_residuals_direct`
    (the kernels K5, K2, K4) on CUDA tensors, :func:`compute_residuals_plain`
    on CPU tensors."""
    if data.cur_imgs.is_cuda:
        return compute_residuals_direct(knots, data, num_vir, degree, with_jacobian, affine,
                                        group)
    return compute_residuals_plain(knots, data, num_vir, degree, with_jacobian, affine, group)


def prepare_window_cache(
    data: TrackingLevelData, window: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(windows [N,3,wh,ww], starts [N,2]) for the windowed sampling path.
    Windows are centred on the keyframe keypoints, so they are constant for
    a whole keyframe."""
    chans = stack_image_channels(data.img_ref, data.grad_ref)
    windows, starts = extract_windows(chans, data.kp_xy, window)
    return windows.detach(), starts


def prepare_frame_layout_plain(
    knots: SplineKnots, data: TrackingLevelData, num_vir: int, degree: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5 (:func:`prepare_frame_layout`): (pix
    [F, N, P, 2], valid_center [F, N, P] bool, obs [F, N, P]), the
    current-frame patch layout and the observed intensities at the given
    knot state."""
    H, W = data.img_ref.shape
    pt0, pq0 = sample_virtual_poses(
        knots, data.cap_times, data.exp_times, num_vir, degree
    )
    mid = num_vir // 2
    anchors = patch_anchors(pt0[:, mid], pq0[:, mid], data.kp_xy, data.kp_z, data.K)
    pix = patch_pixel_grid(anchors, data.pattern)  # [F, N, P, 2]
    valid_center = in_bounds(pix, H, W) & (data.kp_mask[None, :, None] > 0)
    obs = _current_intensity(data.cur_imgs, pix)
    return pix, valid_center, obs


def frame_layout_args(knots, data, num_vir, degree) -> tuple:
    """The arguments of K5's wrappers (``ops/cuda_layout.py``) for a call of
    :func:`prepare_frame_layout`."""
    opts = dict(dtype=knots.t.dtype, device=knots.t.device)
    H, W = data.img_ref.shape
    return (SplineKnots(*(torch.as_tensor(x, **opts).contiguous() for x in knots)),
            data.cap_times.contiguous(), data.exp_times.contiguous(), num_vir, degree,
            data.kp_xy.contiguous(), data.kp_z.contiguous(), data.kp_mask.contiguous(),
            data.K.contiguous(), data.pattern.to(torch.int32).contiguous(),
            data.cur_imgs.contiguous(), H, W)


def prepare_frame_layout(knots, data, num_vir, degree):
    """K5, the patch layout (:func:`prepare_frame_layout_plain`): the kernel
    on CUDA tensors (``ops/cuda_layout.py``), the plain version on CPU
    tensors."""
    if data.cur_imgs.is_cuda:
        return cuda_layout.frame_layout_cuda(*frame_layout_args(knots, data, num_vir, degree))
    return prepare_frame_layout_plain(knots, data, num_vir, degree)


def warp_tangents_threads_plain(
    pose_t: torch.Tensor, pose_q: torch.Tensor, dpose: torch.Tensor, kp_z: torch.Tensor,
    K: torch.Tensor, pix: torch.Tensor, starts: torch.Tensor, height: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The warp of K2's first entry, from given poses: every patch pixel
    (n, f, p) warped by every virtual pose v into the keyframe, with its
    derivative along the D knot tangents. The plain version of the earlier
    design (``cuda_residual.warp_tangents_threads_cuda``, a sweep row) and
    the last step of :func:`warp_tangents_plain`.

    pose_t [F, V, 3], pose_q [F, V, 4], dpose [D, F, V, 7] (seed-major pose
    tangents), kp_z [N], K [4], pix [F, N, P, 2], starts [N, 2] (the
    windows' integer corners). Returns, keypoint-major with S = F P V in
    (f, p, v) order as the sampler takes them: loc [N, S, 2] (window-local
    positions), vs [N, S] (1.0 where the position lies in the image) and
    dxy [2, D, N, S] (the x and y derivatives, tangent-major).
    """
    F, N, P, _ = pix.shape
    V, D = pose_t.shape[1], dpose.shape[0]
    S = F * P * V
    seeds = dpose[:, None, :, None]                      # [D, 1, F, 1, V, 7]
    ref_xy, dxy = frontoparallel_warp_jvp(
        pose_t[None, :, None], pose_q[None, :, None],    # [1, F, 1, V, 3|4]
        kp_z[:, None, None, None],                       # [N, 1, 1, 1]
        K,
        pix.permute(1, 0, 2, 3)[:, :, :, None, :],       # [N, F, P, 1, 2]
        dpose_t=seeds[..., :3], dpose_q=seeds[..., 3:],
    )                                                    # [N,F,P,V,2], [D,N,F,P,V,2]
    vs = in_bounds(ref_xy, height, width).reshape(N, S).to(pose_t.dtype)
    loc = (ref_xy - starts.to(pose_t.dtype)[:, None, None, None, :]).reshape(N, S, 2)
    return loc, vs, dxy.permute(5, 0, 1, 2, 3, 4).reshape(2, D, N, S)


def warp_poses(
    knots: SplineKnots, cap_times: torch.Tensor, exp_times: torch.Tensor, num_vir: int,
    degree: int, tangents: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The virtual poses of each frame's exposure and, with ``tangents``,
    their derivatives along the D = 6K seeds of the knot tangent, laid out
    [3K translations; 3K rotations] (:func:`virtual_poses_and_tangents`;
    D = 0 without, :func:`sample_virtual_poses`): (pose_t [F, V, 3],
    pose_q [F, V, 4], dpose [D, F, V, 7]), contiguous, as the warp of K2's
    first entry takes them."""
    if tangents:
        pt, pq, dpose = virtual_poses_and_tangents(knots, cap_times, exp_times, num_vir,
                                                   degree)
    else:
        pt, pq = sample_virtual_poses(knots, cap_times, exp_times, num_vir, degree)
        dpose = pt.new_empty((0,) + pt.shape[:2] + (7,))
    return pt.contiguous(), pq.contiguous(), dpose.contiguous()


def warp_tangents_plain(
    knots: SplineKnots, cap_times: torch.Tensor, exp_times: torch.Tensor, num_vir: int,
    degree: int, tangents: bool, kp_z: torch.Tensor, K: torch.Tensor, pix: torch.Tensor,
    starts: torch.Tensor, height: int, width: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K2's first entry, from the spline knots to the warp
    tangents: the stage the reference linearizes from the knot step to the
    window-local positions (``spline_retract``, ``sample_virtual_poses``,
    ``frontoparallel_warp``, ``in_bounds``), with its derivative at zero
    retraction.

    The poses (:func:`warp_poses`), then the warp
    (:func:`warp_tangents_threads_plain`). Returns loc [N, S, 2], vs [N, S]
    and dxy [2, D, N, S] with S = F P V in (f, p, v) order.
    """
    return warp_tangents_threads_plain(
        *warp_poses(knots, cap_times, exp_times, num_vir, degree, tangents), kp_z, K, pix,
        starts, height, width)


def warp_tangents(knots, cap_times, exp_times, num_vir, degree, tangents, kp_z, K, pix,
                  starts, height, width):
    """K2's first entry (:func:`warp_tangents_plain`): kernel on CUDA
    tensors, plain version on CPU tensors."""
    if pix.is_cuda:
        opts = dict(dtype=knots.t.dtype, device=knots.t.device)
        return cuda_residual.warp_tangents_cuda(
            SplineKnots(*(torch.as_tensor(x, **opts).contiguous() for x in knots)),
            cap_times.contiguous(), exp_times.contiguous(), num_vir, degree, tangents,
            kp_z.contiguous(), K.contiguous(), pix.contiguous(), starts.contiguous(),
            height, width)
    return warp_tangents_plain(knots, cap_times, exp_times, num_vir, degree, tangents,
                               kp_z, K, pix, starts, height, width)


def blur_rows_plain(
    val: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor, dxy: torch.Tensor,
    obs: torch.Tensor, valid: torch.Tensor, num_vir: int, affine: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2's second entry: the blur model and its tangent.

    val, gx, gy [N, S]: the sampler's (I, dI/dx, dI/dy) at
    :func:`warp_tangents_plain`'s positions; dxy [2, D, N, S]; obs and the
    bool patch-pixel mask ``valid`` [F, N, P]. pred = mean_v I and
    dpred = mean_v (gx dx + gy dy) per (f, n, p). Returns [F, N, P] and
    [F, N, P, D]: (r, J) = (pred - obs, dpred) where ``valid``, 0
    elsewhere; with ``affine``, (pred, dpred) unmasked for
    :func:`affine_correct_jvp`.
    """
    F, N, P = obs.shape
    D = dxy.shape[1]
    pred = val.reshape(N, F, P, num_vir).mean(dim=-1).permute(1, 0, 2)
    tangent = gx * dxy[0] + gy * dxy[1]                                 # [D, N, S]
    dpred = tangent.reshape(D, N, F, P, num_vir).mean(dim=-1).permute(2, 1, 3, 0)
    if affine:
        return pred, dpred
    r = torch.where(valid, pred - obs, torch.zeros_like(pred))
    return r, torch.where(valid[..., None], dpred, torch.zeros_like(dpred))


def blur_rows(val, gx, gy, dxy, obs, valid, num_vir, affine):
    """K2's second entry (:func:`blur_rows_plain`): kernel on CUDA tensors,
    plain version on CPU tensors."""
    if obs.is_cuda:
        return cuda_residual.blur_rows_cuda(val, gx, gy, dxy.contiguous(), obs.contiguous(),
                                            valid.contiguous(), num_vir, affine)
    return blur_rows_plain(val, gx, gy, dxy, obs, valid, num_vir, affine)


def compute_residuals_windowed(
    knots: SplineKnots, data: TrackingLevelData, num_vir: int, degree: int,
    with_jacobian: bool, window: int = 32, cache=None, layout=None,
    affine: bool = False, group=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Residuals r [F,N,P], Jacobian J [F,N,P,6K] (or None) and the
    valid-pixel mask [F,N,P], sampling per-keypoint keyframe windows.

    ``cache``: (windows, starts) from :func:`prepare_window_cache`;
    ``layout``: (pix, valid_center, obs) from :func:`prepare_frame_layout`.
    None recomputes either here. With ``affine`` the residual and the
    Jacobian both pass through the per-frame gain/bias elimination.

    The pipeline: K2's :func:`warp_tangents` from the knots (the virtual
    poses, their tangents and the warp in one launch on the card), K1 (C =
    3; C = 1 without the Jacobian), K2's :func:`blur_rows`. Without the
    Jacobian the same path runs with no tangent seeds.
    """
    H, W = data.img_ref.shape
    if layout is None:
        layout = prepare_frame_layout(knots, data, num_vir, degree)
    pix, valid_center, obs = layout
    if cache is None:
        cache = prepare_window_cache(data, window)
    windows, starts = cache                               # [N,3,wh,ww], [N,2]

    loc, vs, dxy = warp_tangents(knots, data.cap_times, data.exp_times, num_vir, degree,
                                 with_jacobian, data.kp_z, data.K, pix, starts, H, W)
    if with_jacobian:
        val, gx, gy = sample_windows_lk(windows, loc, vs)   # [N, S] each
    else:
        val = sample_windows(windows, loc, vs)
        gx = gy = val                          # unread: there are no tangent seeds
    rows, drows = blur_rows(val, gx, gy, dxy, obs, valid_center, num_vir, affine)
    if affine:
        if not with_jacobian:
            return affine_correct(rows, obs, valid_center, group), None, valid_center
        r, J = affine_correct_jvp(rows, obs, valid_center, drows, group)
        return r, J, valid_center
    return rows, (drows if with_jacobian else None), valid_center


# --------------------------------------------------------------- normal equations


def huber_weights(r: torch.Tensor, huber_a: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rho, sqrt(drho/dx)) of the Huber-on-half-squared form:

        x = r^2 / 2
        x <= a^2:  rho = x,               w = 1
        x >  a^2:  rho = 2 a sqrt(x)-a^2, w = sqrt(a / (sqrt(x) + 1e-8))
    """
    aa = huber_a * huber_a
    x = 0.5 * r * r
    sx = torch.sqrt(torch.clamp(x, min=0.0))
    big = x > aa
    rho = torch.where(big, 2.0 * huber_a * sx - aa, x)
    w = torch.where(big, torch.sqrt(huber_a / (sx + 1e-8)), torch.ones_like(x))
    return rho, w


def compute_rjv(
    knots: SplineKnots,
    data: TrackingLevelData,
    num_vir: int,
    degree: int,
    with_jacobian: bool,
    sampling: str = "direct",
    window: int = 32,
    cache=None,
    layout=None,
    affine: bool = False,
    group=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Residuals r [F,N,P], Jacobian J [F,N,P,6K] (or None), valid mask.
    Independent of the outlier mask, which only reweights the reductions.
    ``sampling``: "windowed" or "direct"; ``affine``: per-frame gain/bias
    elimination (see the module docstring for how each path differentiates
    it)."""
    if sampling == "windowed":
        return compute_residuals_windowed(
            knots, data, num_vir, degree, with_jacobian, window, cache=cache,
            layout=layout, affine=affine, group=group,
        )
    return compute_residuals(knots, data, num_vir, degree, with_jacobian,
                             affine=affine, group=group)


def _kahan_chunked_normal_eq(Jw: torch.Tensor, rw: torch.Tensor,
                             chunks: int = 16):
    """(g, H) = (Jw^T rw, Jw^T Jw) with Kahan-compensated summation of the
    per-chunk partials over the residual axis."""
    M, D = Jw.shape
    pad = (-M) % chunks
    if pad:
        Jw = torch.cat([Jw, Jw.new_zeros((pad, D))], dim=0)
        rw = torch.cat([rw, rw.new_zeros((pad,))])
    Jc = Jw.reshape(chunks, -1, D)
    rc = rw.reshape(chunks, -1)
    g_parts = torch.einsum("cmk,cm->ck", Jc, rc)
    H_parts = torch.einsum("cmk,cml->ckl", Jc, Jc)

    def kahan(parts):
        s = torch.zeros_like(parts[0])
        comp = torch.zeros_like(parts[0])
        for part in parts:
            y = part - comp
            t = s + y
            comp = (t - s) - y
            s = t
        return s

    return kahan(g_parts), kahan(H_parts)


def normal_equations_plain(
    r: torch.Tensor, J: Optional[torch.Tensor], kp_w: torch.Tensor, huber_a: float,
    compensated: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Plain version of K3: the raw per-rank sums of the Huber normal
    equations, before the all-reduce and the scaling by the inverse residual
    count.

    r [F, N, P], J [F, N, P, D] or None (cost only), kp_w [N] (the keypoint
    mask times the outlier mask). Returns (sum rho kp_w, patch [F, N] =
    sum_p rho (unmasked: the reference's patch costs ignore the masks),
    g = Jw^T rw, H = Jw^T Jw) with Jw = J w kp_w, rw = r w kp_w; g and H
    None without J. ``compensated``: g and H Kahan-combined over 16 chunks
    of the [F, N, P] rows (:func:`_kahan_chunked_normal_eq`).
    """
    rho, w = huber_weights(r, huber_a)
    patch = torch.sum(rho, dim=-1)
    kw = kp_w[None, :, None]                                   # [F, N, P] broadcast
    cost = torch.sum(rho * kw)
    if J is None:
        return cost, patch, None, None
    rw = (r * w * kw).reshape(-1)                              # [M]
    Jw = (J * (w * kw)[..., None]).reshape(rw.shape[0], -1)    # [M, 6K]
    if compensated:
        g, Hm = _kahan_chunked_normal_eq(Jw, rw)
    else:
        g = torch.einsum("mk,m->k", Jw, rw)
        Hm = torch.einsum("mk,ml->kl", Jw, Jw)
    return cost, patch, g, Hm


def normal_equations(r, J, kp_w, huber_a, compensated=False):
    """K3 (:func:`normal_equations_plain`): kernel on CUDA tensors, plain
    version on CPU tensors."""
    if r.is_cuda:
        return cuda_residual.normal_equations_cuda(
            r.contiguous(), None if J is None else J.contiguous(), kp_w.contiguous(),
            huber_a, compensated)
    return normal_equations_plain(r, J, kp_w, huber_a, compensated)


def inverse_residual_count(live_kp: torch.Tensor, F: int, P: int, group=None) -> torch.Tensor:
    """assemble's scale: 1 / max(sum(live_kp) F P, 1), the inverse of the
    residual count under the keypoint weights ``live_kp`` [N] (the keypoint
    mask times the outlier mask; summed over the ranks with ``group``).
    The LM's kernels K7 and K8 (``ops/cuda_lm.py``) apply the same scale to
    K3's raw sums."""
    n_res = torch.clamp(allreduce(torch.sum(live_kp), group) * F * P, min=1.0)
    return 1.0 / n_res


def assemble(
    r: torch.Tensor,
    J: Optional[torch.Tensor],
    data: TrackingLevelData,
    huber_a: float,
    outlier_mask: torch.Tensor,
    precision: str = "default",
    compensated: bool = False,
    group=None,
) -> Evaluation:
    """Huber cost (+ gradient + Gauss-Newton Hessian) from residuals.

    ``precision`` keeps the reference's field: "highest" asked the TPU for
    full-f32 matrix-unit passes. Here every f32 product is full f32 already
    (TF32 is off wherever the port runs on the card, and K3 multiplies in
    the working type), so both values give the same arithmetic.
    ``compensated`` adds Kahan accumulation across residual chunks.

    ``patch_costs`` cover every keypoint, outliers included (the reference
    divides them by the inlier count but does not mask them).

    The sums come from :func:`normal_equations` (K3 on the card). With
    ``group`` (keypoint shards) the residual count, the cost and the
    per-rank g and H (each Kahan-combined per rank when ``compensated``)
    are all-reduced in the reference's order; ``patch_costs`` cover this
    rank's keypoints.
    """
    F = data.cur_imgs.shape[0]
    P = data.pattern.shape[0]

    live_kp = data.kp_mask * outlier_mask  # [N]
    inv_n = inverse_residual_count(live_kp, F, P, group)

    cost, patch, g, Hm = normal_equations(r, J, live_kp, huber_a, compensated)
    patch_costs = patch * inv_n  # [F, N]
    cost = allreduce(cost, group) * inv_n
    if J is None:
        return Evaluation(cost=cost, gradient=None, hessian=None,
                          patch_costs=patch_costs)
    g = allreduce(g, group) * inv_n
    Hm = allreduce(Hm, group) * inv_n
    return Evaluation(cost=cost, gradient=g, hessian=Hm, patch_costs=patch_costs)


def evaluate(
    knots: SplineKnots,
    data: TrackingLevelData,
    num_vir: int,
    degree: int,
    huber_a: float,
    outlier_mask: torch.Tensor,
    with_jacobian: bool = True,
    sampling: str = "direct",
    window: int = 32,
    precision: str = "default",
    compensated: bool = False,
    cache=None,
    layout=None,
    affine: bool = False,
    group=None,
) -> Evaluation:
    """Full objective evaluation: cost (+ gradient + Gauss-Newton Hessian).

    outlier_mask: [N], 1.0 = inlier. Outliers leave the cost/H/g sums and
    the residual-count normalizer; their patch costs are still reported.
    ``group``: the keypoint shards' process group (None: one process).
    """
    r, J, _valid = compute_rjv(
        knots, data, num_vir, degree, with_jacobian, sampling, window,
        cache=cache, layout=layout, affine=affine, group=group,
    )
    return assemble(r, J, data, huber_a, outlier_mask,
                    precision=precision, compensated=compensated, group=group)
