"""Blur-aware photometric residual, Jacobian and normal-equation assembly.

Counterpart of ``mba_vo_tpu/ops/residual.py``. A blurred frame is the
temporal average of V virtual sharp images along the spline inside the
exposure window; the residual at patch pixel x of frame f is

    r = (1/V) sum_v I_ref(warp(T_c2r(t_v), x)) - I_f(x)

and the Gauss-Newton system is assembled over the global knot tangent
[all t-knots (3K); all omega-knots (3K)] with Huber row scaling.

The Jacobian is the chain rule written out. ``torch.func.jacfwd`` through
the retraction and the spline gives the [F, V, 7, 6K] pose Jacobian
(:func:`pose_jacobians`); ``ops.warp.frontoparallel_warp_jvp`` carries it
through the warp to the [N, F, P, V, 2, 6K] Jacobian of the reference-view
sample positions; one C = 3 call of the window sampler gives each sample's
value and Lucas-Kanade gradient; and
J = mean_v(dI/dx * dx/d(delta) + dI/dy * dy/d(delta)), masked by the
patch-pixel validity. No derivative passes through the sampler kernel.

The direct path (``sampling="direct"``, :func:`compute_residuals`) gathers
every sample from the whole keyframe image instead of a window: the warp
JVP over the 7 pose components gives G = dI/d(pose7) per sample, and
J = mean_v(G . d(pose7)/d(delta)).

``affine=True`` eliminates a per-frame gain and bias in closed form
(:func:`affine_correct`). The windowed path carries the Jacobian through
the elimination (:func:`affine_correct_jvp`); the direct path pairs the
corrected residual with the Jacobian at frozen gain and bias, as the
reference does.

Not ported yet (see ROADMAP.md): keypoint sharding (the reference's
``axis_name``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd

from ..core.lie import quat_conjugate, quat_rotate
from ..core.spline import (
    SplineKnots,
    spline_pose_at_times,
    spline_retract,
    virtual_pose_times,
)
from .image import in_bounds, sample_lk_with_gradient
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


def pose_jacobians(
    knots: SplineKnots, cap_times: torch.Tensor, exp_times: torch.Tensor,
    num_vir: int, degree: int,
) -> torch.Tensor:
    """d(pose 7-vector)/d(global knot tangent) at zero retraction:
    [F, V, 7, 6K] with tangent layout [3K translations; 3K rotations]."""
    K = knots.num_knots
    times = virtual_pose_times(cap_times, exp_times, num_vir)
    flat_times = times.reshape(-1)
    T = flat_times.shape[0]
    z = torch.zeros((K, 3), dtype=knots.t.dtype, device=knots.t.device)

    def pose7_all(d_t, d_o):
        k = spline_retract(knots, d_t, d_o)
        p = spline_pose_at_times(k, flat_times, degree)
        return torch.cat([p.t, p.q], dim=-1)  # [T, 7]

    Jt, Jo = jacfwd(pose7_all, argnums=(0, 1))(z, z)  # [T, 7, K, 3] each
    J = torch.cat([Jt.reshape(T, 7, 3 * K), Jo.reshape(T, 7, 3 * K)], dim=-1)
    return J.reshape(times.shape[0], num_vir, 7, 6 * K)


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


def _affine_fit(pred, obs, valid):
    """Per-frame least-squares gain/bias of ``pred ~ a * obs + b`` over the
    valid pixels, and the moments the derivative reuses."""
    v = valid.to(pred.dtype)
    n = torch.clamp(v.sum(dim=(1, 2)), min=1.0)                    # [F]
    mx = (obs * v).sum(dim=(1, 2)) / n
    my = (pred * v).sum(dim=(1, 2)) / n
    dx = (obs - mx[:, None, None]) * v
    dy = (pred - my[:, None, None]) * v
    var = (dx * dx).sum(dim=(1, 2)) / n
    cov = (dx * dy).sum(dim=(1, 2)) / n
    ok = var > 1e-6
    a = torch.where(ok, cov / torch.where(ok, var, torch.ones_like(var)),
                    torch.ones_like(var))
    b = torch.where(ok, my - a * mx, torch.zeros_like(var))
    return a, b, (v, n, mx, dx, var, ok)


def affine_correct(pred: torch.Tensor, obs: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Per-frame affine-brightness-eliminated residual.

    For each frame f, (a, b) = argmin sum_valid (pred - a*obs - b)^2 in
    closed form, then r = pred - a*obs - b: the profile likelihood over a
    per-frame gain and bias, which absorbs exposure drift without adding
    unknowns to the LM state. A textureless frame (variance of obs <= 1e-6)
    keeps (a, b) = (1, 0), the uncorrected residual.

    pred, obs, valid: [F, N, P]. Returns [F, N, P] residuals (0 where
    invalid).
    """
    a, b, _ = _affine_fit(pred, obs, valid)
    r = pred - a[:, None, None] * obs - b[:, None, None]
    return torch.where(valid, r, torch.zeros_like(r))


def affine_correct_jvp(pred: torch.Tensor, obs: torch.Tensor,
                       valid: torch.Tensor, dpred: torch.Tensor):
    """:func:`affine_correct` and its derivative along D tangents of ``pred``.

    dpred: [F, N, P, D]. Returns (r [F, N, P], dr [F, N, P, D]). The fitted
    gain and bias depend on ``pred``, so the tangents pass through them:
    dmy = sum(dpred v)/n, dcov = sum(dx dpred)/n, da = dcov/var and
    db = dmy - da*mx where the fit is live (0 where it fell back to
    (1, 0)), and dr = dpred - da*obs - db on the valid pixels.
    """
    a, b, (v, n, mx, dx, var, ok) = _affine_fit(pred, obs, valid)
    r = pred - a[:, None, None] * obs - b[:, None, None]
    r = torch.where(valid, r, torch.zeros_like(r))
    dmy = (dpred * v[..., None]).sum(dim=(1, 2)) / n[:, None]       # [F, D]
    dcov = (dpred * dx[..., None]).sum(dim=(1, 2)) / n[:, None]
    safe_var = torch.where(ok, var, torch.ones_like(var))
    da = torch.where(ok[:, None], dcov / safe_var[:, None], torch.zeros_like(dcov))
    db = torch.where(ok[:, None], dmy - da * mx[:, None], torch.zeros_like(dmy))
    dr = dpred - da[:, None, None, :] * obs[..., None] - db[:, None, None, :]
    return r, torch.where(valid[..., None], dr, torch.zeros_like(dr))


def compute_residuals(
    knots: SplineKnots, data: TrackingLevelData, num_vir: int, degree: int,
    with_jacobian: bool, affine: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Residuals r [F,N,P], Jacobian J [F,N,P,6K] (or None) and the
    valid-pixel mask [F,N,P], gathering every sample from the whole
    keyframe image (``sampling="direct"``).

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
        r = affine_correct(pred, obs, valid)
    else:
        r = torch.where(valid, pred - obs, torch.zeros_like(pred))
    return r, J, valid


def prepare_window_cache(
    data: TrackingLevelData, window: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(windows [N,3,wh,ww], starts [N,2]) for the windowed sampling path.
    Windows are centred on the keyframe keypoints, so they are constant for
    a whole keyframe."""
    chans = stack_image_channels(data.img_ref, data.grad_ref)
    windows, starts = extract_windows(chans, data.kp_xy, window)
    return windows.detach(), starts


def prepare_frame_layout(
    knots: SplineKnots, data: TrackingLevelData, num_vir: int, degree: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pix, valid_center, obs): the current-frame patch layout and the
    observed intensities at the given knot state."""
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


def compute_residuals_windowed(
    knots: SplineKnots, data: TrackingLevelData, num_vir: int, degree: int,
    with_jacobian: bool, window: int = 32, cache=None, layout=None,
    affine: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Residuals r [F,N,P], Jacobian J [F,N,P,6K] (or None) and the
    valid-pixel mask [F,N,P], sampling per-keypoint keyframe windows.

    ``cache``: (windows, starts) from :func:`prepare_window_cache`;
    ``layout``: (pix, valid_center, obs) from :func:`prepare_frame_layout`.
    None recomputes either here. With ``affine`` the residual and the
    Jacobian both pass through the per-frame gain/bias elimination.
    """
    F = data.cur_imgs.shape[0]
    H, W = data.img_ref.shape
    N = data.kp_xy.shape[0]
    P = data.pattern.shape[0]
    Kk = knots.num_knots
    dtype = knots.t.dtype
    S = F * P * num_vir

    if layout is None:
        layout = prepare_frame_layout(knots, data, num_vir, degree)
    pix, valid_center, obs = layout
    if cache is None:
        cache = prepare_window_cache(data, window)
    windows, starts = cache                               # [N,3,wh,ww], [N,2]
    starts_f = starts.to(dtype)

    # keypoint-major layout: the sampler wants [N, S]
    pix_nf = pix.permute(1, 0, 2, 3)                      # [N,F,P,2]
    vc_nf = valid_center.permute(1, 0, 2)                 # [N,F,P]
    obs_nf = obs.permute(1, 0, 2)                         # [N,F,P]

    # every (n, f, p, v) patch pixel warped into the reference view
    pt, pq = sample_virtual_poses(
        knots, data.cap_times, data.exp_times, num_vir, degree
    )
    warp_args = (
        pt[None, :, None, :, :],            # [1,F,1,V,3]
        pq[None, :, None, :, :],            # [1,F,1,V,4]
        data.kp_z[:, None, None, None],     # [N,1,1,1]
        data.K,
        pix_nf[:, :, :, None, :],           # [N,F,P,1,2]
    )
    if with_jacobian:
        # pose tangents per knot-tangent seed: [6K, 1, F, 1, V, 7]
        Jp = pose_jacobians(knots, data.cap_times, data.exp_times, num_vir,
                            degree).permute(3, 0, 1, 2)[:, None, :, None]
        ref_xy, dxy = frontoparallel_warp_jvp(
            *warp_args, dpose_t=Jp[..., :3], dpose_q=Jp[..., 3:])
        dxy = dxy.permute(1, 2, 3, 4, 5, 0)               # [N,F,P,V,2,6K]
    else:
        ref_xy = frontoparallel_warp(*warp_args)          # [N,F,P,V,2]

    vs = in_bounds(ref_xy, H, W).reshape(N, S).to(dtype)
    loc = (ref_xy - starts_f[:, None, None, None, :]).reshape(N, S, 2)
    if with_jacobian:
        val, gx, gy = sample_windows_lk(windows, loc, vs)   # [N, S] each
    else:
        val = sample_windows(windows, loc, vs)
    pred = val.reshape(N, F, P, num_vir).mean(dim=-1)       # [N,F,P]
    if with_jacobian:
        dxy = dxy.reshape(N, S, 2, 6 * Kk)
        tangent = gx[..., None] * dxy[:, :, 0] + gy[..., None] * dxy[:, :, 1]
        dpred = tangent.reshape(N, F, P, num_vir, 6 * Kk).mean(dim=3)
    if affine:
        pred_fn = pred.permute(1, 0, 2)                     # [F,N,P]
        if not with_jacobian:
            return affine_correct(pred_fn, obs, valid_center), None, valid_center
        r, J = affine_correct_jvp(pred_fn, obs, valid_center,
                                  dpred.permute(1, 0, 2, 3))
        return r, J, valid_center
    r_nf = torch.where(vc_nf, pred - obs_nf, torch.zeros_like(pred))
    r = r_nf.permute(1, 0, 2)                               # [F,N,P]
    if not with_jacobian:
        return r, None, valid_center
    J_nf = torch.where(vc_nf[..., None], dpred, torch.zeros_like(dpred))
    return r, J_nf.permute(1, 0, 2, 3), valid_center


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
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Residuals r [F,N,P], Jacobian J [F,N,P,6K] (or None), valid mask.
    Independent of the outlier mask, which only reweights the reductions.
    ``sampling``: "windowed" or "direct"; ``affine``: per-frame gain/bias
    elimination (see the module docstring for how each path differentiates
    it)."""
    if sampling == "windowed":
        return compute_residuals_windowed(
            knots, data, num_vir, degree, with_jacobian, window, cache=cache,
            layout=layout, affine=affine,
        )
    return compute_residuals(knots, data, num_vir, degree, with_jacobian,
                             affine=affine)


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


def assemble(
    r: torch.Tensor,
    J: Optional[torch.Tensor],
    data: TrackingLevelData,
    huber_a: float,
    outlier_mask: torch.Tensor,
    precision: str = "default",
    compensated: bool = False,
) -> Evaluation:
    """Huber cost (+ gradient + Gauss-Newton Hessian) from residuals.

    ``precision`` keeps the reference's field: "highest" asked the TPU for
    full-f32 matrix-unit passes. Here every f32 product is full f32 already
    (TF32 is off wherever the port runs on the card), so both values give
    the same arithmetic. ``compensated`` adds Kahan accumulation across
    residual chunks.

    ``patch_costs`` cover every keypoint, outliers included (the reference
    divides them by the inlier count but does not mask them).
    """
    F = data.cur_imgs.shape[0]
    P = data.pattern.shape[0]

    rho, w = huber_weights(r, huber_a)

    live_kp = data.kp_mask * outlier_mask  # [N]
    n_res = torch.clamp(torch.sum(live_kp) * F * P, min=1.0)
    inv_n = 1.0 / n_res

    patch_costs = torch.sum(rho, dim=-1) * inv_n  # [F, N]

    kp_w = live_kp[None, :, None]  # [F, N, P] broadcast
    cost = torch.sum(rho * kp_w) * inv_n

    if J is None:
        return Evaluation(cost=cost, gradient=None, hessian=None,
                          patch_costs=patch_costs)

    rw = (r * w * kp_w).reshape(-1)                            # [M]
    Jw = (J * (w * kp_w)[..., None]).reshape(rw.shape[0], -1)  # [M, 6K]
    if compensated:
        g, Hm = _kahan_chunked_normal_eq(Jw, rw)
    else:
        g = torch.einsum("mk,m->k", Jw, rw)
        Hm = torch.einsum("mk,ml->kl", Jw, Jw)
    return Evaluation(cost=cost, gradient=g * inv_n, hessian=Hm * inv_n,
                      patch_costs=patch_costs)


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
) -> Evaluation:
    """Full objective evaluation: cost (+ gradient + Gauss-Newton Hessian).

    outlier_mask: [N], 1.0 = inlier. Outliers leave the cost/H/g sums and
    the residual-count normalizer; their patch costs are still reported.
    """
    r, J, _valid = compute_rjv(
        knots, data, num_vir, degree, with_jacobian, sampling, window,
        cache=cache, layout=layout, affine=affine,
    )
    return assemble(r, J, data, huber_a, outlier_mask,
                    precision=precision, compensated=compensated)
