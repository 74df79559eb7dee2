"""Dynamic (scene-flow) landmarks: moving 3D points with a motion status.

Counterpart of ``mba_vo_tpu/backend/dynamic_points.py``: the table is dense
fixed-shape tensors, a constant-velocity model X(t) = X0 + v (t - t0) per
point, so estimation is batched over points:

  * :func:`dynamic_reprojection_residuals` of moving points against
    multi-frame observations;
  * :func:`fit_scene_flow`, Gauss-Newton over [X0; v] (6 dof) of every
    point at once: one batched [M, 6, 6] solve an iteration;
  * :func:`classify_motion`: STATIC / DYNAMIC / UNCERTAIN from the fitted
    flow and how much better it explains the observations than flow 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..core.lie import quat_conjugate, quat_rotate

# MotionStatus codes
MOTION_UNCERTAIN = 0
MOTION_STATIC = 1
MOTION_DYNAMIC = 2


class DynamicPoints(NamedTuple):
    """points [M, 3] X0 at t0; flow [M, 3] world-frame velocity (m/s);
    t0 [M]; status [M] int32 MotionStatus; mask [M] 1.0 = live slot."""

    points: torch.Tensor
    flow: torch.Tensor
    t0: torch.Tensor
    status: torch.Tensor
    mask: torch.Tensor


def make_dynamic_points(points, t0, flow=None, mask=None) -> DynamicPoints:
    points = torch.as_tensor(points)
    M = points.shape[0]
    opts = dict(dtype=points.dtype, device=points.device)
    return DynamicPoints(
        points=points,
        flow=torch.zeros_like(points) if flow is None else torch.as_tensor(flow, **opts),
        t0=torch.as_tensor(t0, **opts).expand(M).clone(),
        status=torch.full((M,), MOTION_UNCERTAIN, dtype=torch.int32, device=points.device),
        mask=torch.ones(M, **opts) if mask is None else torch.as_tensor(mask, **opts),
    )


def position_at(pts: DynamicPoints, times: torch.Tensor) -> torch.Tensor:
    """[T, M, 3] positions at [T] times under constant scene flow."""
    dt = times[:, None] - pts.t0[None, :]
    return pts.points[None] + pts.flow[None] * dt[..., None]


def _project(pose_t, pose_q, X, K):
    """Pixels of world points X [..., 3] in the camera T_c2w = (pose_t,
    pose_q) (broadcast against X), the depth clamped at 1e-6."""
    Pc = quat_rotate(quat_conjugate(pose_q), X - pose_t)
    z = torch.clamp(Pc[..., 2], min=1e-6)
    return torch.stack([Pc[..., 0] / z * K[0] + K[2], Pc[..., 1] / z * K[1] + K[3]], dim=-1)


def dynamic_reprojection_residuals(pts: DynamicPoints, cam_t, cam_q, times, obs_xy,
                                   obs_mask, K) -> torch.Tensor:
    """[T, M, 2] masked reprojection residuals of the moving points; cam_t
    [T, 3], cam_q [T, 4] camera-to-world, times [T], obs_xy [T, M, 2],
    obs_mask [T, M]."""
    X = position_at(pts, times)
    proj = _project(cam_t[:, None, :], cam_q[:, None, :], X, K)
    return (proj - obs_xy) * obs_mask[..., None]


def fit_scene_flow(pts: DynamicPoints, cam_t, cam_q, times, obs_xy, obs_mask, K,
                   iterations: int = 10, damping: float = 1e-6) -> DynamicPoints:
    """Gauss-Newton over [X0; v] of every point at once, ``iterations``
    steps: the Jacobian by forward-mode AD of each point's [T * 2]
    residual, one batched [M, 6, 6] solve a step. A step is kept only where
    it lowers the point's cost; a singular system gives a NaN step (as the
    reference's solve does), which is never kept. Dead slots (mask 0) keep
    their values.

    With a linear camera path a constant-velocity point is ambiguous (any
    line meeting all the observation rays reprojects exactly), so the fit
    explains the observations but need not recover (X0, v); a curved path
    makes the solution unique."""
    dtype = pts.points.dtype
    eye = torch.eye(6, dtype=dtype, device=pts.points.device)

    def res_one(z, t0, oxy, om):
        X = z[:3] + z[3:] * (times - t0)[:, None]                     # [T, 3]
        return ((_project(cam_t, cam_q, X, K) - oxy) * om[:, None]).reshape(-1)

    res = vmap(res_one, in_dims=(0, 0, 1, 1))
    jac = vmap(jacfwd(res_one), in_dims=(0, 0, 1, 1))
    z = torch.cat([pts.points, pts.flow], dim=-1)                      # [M, 6]
    args = (pts.t0, obs_xy, obs_mask)
    for _ in range(iterations):
        r = res(z, *args)                                               # [M, 2T]
        J = jac(z, *args)                                               # [M, 2T, 6]
        Jt = J.transpose(-1, -2)
        H = Jt @ J + damping * eye
        g = (Jt @ r[..., None])[..., 0]
        sol, info = torch.linalg.solve_ex(H, g)
        step = torch.where((info == 0)[:, None], -sol, torch.full_like(sol, float("nan")))
        z_new = z + step
        better = torch.sum(res(z_new, *args) ** 2, dim=-1) < torch.sum(r ** 2, dim=-1)
        z = torch.where(better[:, None], z_new, z)
    live = pts.mask[:, None] > 0
    return pts._replace(points=torch.where(live, z[:, :3], pts.points),
                        flow=torch.where(live, z[:, 3:], pts.flow))


def classify_motion(pts: DynamicPoints, cam_t, cam_q, times, obs_xy, obs_mask, K,
                    static_flow_thresh: float = 0.02,
                    min_improvement: float = 4.0) -> DynamicPoints:
    """STATIC where |flow| < static_flow_thresh; DYNAMIC where the flow is
    larger and cuts the mean squared reprojection error by at least
    ``min_improvement`` against flow 0; UNCERTAIN otherwise and in dead
    slots."""
    r_dyn = dynamic_reprojection_residuals(pts, cam_t, cam_q, times, obs_xy, obs_mask, K)
    r_sta = dynamic_reprojection_residuals(pts._replace(flow=torch.zeros_like(pts.flow)),
                                           cam_t, cam_q, times, obs_xy, obs_mask, K)
    n = torch.clamp(obs_mask.sum(dim=0), min=1.0)
    c_dyn = torch.sum(r_dyn ** 2, dim=(0, 2)) / n
    c_sta = torch.sum(r_sta ** 2, dim=(0, 2)) / n
    speed = torch.linalg.norm(pts.flow, dim=-1)
    explains = c_sta > min_improvement * torch.clamp(c_dyn, min=1e-12)
    status = torch.where(speed < static_flow_thresh,
                         torch.full_like(pts.status, MOTION_STATIC),
                         torch.where(explains, torch.full_like(pts.status, MOTION_DYNAMIC),
                                     torch.full_like(pts.status, MOTION_UNCERTAIN)))
    return pts._replace(status=torch.where(pts.mask > 0, status,
                                           torch.full_like(status, MOTION_UNCERTAIN)))
