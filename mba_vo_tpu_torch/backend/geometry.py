"""Two-view geometry, batched DLT triangulation and robust PnP.

Counterpart of ``mba_vo_tpu/backend/geometry.py``: essential and
fundamental matrices, projection matrices, triangulation as one batched
4x4 SVD (the null vector's sign cancels when the point is dehomogenised),
and a masked Huber PnP refinement by Levenberg-Marquardt on the 6-dim
tangent (the Jacobian written out, as in ``ba.py``; leading axes batch
independent problems). The PnP loop runs a fixed number of iterations and
never waits for the device; a step whose damped system is singular is NaN
and rejected, as the reference's ``jnp.linalg.solve`` makes it.

On CUDA tensors :func:`solve_pnp` and :func:`pnp_rounds_row` run kernel
K13 (``csrc/pnp.cu``, ``ops/cuda_backend.py``): every iteration of every
problem of the batch in one launch, or the call raises. On CPU tensors
they run the plain version, :func:`solve_pnp_plain`, which selects each
step with ``torch.where``.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.lie import quat_conjugate, quat_rotate, so3_hat
from ..core.transform import Pose
from .ba import _project, reprojection_jacobians, retract


def essential_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = R [t]_x."""
    return R @ so3_hat(t)


def fundamental_matrix(
    Kinv_cur: torch.Tensor, T_ref2cur: torch.Tensor, Kinv_ref: torch.Tensor
) -> torch.Tensor:
    """F = Kinv_cur^T E(R, -R^T t) Kinv_ref with T_ref2cur a 4x4 homogeneous
    transform."""
    R = T_ref2cur[..., :3, :3]
    t = T_ref2cur[..., :3, 3]
    t_ = -torch.einsum("...ji,...j->...i", R, t)
    return Kinv_cur.transpose(-1, -2) @ essential_matrix(R, t_) @ Kinv_ref


def projection_matrix(K: torch.Tensor, R_w2c: torch.Tensor,
                      t_w2c: torch.Tensor) -> torch.Tensor:
    """3x4 P = K_mat [R | t] with K = [fx, fy, cx, cy]."""
    zero = torch.zeros((), dtype=K.dtype, device=K.device)
    one = torch.ones((), dtype=K.dtype, device=K.device)
    Km = torch.stack([
        torch.stack([K[0], zero, K[2]]),
        torch.stack([zero, K[1], K[3]]),
        torch.stack([zero, zero, one]),
    ])
    Rt = torch.cat([R_w2c, t_w2c[..., None]], dim=-1)
    return Km @ Rt


def triangulate_points(
    P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor
) -> torch.Tensor:
    """Batched two-view DLT triangulation.

    P1, P2: [3, 4] (or [..., 3, 4]) projection matrices; x1, x2: [..., 2]
    pixel observations. Returns [..., 3] world points (the dehomogenised
    SVD null vector)."""
    rows = [
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)  # [..., 4, 4]
    _, _, Vt = torch.linalg.svd(A)
    X = Vt[..., 3, :]
    return X[..., :3] / X[..., 3, None]


def _project_local(points, obs_xy, K, t, q):
    """Pixel residuals [..., N, 2] of ``points`` seen from the camera-to-F
    pose (t [..., 3], q [..., 4])."""
    Pc = quat_rotate(quat_conjugate(q)[..., None, :], points - t[..., None, :])
    return _project(Pc, K)[0] - obs_xy


def solve_pnp_plain(
    points: torch.Tensor,   # [..., N, 3] 3D points (any fixed frame F)
    obs_xy: torch.Tensor,   # [..., N, 2] pixel observations in the query camera
    mask: torch.Tensor,     # [..., N] 1.0 = live correspondence
    K: torch.Tensor,        # [4] fx fy cx cy
    init: Pose,             # [...] initial camera-to-F pose guess
    huber_a: float = 2.0,
    max_iterations: int = 30,
) -> Tuple[Pose, torch.Tensor]:
    """Masked robust PnP refinement: the camera-to-F pose minimising the
    Huber reprojection error of ``points`` observed at ``obs_xy``. Runs
    exactly ``max_iterations`` LM iterations (a rejected step leaves the
    state as it was and raises the damping). Leading axes batch independent
    problems, each with its own damping. Returns (pose, final mean Huber
    cost [...])."""
    dtype = points.dtype
    n = torch.clamp(mask.sum(-1), min=1.0)
    aa = huber_a * huber_a
    eye3 = torch.eye(3, dtype=dtype, device=points.device)
    eye6 = torch.eye(6, dtype=dtype, device=points.device)

    def cost_of(t, q):
        r2 = torch.sum(_project_local(points, obs_xy, K, t, q) ** 2, dim=-1)
        x = 0.5 * r2
        sx = torch.sqrt(torch.clamp(x, min=1e-24))
        rho = torch.where(x > aa, 2.0 * huber_a * sx - aa, x)
        return torch.sum(rho * mask, dim=-1) / n

    def build(t, q):
        q_inv = quat_conjugate(q)[..., None, :]
        Pc = quat_rotate(q_inv, points - t[..., None, :])
        Rt = quat_rotate(q_inv, eye3).transpose(-1, -2)          # R^T [..., 3, 3]
        r = _project_local(points, obs_xy, K, t, q)
        J, _ = reprojection_jacobians(Pc, Rt[..., None, :, :], K)  # [..., N, 2, 6]
        r2 = torch.sum(r * r, dim=-1)
        x = 0.5 * r2
        sx = torch.sqrt(torch.clamp(x, min=1e-24))
        w2 = torch.where(x > aa, huber_a / sx, torch.ones_like(sx)) * mask
        H = torch.einsum("...nia,...n,...nib->...ab", J, w2, J) / n[..., None, None]
        g = torch.einsum("...nia,...n,...ni->...a", J, w2, r) / n[..., None]
        return H, g

    t = init.t.to(dtype)
    q = init.q.to(dtype)
    cost = cost_of(t, q)
    lam = torch.full(cost.shape, 1e-4, dtype=dtype, device=points.device)
    for _ in range(max_iterations):
        H, g = build(t, q)
        Hd = (H + lam[..., None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
              + 1e-12 * eye6)
        sol, info = torch.linalg.solve_ex(Hd, g)
        delta = torch.where((info == 0)[..., None], -sol, torch.full_like(sol, float("nan")))
        cand = retract(Pose(t, q), delta)
        cand_cost = cost_of(cand.t, cand.q)
        ok = (cand_cost < cost) & torch.all(torch.isfinite(delta), dim=-1)
        t = torch.where(ok[..., None], cand.t, t)
        q = torch.where(ok[..., None], cand.q, q)
        cost = torch.where(ok, cand_cost, cost)
        lam = torch.where(ok, lam * 0.5, lam * 4.0)
    return Pose(t=t, q=q), cost


def pnp_rounds_row(
    points: torch.Tensor,   # [..., N, 3]
    obs_xy: torch.Tensor,   # [..., N, 2]
    mask: torch.Tensor,     # [..., N]
    K: torch.Tensor,
    init: Pose,
    huber_a: float = 2.0,
    max_iterations: int = 30,
) -> torch.Tensor:
    """One PnP round's result as one row a problem, [..., N + 8] = [residual
    norms at the final pose (N) | final cost | t (3) | q (4)], the layout
    the backend's loop stage reads in one copy. On CUDA tensors K13 (one
    launch), else :func:`solve_pnp_plain` and :func:`pnp_residual_norms`."""
    if points.is_cuda:
        return _pnp_cuda(points, obs_xy, mask, K, init, huber_a, max_iterations)
    pose, cost = solve_pnp_plain(points, obs_xy, mask, K, init, huber_a, max_iterations)
    return torch.cat([pnp_residual_norms(points, obs_xy, K, pose), cost[..., None], pose.t,
                      pose.q], dim=-1)


def _pnp_cuda(points, obs_xy, mask, K, init, huber_a, max_iterations) -> torch.Tensor:
    """K13 on the problems of the leading axes, flattened into one batch."""
    from ..ops import cuda_backend

    lead, N = points.shape[:-2], points.shape[-2]
    dtype, B = points.dtype, math.prod(points.shape[:-2])

    def flat(x, *tail):
        return x.to(dtype).expand(lead + tail).reshape((B,) + tail).contiguous()
    row = cuda_backend.pnp_solve_cuda(
        flat(points, N, 3), flat(obs_xy, N, 2), flat(mask, N), K.to(dtype).contiguous(),
        flat(init.t, 3), flat(init.q, 4), huber_a, max_iterations)
    return row.reshape(lead + (N + 8,))


def solve_pnp(
    points: torch.Tensor,   # [..., N, 3] 3D points (any fixed frame F)
    obs_xy: torch.Tensor,   # [..., N, 2] pixel observations in the query camera
    mask: torch.Tensor,     # [..., N] 1.0 = live correspondence
    K: torch.Tensor,        # [4] fx fy cx cy
    init: Pose,             # [...] initial camera-to-F pose guess
    huber_a: float = 2.0,
    max_iterations: int = 30,
) -> Tuple[Pose, torch.Tensor]:
    """Masked robust PnP refinement (:func:`solve_pnp_plain`'s contract):
    K13 on CUDA tensors, the plain version on CPU tensors. Returns (pose,
    final mean Huber cost [...])."""
    if not points.is_cuda:
        return solve_pnp_plain(points, obs_xy, mask, K, init, huber_a, max_iterations)
    N = points.shape[-2]
    row = _pnp_cuda(points, obs_xy, mask, K, init, huber_a, max_iterations)
    return Pose(t=row[..., N + 1:N + 4], q=row[..., N + 4:]), row[..., N]


def pnp_residual_norms(
    points: torch.Tensor,   # [N, 3] 3D points in frame F
    obs_xy: torch.Tensor,   # [N, 2]
    K: torch.Tensor,
    pose: Pose,             # camera-to-F
) -> torch.Tensor:
    """[..., N] reprojection residual norms of ``points`` under ``pose``
    (the statistic the loop-closure inlier gate reads)."""
    return torch.linalg.norm(_project_local(points, obs_xy, K, pose.t, pose.q), dim=-1)
