"""Sliding-window bundle adjustment with Schur-complement landmark
elimination.

Counterpart of ``mba_vo_tpu/backend/ba.py``:
  * the problem is dense [W frames, M landmarks] tensors with masks;
  * each observation's reprojection Jacobian is written out: with
    Pc = R^T (X - t) and the right-multiplicative rotation retraction,
    dPc/dt = -R^T, dPc/dw = [Pc]_x, dPc/dX = R^T, times the pinhole
    projection's 2x3 derivative (zero in z where the depth clamp is
    active), giving the [2x6 | 2x3] blocks the reference takes from
    ``jax.vmap(jax.jacfwd)``;
  * the odometry priors' Jacobian is written out too
    (:func:`relative_pose_jacobians`, shared with the pose graph): the
    error rotation's right Jacobian inverse and the derivative of
    V^-1(w) t, with Taylor forms near w = 0 (forward-mode AD gives the same
    derivatives at ~20 times the operations, ~3,000 a BA iteration);
  * the normal equations are assembled blockwise by einsum
    (U [W,6,6], V [M,3,3], W_blk [W,M,6,3], g_p [W,6], g_x [M,3]),
    landmark blocks are eliminated with batched 3x3 inverses and the
    reduced camera system S = U - W V^-1 W^T is solved by Cholesky;
  * the trust-region LM loop is a host loop of three stages an iteration
    that reads one flag a iteration (stop or go on); after the stop nothing
    changes, as after the reference's ``lax.while_loop``. On the card the
    stages are the kernels K10-K12 (``ops/cuda_ba.py``,
    ``csrc/bundle_adjust.cu``); their plain versions, ``ba_build_plain``,
    ``ba_step_plain`` and ``ba_commit_plain``, run on the CPU and on the
    landmark-sharded path.

A Cholesky or 3x3 inverse that fails gives a NaN step, which the loop
rejects, as the reference's NaN-returning factorizations do. Gauge
freedom is fixed by freezing pose 0 and the padded window slots.

``group`` is the reference's ``axis_name``: with the landmarks sharded
over the ranks of a ``torch.distributed`` group (``parallel.sharded_ba``)
the pose-indexed sums (cost, its observation count, U, g_p) and the Schur
system's landmark sums are all-reduced (``utils.collectives.allreduce``),
the [6W, 6W] solve runs on every rank alike, and the landmark blocks and
their back-substitution stay on their rank.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.lie import (
    _se3_V_inv,
    quat_conjugate,
    quat_exp,
    quat_log,
    quat_multiply,
    quat_rotate,
    se3_log,
    so3_hat,
)
from ..core.transform import Pose
from ..ops import cuda_ba
from ..ops.cuda_ba import (B_BUILD_COST, B_CAND_COST, B_COST, B_COST0, B_DONE, B_IT, B_LAM,
                           B_OK, B_REL, B_SIZE)
from ..utils.collectives import allreduce
from .map import SlidingWindowMap


@dataclasses.dataclass(frozen=True)
class BAOptions:
    max_iterations: int = 20
    huber_a: float = 2.0            # pixels (reprojection units)
    initial_lambda: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    min_rel_decrease: float = 1e-9
    landmark_damping: float = 1e-8  # keeps V invertible for unobserved slots


class OdomPrior(NamedTuple):
    """Relative-pose odometry priors between consecutive window poses:
    r_e = log(T_meas^-1 (T_e^-1 T_{e+1})), cost 0.5 weight_e ||r_e||^2;
    weight 0 disables an edge (padding while the window fills up)."""

    t: torch.Tensor       # [W-1, 3] measured relative translation (in frame e)
    q: torch.Tensor       # [W-1, 4] measured relative rotation
    weight: torch.Tensor  # [W-1]


class BAProblem(NamedTuple):
    poses: Pose                 # [W] camera-to-world
    map: SlidingWindowMap
    K: torch.Tensor             # [4] fx fy cx cy
    odom: Optional[OdomPrior] = None
    # [W] 1.0 = live pose, 0.0 = padding (frozen like the gauge pose)
    pose_mask: Optional[torch.Tensor] = None


class BASummary(NamedTuple):
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    num_iterations: int


def _camera_points(problem: BAProblem):
    """(Pc [W,M,3], R^T [W,3,3]) of every landmark in every window camera."""
    q_inv = quat_conjugate(problem.poses.q)                       # [W, 4]
    Pc = quat_rotate(q_inv[:, None, :],
                     problem.map.points[None] - problem.poses.t[:, None, :])
    eye = torch.eye(3, dtype=Pc.dtype, device=Pc.device)
    Rt = quat_rotate(q_inv[:, None, :], eye[None]).transpose(-1, -2)  # [W, 3, 3]
    return Pc, Rt


def _project(Pc: torch.Tensor, K: torch.Tensor):
    z = torch.clamp(Pc[..., 2], min=1e-6)
    proj = torch.stack([Pc[..., 0] / z * K[0] + K[2], Pc[..., 1] / z * K[1] + K[3]],
                       dim=-1)
    return proj, z


def _residuals(problem: BAProblem) -> torch.Tensor:
    """r [W,M,2] = project_w2c(X) - obs."""
    Pc, _ = _camera_points(problem)
    proj, _ = _project(Pc, problem.K)
    return proj - problem.map.obs_xy


def reprojection_jacobians(Pc: torch.Tensor, Rt: torch.Tensor, K: torch.Tensor):
    """(J_pose [..., 2, 6], J_point [..., 2, 3]) of the pinhole residual of
    camera points Pc [..., 3] = R^T (X - t) under the retraction
    t + dt, q (x) exp(dw): dPc/dt = -R^T, dPc/dw = [Pc]_x, dPc/dX = R^T
    (Rt [..., 3, 3] broadcast against Pc), times the projection's 2x3
    derivative, zero in z where the depth clamp at 1e-6 is active."""
    z = torch.clamp(Pc[..., 2], min=1e-6)
    inv_z = 1.0 / z
    live = (Pc[..., 2] > 1e-6).to(Pc.dtype)
    zero = torch.zeros_like(z)
    dproj = torch.stack([
        torch.stack([K[0] * inv_z, zero, -K[0] * Pc[..., 0] * inv_z * inv_z * live], -1),
        torch.stack([zero, K[1] * inv_z, -K[1] * Pc[..., 1] * inv_z * inv_z * live], -1),
    ], dim=-2)                                                    # [..., 2, 3]
    J_point = dproj @ Rt.expand(Pc.shape[:-1] + (3, 3))
    J_pose = torch.cat([-J_point, dproj @ so3_hat(Pc)], dim=-1)
    return J_pose, J_point


def _residuals_and_jacobians(problem: BAProblem):
    """r [W,M,2], J_pose [W,M,2,6], J_point [W,M,2,3]. Pose tangent layout
    [dt(3); dw(3)], right-multiplicative rotation retraction."""
    Pc, Rt = _camera_points(problem)
    proj, _ = _project(Pc, problem.K)
    J_pose, J_point = reprojection_jacobians(Pc, Rt[:, None], problem.K)
    return proj - problem.map.obs_xy, J_pose, J_point


def _huber_weight(r2, a):
    """(rho, drho/dx) of x = r2 / 2 under the Huber parameter a."""
    aa = a * a
    x = 0.5 * r2
    sx = torch.sqrt(torch.clamp(x, min=1e-24))
    big = x > aa
    rho = torch.where(big, 2.0 * a * sx - aa, x)
    w2 = torch.where(big, a / sx, torch.ones_like(sx))
    return rho, w2


def relative_pose_residuals(ti, qi, tj, qj, tm, qm) -> torch.Tensor:
    """[..., 6] residuals log(T_m^-1 (T_i^-1 T_j)) of measured relative
    poses T_m (the odometry prior's and the pose graph's edges)."""
    qi_inv = quat_conjugate(qi)
    q_rel = quat_multiply(qi_inv, qj)
    t_rel = quat_rotate(qi_inv, tj - ti)
    qm_inv = quat_conjugate(qm)
    q_err = quat_multiply(qm_inv, q_rel)
    t_err = quat_rotate(qm_inv, t_rel - tm)
    return se3_log(t_err, q_err)


def _odom_residuals(poses: Pose, odom: OdomPrior) -> torch.Tensor:
    """[W-1, 6] prior residuals log(T_meas^-1 (T_e^-1 T_{e+1}))."""
    return relative_pose_residuals(poses.t[:-1], poses.q[:-1], poses.t[1:], poses.q[1:],
                                   odom.t, odom.q)


def _transposed_rotation(q: torch.Tensor) -> torch.Tensor:
    """R(q)^T [..., 3, 3]."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return quat_rotate(quat_conjugate(q)[..., None, :], eye).transpose(-1, -2)


def _log_coefficients(w: torch.Tensor):
    """(c, c'/theta) of c(theta) = (1 - (theta/2) cot(theta/2)) / theta^2,
    the [w]_x^2 coefficient of both V^-1(w) and the SO(3) right Jacobian
    inverse, with their Taylor forms below theta^2 = 1e-4 (float64) or 1e-2
    (narrower), where the closed forms cancel."""
    th2 = torch.sum(w * w, dim=-1)
    small = th2 < (1e-4 if torch.finfo(w.dtype).bits >= 64 else 1e-2)
    th2s = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2s)
    h = 0.5 * th
    cot = torch.cos(h) / torch.sin(h)
    f = 1.0 - h * cot
    df = -0.5 * cot + 0.5 * h / torch.sin(h) ** 2
    c = torch.where(small, 1.0 / 12.0 + th2 / 720.0 + th2 * th2 / 30240.0, f / th2s)
    dc = torch.where(small, 1.0 / 360.0 + th2 / 7560.0 + th2 * th2 / 201600.0,
                     (df / th2s - 2.0 * f / (th2s * th)) / th)
    return c, dc


def relative_pose_jacobians(ti, qi, tj, qj, tm, qm):
    """Residuals r = log(T_m^-1 (T_i^-1 T_j)) [E, 6] and their Jacobians
    J_i, J_j [E, 6, 6] with respect to the tangents [dt; dw] of poses i and
    j under t + dt, q (x) exp(dw).

    With T_err = T_m^-1 T_i^-1 T_j and w = log(q_err): to first order
    t_err moves by R_m^T (R_i^T (dt_j - dt_i) + [t_rel]_x dw_i) and q_err
    by the right perturbation dw_j - R_err^T R_m^T dw_i, which moves w by
    Jr^-1(w) times it; r = [V^-1(w) t_err; w]."""
    qi_inv = quat_conjugate(qi)
    q_rel = quat_multiply(qi_inv, qj)
    t_rel = quat_rotate(qi_inv, tj - ti)
    qm_inv = quat_conjugate(qm)
    q_err = quat_multiply(qm_inv, q_rel)
    t_err = quat_rotate(qm_inv, t_rel - tm)
    w = quat_log(q_err)
    V_inv = _se3_V_inv(w)
    r = torch.cat([torch.einsum("...ij,...j->...i", V_inv, t_err), w], dim=-1)

    c, dc = _log_coefficients(w)
    Wx = so3_hat(w)
    WW = Wx @ Wx
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    Jr_inv = eye + 0.5 * Wx + c[..., None, None] * WW
    # d(V^-1(w) t)/dw with V^-1 = I - [w]_x / 2 + c [w]_x^2
    wt = torch.sum(w * t_err, dim=-1)
    WWt = w * wt[..., None] - t_err * torch.sum(w * w, dim=-1)[..., None]
    d_WWt = (wt[..., None, None] * eye + w[..., :, None] * t_err[..., None, :]
             - 2.0 * t_err[..., :, None] * w[..., None, :])
    D = (0.5 * so3_hat(t_err) + c[..., None, None] * d_WWt
         + dc[..., None, None] * WWt[..., :, None] * w[..., None, :])

    RmT = _transposed_rotation(qm)
    dt_dti = -(RmT @ _transposed_rotation(qi))        # d t_err / d dt_i (= -d/d dt_j)
    dt_dwi = RmT @ so3_hat(t_rel)
    dth_dwi = -(_transposed_rotation(q_err) @ RmT)
    DJ = D @ Jr_inv
    zero = torch.zeros_like(dt_dti)
    J_i = torch.cat([torch.cat([V_inv @ dt_dti, V_inv @ dt_dwi + DJ @ dth_dwi], -1),
                     torch.cat([zero, Jr_inv @ dth_dwi], -1)], -2)
    J_j = torch.cat([torch.cat([-(V_inv @ dt_dti), DJ], -1),
                     torch.cat([zero, Jr_inv], -1)], -2)
    return r, J_i, J_j


def _odom_cost(poses: Pose, odom: Optional[OdomPrior], inv_n) -> torch.Tensor:
    """Scalar prior cost, scaled by the reprojection cost's 1/n."""
    if odom is None:
        return torch.zeros((), dtype=poses.t.dtype, device=poses.t.device)
    r = _odom_residuals(poses, odom)
    return 0.5 * torch.sum(odom.weight[:, None] * r * r) * inv_n


def _odom_terms(poses: Pose, odom: Optional[OdomPrior], inv_n):
    """(cost, g [W,6], H [6W,6W]) of the Gauss-Newton-linearised prior at
    the current poses."""
    Wn = poses.t.shape[0]
    opts = dict(dtype=poses.t.dtype, device=poses.t.device)
    if odom is None:
        return (torch.zeros((), **opts), torch.zeros((Wn, 6), **opts),
                torch.zeros((Wn * 6, Wn * 6), **opts))
    r0, J_i, J_j = relative_pose_jacobians(poses.t[:-1], poses.q[:-1], poses.t[1:],
                                           poses.q[1:], odom.t, odom.q)
    e = torch.arange(Wn - 1, device=poses.t.device)
    J = torch.zeros((Wn - 1, 6, Wn, 6), **opts)
    J[e, :, e] = J_i
    J[e, :, e + 1] = J_j
    J = J.reshape((Wn - 1) * 6, Wn * 6)
    wrow = torch.repeat_interleave(odom.weight, 6)
    cost = 0.5 * torch.sum(wrow * r0.reshape(-1) ** 2) * inv_n
    g = (J.T @ (wrow * r0.reshape(-1))).reshape(Wn, 6) * inv_n
    H = (J.T * wrow[None, :]) @ J * inv_n
    return cost, g, H


def build_normal_equations(problem: BAProblem, huber_a: float, group=None):
    """Blockwise GN system with robust weights. Returns
    (cost, U, V, W_blk, g_p, g_x, H_odom, mask). With ``group`` the cost,
    U and g_p are global and V, W_blk and g_x cover this rank's
    landmarks."""
    r, Jp, Jx = _residuals_and_jacobians(problem)
    m = problem.map
    mask = m.obs_mask * m.point_mask[None, :]          # [W, M]
    r2 = torch.sum(r * r, dim=-1)                      # [W, M]
    rho, w2 = _huber_weight(r2, huber_a)
    wgt = w2 * mask

    n = torch.clamp(allreduce(mask.sum(), group), min=1.0)
    cost = allreduce(torch.sum(rho * mask), group) / n

    U = allreduce(torch.einsum("wmia,wm,wmib->wab", Jp, wgt, Jp), group)
    V = torch.einsum("wmia,wm,wmib->mab", Jx, wgt, Jx)
    Wb = torch.einsum("wmia,wm,wmib->wmab", Jp, wgt, Jx)
    g_p = allreduce(torch.einsum("wmia,wm,wmi->wa", Jp, wgt, r), group)
    g_x = torch.einsum("wmia,wm,wmi->ma", Jx, wgt, r)

    # the prior's g and H stay unnormalised like U and g_p: the step then
    # optimises the same relative weighting as the (1/n-scaled) cost. They
    # are pose-indexed, the same on every rank, and added after the
    # all-reduce so that they count once
    c_o, g_o, H_o = _odom_terms(problem.poses, problem.odom, 1.0)
    return cost + c_o / n, U, V, Wb, g_p + g_o, g_x, H_o, mask


def evaluate_cost(problem: BAProblem, huber_a: float, group=None) -> torch.Tensor:
    r = _residuals(problem)
    m = problem.map
    mask = m.obs_mask * m.point_mask[None, :]
    rho, _ = _huber_weight(torch.sum(r * r, dim=-1), huber_a)
    n = torch.clamp(allreduce(mask.sum(), group), min=1.0)
    cost = allreduce(torch.sum(rho * mask), group) / n
    return cost + _odom_cost(problem.poses, problem.odom, 1.0 / n)


def _nan_unless(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where the factorisation succeeded (info == 0), NaN elsewhere."""
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def reduced_camera_system(U, V, Wb, g_p, g_x, lam: torch.Tensor, opts: BAOptions,
                          H_pose=None, pose_mask=None, group=None):
    """The damped, gauge-fixed reduced camera system of :func:`schur_solve`:
    (S [6W, 6W], rhs [6W], V^-1 [M, 3, 3] (NaN where the inverse fails),
    the gauged W_blk [W, M, 6, 3], the gauge [W])."""
    Wn = Wb.shape[0]
    opts_t = dict(dtype=U.dtype, device=U.device)
    eye6 = torch.eye(6, **opts_t)
    eye3 = torch.eye(3, **opts_t)

    gauge = torch.ones((Wn,), **opts_t)
    gauge[0] = 0.0
    if pose_mask is not None:
        gauge = gauge * pose_mask
    U = U * gauge[:, None, None]
    Wb = Wb * gauge[:, None, None, None]
    g_p = g_p * gauge[:, None]

    # LM damping: scale the diagonals by (1 + lambda)
    U = U + (lam * torch.diagonal(U, dim1=-2, dim2=-1))[..., None] * eye6[None]
    V = V + (lam * torch.diagonal(V, dim1=-2, dim2=-1))[..., None] * eye3[None]
    V = V + opts.landmark_damping * eye3[None]
    U = U + (1.0 - gauge)[:, None, None] * eye6[None]

    Vinv, v_info = torch.linalg.inv_ex(V)                  # [M,3,3]
    Vinv = _nan_unless((v_info == 0)[:, None, None], Vinv)
    WVi = torch.einsum("wmab,mbc->wmac", Wb, Vinv)         # [W,M,6,3]

    S_blocks = allreduce(torch.einsum("wmac,vmbc->wavb", WVi, Wb), group)   # [W,6,W,6]
    S = -S_blocks.reshape(Wn * 6, Wn * 6)
    S = S + torch.block_diag(*U.unbind(0))
    if H_pose is not None:
        # pose-pose coupling (odometry prior): gauge-projected, with the
        # same multiplicative diagonal damping
        gauge6 = torch.repeat_interleave(gauge, 6)
        He = H_pose * gauge6[:, None] * gauge6[None, :]
        He = He + lam * torch.diag(torch.diagonal(He))
        S = S + He

    rhs = (g_p - allreduce(torch.einsum("wmac,mc->wa", WVi, g_x), group)).reshape(-1)
    return S, rhs, Vinv, Wb, gauge


def schur_solve(U, V, Wb, g_p, g_x, lam: torch.Tensor, opts: BAOptions,
                H_pose=None, pose_mask=None, group=None):
    """Solve the damped GN system by eliminating the landmark blocks.

    Returns (delta_pose [W,6], delta_point [M,3]). Pose 0 (and every padded
    pose) is gauge-fixed: its rows/cols are zeroed and its diagonal block
    replaced by the identity, so its step is exactly 0. With ``group``
    (landmark shards) the reduced camera system and its right-hand side
    are all-reduced and delta_point covers this rank's landmarks."""
    Wn = Wb.shape[0]
    S, rhs, Vinv, Wb, gauge = reduced_camera_system(U, V, Wb, g_p, g_x, lam, opts, H_pose,
                                                    pose_mask, group)
    L, info = torch.linalg.cholesky_ex(S)
    dp = -torch.cholesky_solve(rhs[:, None], L)[:, 0]
    dp = _nan_unless(info == 0, dp)
    dp = dp.reshape(Wn, 6) * gauge[:, None]

    dx = -torch.einsum(
        "mab,mb->ma", Vinv, g_x + torch.einsum("wmab,wa->mb", Wb, dp))
    return dp, dx


def retract(poses: Pose, delta: torch.Tensor) -> Pose:
    """Poses moved by tangents delta [..., 6] = [dt; dw]: t + dt,
    q (x) exp(dw) (the retraction of BA, the pose graph and PnP)."""
    return Pose(t=poses.t + delta[..., :3],
                q=quat_multiply(poses.q, quat_exp(delta[..., 3:])))


def _apply_step(problem: BAProblem, dp: torch.Tensor, dx: torch.Tensor) -> BAProblem:
    new_points = problem.map.points + dx * problem.map.point_mask[:, None]
    return problem._replace(
        poses=retract(problem.poses, dp),
        map=problem.map._replace(points=new_points),
    )


def _select(ok: torch.Tensor, a: BAProblem, b: BAProblem) -> BAProblem:
    return b._replace(
        poses=Pose(t=torch.where(ok, a.poses.t, b.poses.t),
                   q=torch.where(ok, a.poses.q, b.poses.q)),
        map=b.map._replace(points=torch.where(ok, a.map.points, b.map.points)),
    )


# ------------------------------------------------ the LM iteration's stages
#
# An iteration is three stages, each the plain version of one kernel
# (ops/cuda_ba.py, csrc/bundle_adjust.cu): K10 ba_build, K11 ba_step, K12
# ba_commit. The loop's state is the problem's poses and points and a
# scalars vector of its dtype (cuda_ba.B_*: the cost, lambda, the
# iterations, the done flag, the initial cost, the build's cost and the last
# candidate's cost, ok flag and relative decrease).


def ba_initial_scalars(problem: BAProblem, opts: BAOptions, group=None) -> torch.Tensor:
    """The loop's scalars before its first iteration: the cost and the
    initial cost both evaluate_cost at the problem, lambda
    ``opts.initial_lambda``, every other entry 0."""
    cost0 = evaluate_cost(problem, opts.huber_a, group)
    scalars = cost0.new_zeros(B_SIZE)
    scalars[B_COST] = cost0
    scalars[B_COST0] = cost0
    scalars[B_LAM] = opts.initial_lambda
    return scalars


def ba_build_plain(problem: BAProblem, huber_a: float, group=None):
    """K10's plain version: (cost, U, V, W_blk, g_p, g_x, H_odom) of
    :func:`build_normal_equations` at the problem. (K10 also writes the
    loop's initial cost, :func:`evaluate_cost` at the problem, where the
    scalars count no iteration yet: :func:`ba_initial_scalars` here.)"""
    return build_normal_equations(problem, huber_a, group)[:7]


def ba_step_plain(problem: BAProblem, scalars: torch.Tensor, built, opts: BAOptions,
                  group=None):
    """K11's plain version: the damped Schur step on ``built`` (K10's
    outputs) at the scalars' lambda, and the candidate it gives. Returns
    (dp [W,6], dx [M,3], cand t [W,3], cand q [W,4], cand X [M,3])."""
    _, U, V, Wb, g_p, g_x, H_o = built
    dp, dx = schur_solve(U, V, Wb, g_p, g_x, scalars[B_LAM], opts, H_pose=H_o,
                         pose_mask=problem.pose_mask, group=group)
    cand = _apply_step(problem, dp, dx)
    return dp, dx, cand.poses.t, cand.poses.q, cand.map.points


def ba_commit_plain(problem: BAProblem, scalars: torch.Tensor, candidate, opts: BAOptions,
                    group=None) -> Tuple[BAProblem, torch.Tensor]:
    """K12's plain version: the candidate's cost, the decision (the cost
    decreases and dp and dx are finite), the next problem and scalars.
    Where the scalars are done already nothing changes.

    With ``group`` whether dx is finite is all-reduced too, so every rank
    accepts or rejects the same steps and stops at the same iteration."""
    dp, dx, cand_t, cand_q, cand_X = candidate
    cand = problem._replace(poses=Pose(t=cand_t, q=cand_q),
                            map=problem.map._replace(points=cand_X))
    cand_cost = evaluate_cost(cand, opts.huber_a, group)
    cost, lam, it = scalars[B_COST], scalars[B_LAM], scalars[B_IT]
    done = scalars[B_DONE] != 0
    live = ~done
    dx_finite = allreduce((~torch.isfinite(dx)).sum(), group) == 0
    ok = (cand_cost < cost) & torch.all(torch.isfinite(dp)) & dx_finite & live
    rel_decrease = (cost - cand_cost) / torch.clamp(cost, min=1e-24)
    new_lam = torch.where(
        ok,
        torch.clamp(lam * opts.lambda_down, min=opts.min_lambda),
        torch.clamp(lam * opts.lambda_up, max=opts.max_lambda),
    )
    new = torch.stack([
        torch.where(ok, cand_cost, cost),
        torch.where(live, new_lam, lam),
        it + live.to(it.dtype),
        (done | (ok & (rel_decrease < opts.min_rel_decrease))).to(cost.dtype),
        scalars[B_COST0],
        scalars[B_BUILD_COST],
        torch.where(live, cand_cost, scalars[B_CAND_COST]),
        torch.where(live, ok.to(cost.dtype), scalars[B_OK]),
        torch.where(live, rel_decrease, scalars[B_REL]),
    ])
    return _select(ok, cand, problem), new


def run_bundle_adjustment(
    problem: BAProblem, opts: BAOptions, group=None
) -> Tuple[BAProblem, BASummary]:
    """LM loop over the Schur-reduced system. Each iteration is three
    stages and reads one flag from the device: whether the loop stops.

    On CUDA tensors without ``group`` the stages are the kernels K10-K12
    (``ops.cuda_ba.BABinding``: the problem checked and bound once, its
    poses and points copied, K10 writing the initial cost at the first
    iteration). On CPU tensors, and with ``group`` (the landmark shards'
    process group when ``problem.map`` holds this rank's landmarks,
    ``parallel.sharded_ba``), the plain stages run, with the all-reduces
    between them."""
    if group is None and problem.poses.t.is_cuda:
        binding = cuda_ba.BABinding(problem, opts)
        if opts.max_iterations < 1:
            binding.build()                 # its initial cost
        it = 0
        while it < opts.max_iterations:
            binding.build()
            binding.step()
            binding.commit()
            it += 1
            if bool(binding.scalars[B_DONE]):
                break
        problem, scalars = binding.state_problem(), binding.scalars
    else:
        return run_plain_stages(problem, opts, group)
    return problem, BASummary(initial_cost=scalars[B_COST0], final_cost=scalars[B_COST],
                              num_iterations=it)


def run_plain_stages(problem: BAProblem, opts: BAOptions,
                     group=None) -> Tuple[BAProblem, BASummary]:
    """The LM loop on the plain stages, whatever the device: the path of
    :func:`run_bundle_adjustment` on CPU tensors and with ``group`` (and,
    on the card, the yardstick the kernels are timed beside)."""
    scalars = ba_initial_scalars(problem, opts, group)
    it = 0
    while it < opts.max_iterations:
        built = ba_build_plain(problem, opts.huber_a, group)
        candidate = ba_step_plain(problem, scalars, built, opts, group)
        problem, scalars = ba_commit_plain(problem, scalars, candidate, opts, group)
        it += 1
        if bool(scalars[B_DONE]):
            break
    return problem, BASummary(initial_cost=scalars[B_COST0], final_cost=scalars[B_COST],
                              num_iterations=it)
