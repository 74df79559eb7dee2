"""Continuous-time SE(3) B-spline trajectory (degree 2 = linear, degree 4 =
cumulative cubic).

Counterpart of ``mba_vo_tpu/core/spline.py``. Knots are a named tuple
``SplineKnots(t[K,3], q[K,4], t0, dt)`` of tensors; pose interpolation is a
plain function of the knots. Jacobians w.r.t. the right-multiplicative
knot tangents are written out in forward mode: :func:`spline_retract_jvp`
seeds them and :func:`spline_pose_at_times_jvp` carries them through the
interpolation (``core.lie``'s ``*_jvp`` helpers), one batched op a step.

Interpolation:
  degree 2:  t(u) = (1-u) t_0 + u t_1;   R(u) = R_0 exp(u log(R_0^-1 R_1))
  degree 4:  uniform cubic B-spline basis for t; cumulative form for R.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import (
    quat_conjugate,
    quat_exp,
    quat_exp_jvp,
    quat_log,
    quat_log_jvp,
    quat_multiply,
    quat_multiply_jvp,
    quat_rotate,
)
from .transform import Pose


class SplineKnots(NamedTuple):
    """SE(3) spline control knots.

    t:  [K, 3] translation knots (body->world)
    q:  [K, 4] orientation knots, xyzw (body->world)
    t0: scalar spline start time
    dt: scalar knot sampling interval
    """

    t: torch.Tensor
    q: torch.Tensor
    t0: torch.Tensor
    dt: torch.Tensor

    @property
    def num_knots(self) -> int:
        return self.t.shape[0]


def make_knots(t, q, t0, dt) -> SplineKnots:
    t = torch.as_tensor(t)
    opts = dict(dtype=t.dtype, device=t.device)
    return SplineKnots(
        t=t,
        q=torch.as_tensor(q, **opts),
        t0=torch.as_tensor(t0, **opts),
        dt=torch.as_tensor(dt, **opts),
    )


def identity_knots(num_knots: int, t0=0.0, dt=1.0, dtype=torch.float32,
                   device=None) -> SplineKnots:
    """Identity-initialized spline."""
    t = torch.zeros((num_knots, 3), dtype=dtype, device=device)
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device).repeat(num_knots, 1)
    return SplineKnots(t, q, torch.as_tensor(t0, dtype=dtype, device=device),
                       torch.as_tensor(dt, dtype=dtype, device=device))


def spline_segment_start_and_u(time, t0, dt, num_knots: int, degree: int):
    """Knot segment containing ``time`` and its normalized offset, with the
    start index clamped to ``[0, K - degree]``: boundary times would otherwise
    index past the knot array (torch raises on the CPU and reads out of
    bounds on CUDA, where JAX clamps)."""
    tn = (time - t0) / dt
    idx = torch.floor(tn)
    idx = torch.clamp(idx, 0, num_knots - degree)
    u = tn - idx
    return idx.to(torch.int64), u


def _vec_basis(u: torch.Tensor, degree: int) -> torch.Tensor:
    """B-spline position basis weights, shape [..., degree]."""
    if degree == 2:
        return torch.stack([1.0 - u, u], dim=-1)
    if degree == 4:
        uu = u * u
        uuu = uu * u
        one_six = 1.0 / 6.0
        c0 = one_six - 0.5 * u + 0.5 * uu - one_six * uuu
        c1 = 4.0 * one_six - uu + 0.5 * uuu
        c2 = one_six + 0.5 * u + 0.5 * uu - 0.5 * uuu
        c3 = one_six * uuu
        return torch.stack([c0, c1, c2, c3], dim=-1)
    raise ValueError(f"spline degree must be 2 or 4, got {degree}")


def _rot_cum_basis(u: torch.Tensor, degree: int) -> torch.Tensor:
    """Cumulative rotation basis weights, shape [..., degree-1]."""
    if degree == 2:
        return u[..., None]
    if degree == 4:
        uu = u * u
        uuu = uu * u
        one_six = 1.0 / 6.0
        c1 = 5.0 * one_six + 0.5 * u - 0.5 * uu + one_six * uuu
        c2 = one_six + 0.5 * u + 0.5 * uu - 2.0 * one_six * uuu
        c3 = one_six * uuu
        return torch.stack([c1, c2, c3], dim=-1)
    raise ValueError(f"spline degree must be 2 or 4, got {degree}")


def spline_interp_t(knots_window_t: torch.Tensor, u: torch.Tensor, degree: int) -> torch.Tensor:
    """Interpolate translation from a [..., degree, 3] knot window at offset u."""
    w = _vec_basis(u, degree)
    return torch.einsum("...k,...ki->...i", w, knots_window_t)


def spline_interp_q(knots_window_q: torch.Tensor, u: torch.Tensor, degree: int) -> torch.Tensor:
    """Interpolate orientation from a [..., degree, 4] knot window at offset u:
    R_0 * prod_j exp(c_j * log(R_{j-1}^-1 R_j))."""
    coeffs = _rot_cum_basis(u, degree)
    q = knots_window_q[..., 0, :]
    for j in range(degree - 1):
        rel = quat_multiply(
            quat_conjugate(knots_window_q[..., j, :]), knots_window_q[..., j + 1, :]
        )
        omega = quat_log(rel) * coeffs[..., j, None]
        q = quat_multiply(q, quat_exp(omega))
    return q


def spline_interp_t_jvp(knots_window_t, dknots_window_t, u, degree: int):
    """:func:`spline_interp_t` and its tangent along the D seeds
    ``dknots_window_t`` [D, ..., degree, 3] (u does not depend on the knots)."""
    w = _vec_basis(u, degree)
    return (torch.einsum("...k,...ki->...i", w, knots_window_t),
            torch.einsum("...k,d...ki->d...i", w, dknots_window_t))


def spline_interp_q_jvp(knots_window_q, dknots_window_q, u, degree: int):
    """:func:`spline_interp_q` and its tangent along the D seeds
    ``dknots_window_q`` [D, ..., degree, 4]: the same steps, each with its
    forward-mode rule."""
    coeffs = _rot_cum_basis(u, degree)
    q, dq = knots_window_q[..., 0, :], dknots_window_q[..., 0, :]
    for j in range(degree - 1):
        rel, drel = quat_multiply_jvp(
            quat_conjugate(knots_window_q[..., j, :]), knots_window_q[..., j + 1, :],
            quat_conjugate(dknots_window_q[..., j, :]), dknots_window_q[..., j + 1, :])
        log, dlog = quat_log_jvp(rel, drel)
        e, de = quat_exp_jvp(log * coeffs[..., j, None], dlog * coeffs[..., j, None])
        q, dq = quat_multiply_jvp(q, e, dq, de)
    return q, dq


def spline_pose_at_times_jvp(knots: SplineKnots, dknots_t: torch.Tensor,
                             dknots_q: torch.Tensor, times: torch.Tensor, degree: int):
    """:func:`spline_pose_at_times` at [T] times and its tangent along D
    knot tangents ``dknots_t`` [D, K, 3], ``dknots_q`` [D, K, 4]: returns
    (Pose [T, ...], dt [D, T, 3], dq [D, T, 4]). The segment index is
    clamped as in the primal, so the tangents of knots outside a time's taps
    do not reach it."""
    times = torch.as_tensor(times, dtype=knots.t.dtype, device=knots.t.device)
    idx, u = spline_segment_start_and_u(
        times, knots.t0, knots.dt, knots.num_knots, degree
    )
    taps = idx[..., None] + torch.arange(degree, device=idx.device)  # [T, deg]
    t, dt = spline_interp_t_jvp(knots.t[taps], dknots_t[:, taps], u, degree)
    q, dq = spline_interp_q_jvp(knots.q[taps], dknots_q[:, taps], u, degree)
    return Pose(t=t, q=q), dt, dq


def spline_pose_at_times(knots: SplineKnots, times: torch.Tensor, degree: int) -> Pose:
    """Sample the spline at a [N]-shaped times tensor -> Pose with [N, ...]."""
    times = torch.as_tensor(times, dtype=knots.t.dtype, device=knots.t.device)
    idx, u = spline_segment_start_and_u(
        times, knots.t0, knots.dt, knots.num_knots, degree
    )
    taps = idx[..., None] + torch.arange(degree, device=idx.device)  # [N, deg]
    wt = knots.t[taps]  # [N, deg, 3]
    wq = knots.q[taps]  # [N, deg, 4]
    return Pose(t=spline_interp_t(wt, u, degree), q=spline_interp_q(wq, u, degree))


def spline_pose_at(knots: SplineKnots, time, degree: int) -> Pose:
    """Sample the spline pose at a scalar time."""
    time = torch.as_tensor(time, dtype=knots.t.dtype, device=knots.t.device)
    p = spline_pose_at_times(knots, time.reshape(1), degree)
    return Pose(t=p.t[0], q=p.q[0])


def spline_retract(knots: SplineKnots, delta_t: torch.Tensor,
                   delta_omega: torch.Tensor) -> SplineKnots:
    """Manifold retraction of all knots: t += dt, q <- q * exp(omega).
    delta_t, delta_omega: [K, 3]."""
    return knots._replace(
        t=knots.t + delta_t,
        q=quat_multiply(knots.q, quat_exp(delta_omega)),
    )


def spline_retract_jvp(knots: SplineKnots, delta_t: torch.Tensor, delta_omega: torch.Tensor,
                       ddelta_t: torch.Tensor, ddelta_omega: torch.Tensor):
    """:func:`spline_retract` and the knots' tangents along D seeds of the
    step, ``ddelta_t`` and ``ddelta_omega`` [D, K, 3]: returns (knots,
    dt [D, K, 3], dq [D, K, 4])."""
    e, de = quat_exp_jvp(delta_omega, ddelta_omega)
    q, dq = quat_multiply_jvp(knots.q, e, None, de)
    return knots._replace(t=knots.t + delta_t, q=q), ddelta_t, dq


def spline_retract_flat(knots: SplineKnots, step: torch.Tensor) -> SplineKnots:
    """Retract with a flat [6K] step laid out [all t knots; all omega knots]."""
    k = knots.num_knots
    delta_t = step[: 3 * k].reshape(k, 3).to(knots.t.dtype)
    delta_o = step[3 * k:].reshape(k, 3).to(knots.t.dtype)
    return spline_retract(knots, delta_t, delta_o)


def spline_transform_to(knots: SplineKnots, time, target: Pose, degree: int) -> SplineKnots:
    """Right-translate the trajectory so that pose(time) == target."""
    cur = spline_pose_at(knots, time, degree)
    dq = quat_multiply(quat_conjugate(cur.q), target.q)
    dt = quat_rotate(quat_conjugate(cur.q), target.t - cur.t)
    return spline_transform_by_right(knots, Pose(t=dt, q=dq))


def spline_transform_by(knots: SplineKnots, d: Pose) -> SplineKnots:
    """Left-compose every knot with d: t_i <- R_d t_i + t_d ; R_i <- R_d R_i."""
    return knots._replace(
        t=quat_rotate(d.q[None, :], knots.t) + d.t[None, :],
        q=quat_multiply(d.q[None, :].expand(knots.q.shape), knots.q),
    )


def spline_transform_by_right(knots: SplineKnots, d: Pose) -> SplineKnots:
    """Right-compose every knot with d: t_i += R_i d_t ; R_i <- R_i d_R."""
    return knots._replace(
        t=knots.t + quat_rotate(knots.q, d.t.expand(knots.t.shape)),
        q=quat_multiply(knots.q, d.q.expand(knots.q.shape)),
    )


def insert_control_knot(knots: SplineKnots, t_new, q_new) -> SplineKnots:
    """Append one control knot at the window end (the knot count grows)."""
    opts = dict(dtype=knots.t.dtype, device=knots.t.device)
    return knots._replace(
        t=torch.cat([knots.t, torch.as_tensor(t_new, **opts)[None]], dim=0),
        q=torch.cat([knots.q, torch.as_tensor(q_new, **opts)[None]], dim=0),
    )


def pop_front_control_knot(knots: SplineKnots) -> SplineKnots:
    """Drop the first control knot and advance the spline start time by one
    knot interval."""
    return knots._replace(t=knots.t[1:], q=knots.q[1:], t0=knots.t0 + knots.dt)


def slide_control_window(knots: SplineKnots, t_new, q_new) -> SplineKnots:
    """Pop-front + append at constant knot count: the steady-state advance
    of the joint multi-frame window."""
    return insert_control_knot(pop_front_control_knot(knots), t_new, q_new)


def extrapolate_knot(knots: SplineKnots) -> Pose:
    """Constant-velocity prediction of the knot one interval past the window
    end: the relative transform between the last two knots, applied again on
    the right of the last knot."""
    t_a, q_a = knots.t[-2], knots.q[-2]
    t_b, q_b = knots.t[-1], knots.q[-1]
    dq = quat_multiply(quat_conjugate(q_a), q_b)
    dt_local = quat_rotate(quat_conjugate(q_a), t_b - t_a)
    return Pose(t=t_b + quat_rotate(q_b, dt_local), q=quat_multiply(q_b, dq))


def virtual_pose_times(cap_time, exp_time, num_vir: int) -> torch.Tensor:
    """Exposure-window sample times, shape [..., num_vir]:
    t_v = t_cap - tau/2 + v * tau/(V-1), with a 1e-8 guard in the divisor so
    V = 1 degenerates to the start of the exposure. ``cap_time`` and
    ``exp_time`` broadcast over leading dims."""
    cap_time = torch.as_tensor(cap_time)
    exp_time = torch.as_tensor(exp_time, dtype=cap_time.dtype, device=cap_time.device)
    v = torch.arange(num_vir, dtype=cap_time.dtype, device=cap_time.device)
    c = cap_time[..., None]
    e = exp_time[..., None]
    return c - 0.5 * e + v * e / (num_vir - 1 + 1e-8)
