"""Continuous-time trajectory with IMU synthesis from the spline.

Counterpart of ``mba_vo_tpu/models/trajectory.py``: pose, world-frame
velocity, body-frame gyro and accelerometer sampled from the SE(3) spline,
with gravity and biases. The first and second time derivatives come from
nested forward-mode AD (``torch.func.jvp``) through the spline sampler,
batched over a vector of times (each sample depends on its own time only,
so one tangent of ones gives every sample's derivative at once).

    velocity = d/dt translation                      (world frame)
    gyro     = vee(R^T dR/dt) + bias_g               (body frame)
    accel    = R^T (d^2/dt^2 t + [0, 0, g]) + bias_a (body frame)
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch.func import jvp

from ..core.lie import quat_to_matrix
from ..core.spline import SplineKnots, spline_pose_at_times
from ..core.transform import Pose


class ImuParams(NamedTuple):
    """Gravity magnitude (world +z) and the IMU's biases."""

    gravity: torch.Tensor       # scalar
    bias_gyro: torch.Tensor     # [3]
    bias_acc: torch.Tensor      # [3]


def default_imu_params(dtype=torch.float32, device=None) -> ImuParams:
    return ImuParams(
        gravity=torch.tensor(9.81, dtype=dtype, device=device),
        bias_gyro=torch.zeros(3, dtype=dtype, device=device),
        bias_acc=torch.zeros(3, dtype=dtype, device=device),
    )


def _times(knots: SplineKnots, time) -> torch.Tensor:
    return torch.as_tensor(time, dtype=knots.t.dtype, device=knots.t.device)


def _pose_tq(knots: SplineKnots, times: torch.Tensor, degree: int) -> torch.Tensor:
    p = spline_pose_at_times(knots, times, degree)
    return torch.cat([p.t, p.q], dim=-1)


def sample_pose_velocity(knots: SplineKnots, time, degree: int
                         ) -> Tuple[Pose, torch.Tensor, torch.Tensor]:
    """Pose, world-frame translational velocity and quaternion rate at a
    scalar ``time``."""
    s = _times(knots, time).reshape(1)
    tq, dtq = jvp(lambda u: _pose_tq(knots, u, degree), (s,), (torch.ones_like(s),))
    return Pose(t=tq[0, :3], q=tq[0, 3:]), dtq[0, :3], dtq[0, 3:]


def sample_imu_sequence(knots: SplineKnots, times, degree: int, params: ImuParams):
    """(pose, velocity_world, gyro_body, accel_body) at each of [N] times:
    Pose of [N, 3] / [N, 4], and [N, 3] each."""
    s = _times(knots, times)

    def pose_and_rate(u):
        return jvp(lambda v: _pose_tq(knots, v, degree), (u,), (torch.ones_like(u),))

    (tq, dtq), (_, ddtq) = jvp(pose_and_rate, (s,), (torch.ones_like(s),))
    q = tq[..., 3:]
    R = quat_to_matrix(q)
    # dR/dt from the quaternion rate: R' = d R(q) / dq . q'
    dR = jvp(quat_to_matrix, (q,), (dtq[..., 3:],))[1]
    Rt = R.transpose(-1, -2)
    omega_mat = Rt @ dR
    gyro = torch.stack([omega_mat[..., 2, 1], omega_mat[..., 0, 2], omega_mat[..., 1, 0]],
                       dim=-1) + params.bias_gyro
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=tq.dtype, device=tq.device)
    acc_world = ddtq[..., :3] + ez * params.gravity
    accel = (Rt @ acc_world[..., None])[..., 0] + params.bias_acc
    return Pose(t=tq[..., :3], q=q), dtq[..., :3], gyro, accel


def sample_imu(knots: SplineKnots, time, degree: int, params: ImuParams):
    """(pose, velocity_world, gyro_body, accel_body) at a scalar ``time``."""
    pose, vel, gyro, acc = sample_imu_sequence(
        knots, _times(knots, time).reshape(1), degree, params)
    return Pose(t=pose.t[0], q=pose.q[0]), vel[0], gyro[0], acc[0]
