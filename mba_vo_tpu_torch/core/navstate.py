"""Navigation state: pose, velocity and IMU biases as a named tuple.

Counterpart of ``mba_vo_tpu/core/navstate.py``: the state is immutable (a
solver steps through :func:`navstate_retract`, the right-multiplicative
boxplus of the spline knots), and :func:`propagate_imu` is one strapdown
Euler step, the inverse of ``models.trajectory.sample_imu``'s synthesis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import quat_exp, quat_multiply, quat_rotate
from .transform import Pose


class NavState(NamedTuple):
    """pose: body->world; velocity [3] world frame; bias_acc, bias_gyro [3]."""

    pose: Pose
    velocity: torch.Tensor
    bias_acc: torch.Tensor
    bias_gyro: torch.Tensor


def identity_navstate(dtype=torch.float32, device=None) -> NavState:
    zeros = lambda: torch.zeros(3, dtype=dtype, device=device)  # noqa: E731
    return NavState(
        pose=Pose(t=zeros(), q=torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)),
        velocity=zeros(), bias_acc=zeros(), bias_gyro=zeros(),
    )


def navstate_retract(state: NavState, delta: torch.Tensor) -> NavState:
    """Manifold update with a [15] tangent [dt, dw, dv, dba, dbg]."""
    return NavState(
        pose=Pose(t=state.pose.t + delta[0:3],
                  q=quat_multiply(state.pose.q, quat_exp(delta[3:6]))),
        velocity=state.velocity + delta[6:9],
        bias_acc=state.bias_acc + delta[9:12],
        bias_gyro=state.bias_gyro + delta[12:15],
    )


def propagate_imu(state: NavState, acc: torch.Tensor, gyro: torch.Tensor, dt,
                  gravity_w: torch.Tensor) -> NavState:
    """One strapdown Euler step from body-frame specific force ``acc`` and
    angular rate ``gyro`` [3], with world gravity ``gravity_w`` [3]:

        w   = gyro - b_g
        a_w = R (acc - b_a) + g_w
        q  <- q * exp(w dt);  v <- v + a_w dt;  t <- t + v dt + a_w dt^2 / 2
    """
    dt = torch.as_tensor(dt, dtype=state.velocity.dtype, device=state.velocity.device)
    w = gyro - state.bias_gyro
    a_w = quat_rotate(state.pose.q, acc - state.bias_acc) + gravity_w
    new_q = quat_multiply(state.pose.q, quat_exp(w * dt))
    new_t = state.pose.t + state.velocity * dt + 0.5 * a_w * dt * dt
    new_v = state.velocity + a_w * dt
    return NavState(pose=Pose(t=new_t, q=new_q), velocity=new_v,
                    bias_acc=state.bias_acc, bias_gyro=state.bias_gyro)
