"""SE(3) rigid transforms as a (t, q) named tuple of tensors.

Counterpart of ``mba_vo_tpu/core/transform.py``: translation + xyzw unit
quaternion, with compose/inverse/apply/exp/log and roll-pitch-yaw as
batched functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import (
    quat_conjugate,
    quat_identity,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    se3_exp,
    se3_log,
)


class Pose(NamedTuple):
    """Batched SE(3) pose: t[..., 3] translation, q[..., 4] xyzw quaternion."""

    t: torch.Tensor
    q: torch.Tensor


def pose_identity(dtype=torch.float32, batch_shape=(), device=None) -> Pose:
    t = torch.zeros(tuple(batch_shape) + (3,), dtype=dtype, device=device)
    q = quat_identity(dtype, device).expand(tuple(batch_shape) + (4,)).clone()
    return Pose(t, q)


def pose_compose(a: Pose, b: Pose) -> Pose:
    """a * b (first apply b, then a)."""
    return Pose(t=quat_rotate(a.q, b.t) + a.t, q=quat_multiply(a.q, b.q))


def pose_inverse(p: Pose) -> Pose:
    q_inv = quat_conjugate(p.q)
    return Pose(t=quat_rotate(q_inv, -p.t), q=q_inv)


def pose_apply(p: Pose, x: torch.Tensor) -> torch.Tensor:
    """Apply the pose to 3D point(s): R x + t."""
    return quat_rotate(p.q, x) + p.t


def pose_exp(tangent: torch.Tensor) -> Pose:
    """SE(3) exp with [translation, rotation] tangent ordering."""
    t, q = se3_exp(tangent)
    return Pose(t=t, q=q)


def pose_log(p: Pose) -> torch.Tensor:
    """Inverse of :func:`pose_exp`."""
    return se3_log(p.t, p.q)



def pose_normalize(p: Pose) -> Pose:
    return Pose(t=p.t, q=quat_normalize(p.q))


def pose_rpy(p: Pose) -> torch.Tensor:
    """[..., 3] roll, pitch, yaw of the pose's rotation."""
    x, y, z, w = p.q[..., 0], p.q[..., 1], p.q[..., 2], p.q[..., 3]
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2.0 * (w * y - x * z), -1.0, 1.0))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def pose_from_rpy(roll, pitch, yaw, t=None, dtype=torch.float32, device=None) -> Pose:
    """Pose with the rotation of (roll, pitch, yaw) and translation ``t``
    (zero when None); the angles broadcast over leading dims. Angles given
    as Python or numpy numbers are evaluated in float64, then cast."""
    roll, pitch, yaw = (a if isinstance(a, torch.Tensor)
                        else torch.as_tensor(a, dtype=torch.float64, device=device)
                        for a in (roll, pitch, yaw))
    cr, sr = torch.cos(0.5 * roll), torch.sin(0.5 * roll)
    cp, sp = torch.cos(0.5 * pitch), torch.sin(0.5 * pitch)
    cy, sy = torch.cos(0.5 * yaw), torch.sin(0.5 * yaw)
    q = torch.stack(
        [
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
            cr * cp * cy + sr * sp * sy,
        ],
        dim=-1,
    ).to(dtype)
    q = quat_normalize(q)
    if t is None:
        t = torch.zeros(q.shape[:-1] + (3,), dtype=dtype, device=q.device)
    return Pose(t=torch.as_tensor(t, dtype=dtype, device=q.device), q=q)
