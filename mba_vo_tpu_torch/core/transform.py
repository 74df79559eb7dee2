"""SE(3) rigid transforms as a (t, q) named tuple of tensors.

Counterpart of ``mba_vo_tpu/core/transform.py``: translation + xyzw unit
quaternion, with compose/inverse/exp/log as batched functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import (
    quat_conjugate,
    quat_identity,
    quat_multiply,
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


def pose_exp(tangent: torch.Tensor) -> Pose:
    """SE(3) exp with [translation, rotation] tangent ordering."""
    t, q = se3_exp(tangent)
    return Pose(t=t, q=q)


def pose_log(p: Pose) -> torch.Tensor:
    """Inverse of :func:`pose_exp`."""
    return se3_log(p.t, p.q)

