"""Frontoparallel-plane inverse warping, the tracker's measurement model.

Counterpart of ``mba_vo_tpu/ops/warp.py``. Given a pixel in the current
(blurred) view, a pose T_c2r (current -> reference) and the keypoint's plane
depth D in the reference view: back-project the pixel to a unit ray, meet
the plane z = D, and project into the reference view.
"""

from __future__ import annotations

import torch

from ..core.lie import _cross, quat_rotate


def unit_ray(xy: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Unit-norm back-projection ray of pixel(s) xy under K = [fx, fy, cx, cy]."""
    x_hat = (xy[..., 0] - K[2]) / K[0]
    y_hat = (xy[..., 1] - K[3]) / K[1]
    z_hat = 1.0 / torch.sqrt(1.0 + x_hat * x_hat + y_hat * y_hat)
    return torch.stack([x_hat * z_hat, y_hat * z_hat, z_hat], dim=-1)


def frontoparallel_warp(
    pose_t: torch.Tensor,
    pose_q: torch.Tensor,
    plane_depth: torch.Tensor,
    K: torch.Tensor,
    xy: torch.Tensor,
) -> torch.Tensor:
    """Warp current-view pixel(s) into the reference view via the plane z = D.

    pose_t [..., 3], pose_q [..., 4]: T_c2r; plane_depth [...]; xy [..., 2].
    Returns reference-view pixel positions [..., 2] (with a 1e-8 guard on
    the z division).
    """
    ray = unit_ray(xy, K)
    rotated = quat_rotate(pose_q, ray)
    lam = rotated[..., 2]
    s = (plane_depth - pose_t[..., 2]) / lam
    P = rotated * s[..., None] + pose_t
    iz = 1.0 / (P[..., 2] + 1e-8)
    return torch.stack(
        [K[0] * P[..., 0] * iz + K[2], K[1] * P[..., 1] * iz + K[3]], dim=-1
    )


def frontoparallel_warp_jvp(
    pose_t: torch.Tensor,
    pose_q: torch.Tensor,
    plane_depth: torch.Tensor,
    K: torch.Tensor,
    xy: torch.Tensor,
    dpose_t: torch.Tensor,
    dpose_q: torch.Tensor,
):
    """:func:`frontoparallel_warp` and its forward-mode derivative.

    ``dpose_t`` [D, ..., 3] and ``dpose_q`` [D, ..., 4] are D tangents of
    the pose (leading axis); returns (ref_xy [..., 2], dref_xy [D, ..., 2]).
    The chain rule is written out step by step over the same intermediate
    values as the primal (quaternion rotation, plane intersection,
    projection), so D tangents cost a few batched ops instead of a traced
    forward-mode pass.
    """
    ray = unit_ray(xy, K)
    xyz, w = pose_q[..., :3], pose_q[..., 3:4]
    dxyz, dw = dpose_q[..., :3], dpose_q[..., 3:4]
    # rotated = ray + w * u + xyz x u,  u = 2 xyz x ray
    u = 2.0 * _cross(xyz, ray)
    du = 2.0 * _cross(dxyz, ray)
    rotated = ray + w * u + _cross(xyz, u)
    drot = dw * u + w * du + _cross(dxyz, u) + _cross(xyz, du)
    lam, dlam = rotated[..., 2], drot[..., 2]
    s = (plane_depth - pose_t[..., 2]) / lam
    ds = -(dpose_t[..., 2] + s * dlam) / lam
    P = rotated * s[..., None] + pose_t
    dP = drot * s[..., None] + rotated * ds[..., None] + dpose_t
    iz = 1.0 / (P[..., 2] + 1e-8)
    diz = -dP[..., 2] * iz * iz
    ref_xy = torch.stack(
        [K[0] * P[..., 0] * iz + K[2], K[1] * P[..., 1] * iz + K[3]], dim=-1
    )
    dref_xy = torch.stack(
        [K[0] * (dP[..., 0] * iz + P[..., 0] * diz),
         K[1] * (dP[..., 1] * iz + P[..., 1] * diz)], dim=-1
    )
    return ref_xy, dref_xy
