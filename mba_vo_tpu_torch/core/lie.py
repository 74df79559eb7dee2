"""Quaternion and Lie-group primitives on tensors (batched over leading dims).

Counterpart of ``mba_vo_tpu/core/lie.py``, with the same conventions:
  * quaternions are stored ``[x, y, z, w]``;
  * ``quat_log`` maps a unit quaternion to the rotation vector and
    ``quat_exp`` is its inverse, each with a small-angle Taylor branch whose
    threshold depends on the dtype;
  * SE(3) exp/log use the tangent order ``[translation, rotation]``.

Small-angle branches are ``torch.where`` over safe operands, so forward-mode
AD stays finite through them. The ``*_jvp`` helpers write that forward mode
out: each returns the primal value, computed by the same ops as the plain
function, and its derivative along D tangent seeds stacked on a leading
axis, taking the same branch per element as the primal (the Jacobian of
``jnp.where`` is that of its live branch).
"""

from __future__ import annotations

import torch


def _small_threshold(dtype: torch.dtype) -> float:
    """Squared-norm threshold below which the Taylor branches are used:
    1e-20 in float64, 1e-10 in narrower types."""
    if torch.finfo(dtype).bits >= 64:
        return 1e-20
    return 1e-10


def _sum3(x: torch.Tensor) -> torch.Tensor:
    """x[..., 0] + x[..., 1] + x[..., 2], summed left to right. On the card
    torch.sum over a last axis of 3 takes an order that depends on the
    tensor's shape; the kernels that repeat the quaternion exp and log
    (csrc/spline_pose.cuh) sum in this order, whatever the shape."""
    return (x[..., 0] + x[..., 1]) + x[..., 2]


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def quat_multiply(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*p, xyzw layout:

        x = qw px + qx pw + qy pz - qz py
        y = qw py + qy pw + qz px - qx pz
        z = qw pz + qz pw + qx py - qy px
        w = qw pw - qx px - qy py - qz pz

    summed left to right. The four components are computed together, the
    second to fourth terms as one product of gathered (and, for a
    subtracted term, negated) operands: a - b rounds as a + (-b), so each
    component rounds as the formula written out does, in 9 batched ops
    instead of 29 (the launches of the tracker's pose Jacobian)."""
    q, p = torch.broadcast_tensors(q, p)
    sq = torch.cat([q, -q], dim=-1)                 # x y z w -x -y -z -w
    a = torch.stack([sq[..., i] for i in _PRODUCT_Q], dim=-1)
    b = torch.stack([p[..., i] for i in _PRODUCT_P], dim=-1)
    terms = (a * b).unflatten(-1, (3, 4))
    return q[..., 3:] * p + terms[..., 0, :] + terms[..., 1, :] + terms[..., 2, :]


def quat_multiply_jvp(q, p, dq, dp):
    """(q*p, its tangent dq*p + q*dp). ``dq`` and ``dp`` carry a leading
    axis of D seeds; ``dq`` may be None for a constant left operand."""
    out = quat_multiply(q, p)
    if dq is None:
        return out, quat_multiply(q, dp)
    return out, quat_multiply(dq, p) + quat_multiply(q, dp)


# the second to fourth terms of quat_multiply's components (x, y, z, w):
# indices into [x, y, z, w, -x, -y, -z, -w] of q and into p
_PRODUCT_Q = (0, 1, 2, 4, 1, 2, 0, 5, 6, 4, 5, 6)
_PRODUCT_P = (3, 3, 3, 0, 2, 0, 1, 1, 1, 2, 0, 2)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    # negation is exact: the same values as q * (-1, -1, -1, 1), without
    # copying a sign vector from the host (a stream sync on a GPU) each call
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (two-cross-product form)."""
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix (batched over leading dims)."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Rotation-vector log of a unit quaternion: ``lambda * [x, y, z]`` with
    lambda = 2 atan2(n, w) / n, or its Taylor form 2/w - (2/3) n^2/w^3 near
    n = |imag| = 0."""
    xyz = q[..., :3]
    w = q[..., 3]
    sq = _sum3(xyz * xyz)
    small = sq < _small_threshold(q.dtype)
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    n = torch.sqrt(sq_safe)
    lam_big = 2.0 * torch.atan2(n, w) / n
    w_safe = torch.where(torch.abs(w) < 1e-6, torch.sign(w) + (w == 0).to(w.dtype), w)
    lam_small = 2.0 / w_safe - (2.0 / 3.0) * sq / (w_safe ** 3)
    lam = torch.where(small, lam_small, lam_big)
    return lam[..., None] * xyz


def quat_log_jvp(q: torch.Tensor, dq: torch.Tensor):
    """(:func:`quat_log` of q, its tangent along the D seeds ``dq``
    [D, ..., 4]), in the primal's branch per element."""
    xyz, w = q[..., :3], q[..., 3]
    dxyz, dw = dq[..., :3], dq[..., 3]
    sq = _sum3(xyz * xyz)
    dsq = 2.0 * _sum3(xyz * dxyz)
    small = sq < _small_threshold(q.dtype)
    sq_safe = torch.where(small, torch.ones_like(sq), sq)
    dsq_safe = torch.where(small, torch.zeros_like(dsq), dsq)
    n = torch.sqrt(sq_safe)
    dn = dsq_safe / (2.0 * n)
    at = torch.atan2(n, w)
    lam_big = 2.0 * at / n
    dat = (w * dn - n * dw) / (n * n + w * w)
    dlam_big = 2.0 * (dat * n - at * dn) / (n * n)
    near0 = torch.abs(w) < 1e-6
    w_safe = torch.where(near0, torch.sign(w) + (w == 0).to(w.dtype), w)
    dw_safe = torch.where(near0, torch.zeros_like(dw), dw)
    w3 = w_safe ** 3
    lam_small = 2.0 / w_safe - (2.0 / 3.0) * sq / w3
    dlam_small = (-2.0 * dw_safe / (w_safe * w_safe)
                  - (2.0 / 3.0) * (dsq * w3 - sq * 3.0 * w_safe * w_safe * dw_safe)
                  / (w3 * w3))
    lam = torch.where(small, lam_small, lam_big)
    dlam = torch.where(small, dlam_small, dlam_big)
    return lam[..., None] * xyz, dlam[..., None] * xyz + lam[..., None] * dxyz


def quat_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> unit quaternion (inverse of :func:`quat_log`)."""
    theta_sq = _sum3(omega * omega)
    small = theta_sq < _small_threshold(omega.dtype)
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    imag_big = torch.sin(0.5 * theta) / theta
    real_big = torch.cos(0.5 * theta)
    theta_po4 = theta_sq * theta_sq
    imag_small = 0.5 - theta_sq / 48.0 + theta_po4 / 3840.0
    real_small = 1.0 - theta_sq / 8.0 + theta_po4 / 384.0
    imag = torch.where(small, imag_small, imag_big)
    real = torch.where(small, real_small, real_big)
    return torch.cat([imag[..., None] * omega, real[..., None]], dim=-1)


def quat_exp_jvp(omega: torch.Tensor, domega: torch.Tensor):
    """(:func:`quat_exp` of omega, its tangent along the D seeds ``domega``
    [D, ..., 3]), in the primal's branch per element."""
    theta_sq = _sum3(omega * omega)
    dtheta_sq = 2.0 * _sum3(omega * domega)
    small = theta_sq < _small_threshold(omega.dtype)
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    dtheta_sq_safe = torch.where(small, torch.zeros_like(dtheta_sq), dtheta_sq)
    theta = torch.sqrt(theta_sq_safe)
    dtheta = dtheta_sq_safe / (2.0 * theta)
    s, c = torch.sin(0.5 * theta), torch.cos(0.5 * theta)
    imag_big = s / theta
    dimag_big = (0.5 * c * theta - s) / (theta * theta) * dtheta
    dreal_big = -0.5 * s * dtheta
    theta_po4 = theta_sq * theta_sq
    imag_small = 0.5 - theta_sq / 48.0 + theta_po4 / 3840.0
    real_small = 1.0 - theta_sq / 8.0 + theta_po4 / 384.0
    dimag_small = -dtheta_sq / 48.0 + 2.0 * theta_sq * dtheta_sq / 3840.0
    dreal_small = -dtheta_sq / 8.0 + 2.0 * theta_sq * dtheta_sq / 384.0
    imag = torch.where(small, imag_small, imag_big)
    real = torch.where(small, real_small, c)
    dimag = torch.where(small, dimag_small, dimag_big)
    dreal = torch.where(small, dreal_small, dreal_big)
    q = torch.cat([imag[..., None] * omega, real[..., None]], dim=-1)
    dq = torch.cat([dimag[..., None] * omega + imag[..., None] * domega, dreal[..., None]],
                   dim=-1)
    return q, dq


def so3_hat(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector."""
    ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(ox)
    m = torch.stack([zero, -oz, oy, oz, zero, -ox, -oy, ox, zero], dim=-1)
    return m.reshape(omega.shape[:-1] + (3, 3))


def _eye_like(OO: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=OO.dtype, device=OO.device).expand(OO.shape)


def _se3_V(omega: torch.Tensor) -> torch.Tensor:
    """Left Jacobian V of SO(3) such that t = V @ rho in SE(3) exp."""
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < _small_threshold(omega.dtype)
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    O = so3_hat(omega)
    OO = O @ O
    a_big = (1.0 - torch.cos(theta)) / theta_sq_safe
    b_big = (theta - torch.sin(theta)) / (theta_sq_safe * theta)
    a_small = 0.5 - theta_sq / 24.0
    b_small = 1.0 / 6.0 - theta_sq / 120.0
    a = torch.where(small, a_small, a_big)
    b = torch.where(small, b_small, b_big)
    return _eye_like(OO) + a[..., None, None] * O + b[..., None, None] * OO


def _se3_V_inv(omega: torch.Tensor) -> torch.Tensor:
    theta_sq = torch.sum(omega * omega, dim=-1)
    small = theta_sq < _small_threshold(omega.dtype)
    theta_sq_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    theta = torch.sqrt(theta_sq_safe)
    O = so3_hat(omega)
    OO = O @ O
    half_theta = 0.5 * theta
    c_big = (1.0 - half_theta * torch.cos(half_theta) / torch.sin(half_theta)) / theta_sq_safe
    c_small = 1.0 / 12.0 + theta_sq / 720.0
    c = torch.where(small, c_small, c_big)
    return _eye_like(OO) - 0.5 * O + c[..., None, None] * OO


def se3_exp(tangent: torch.Tensor):
    """SE(3) exponential of ``[rho(3), omega(3)]``; returns (t, q_xyzw)."""
    rho = tangent[..., :3]
    omega = tangent[..., 3:]
    q = quat_exp(omega)
    t = torch.einsum("...ij,...j->...i", _se3_V(omega), rho)
    return t, q


def se3_log(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """SE(3) log, inverse of :func:`se3_exp`."""
    omega = quat_log(q)
    rho = torch.einsum("...ij,...j->...i", _se3_V_inv(omega), t)
    return torch.cat([rho, omega], dim=-1)



def quat_boxplus(q: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction q [+] omega = q * exp(omega)."""
    return quat_multiply(q, quat_exp(omega))
