"""Camera models as named tuples of tensors with batched methods.

Counterpart of ``mba_vo_tpu/models/camera.py``: a pinhole and a unified
(omnidirectional) camera, each optionally behind radial-tangential
distortion, with project/unproject over leading dims; a pyramid level is
the same camera with its intrinsics and size halved. Projections behind
the camera are reported by a validity mask, not by branches.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch


def scale_intrinsics(K: torch.Tensor, pyramid_level: int) -> torch.Tensor:
    """[fx, fy, cx, cy] of a pyramid level: all four divided by 2^level."""
    return K / (2.0 ** pyramid_level)


def _pixels(K: torch.Tensor, pn: torch.Tensor) -> torch.Tensor:
    return torch.stack([K[0] * pn[..., 0] + K[2], K[1] * pn[..., 1] + K[3]], dim=-1)


def _normalised(K: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    return torch.stack([(xy[..., 0] - K[2]) / K[0], (xy[..., 1] - K[3]) / K[1]], dim=-1)


class RadTanDistortion(NamedTuple):
    """Radial-tangential distortion [k1, k2, p1, p2] (scalars or 0-d tensors)."""

    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor

    def distort(self, p: torch.Tensor) -> torch.Tensor:
        x, y = p[..., 0], p[..., 1]
        x2, y2, xy = x * x, y * y, x * y
        r2 = x2 + y2
        rad = self.k1 * r2 + self.k2 * r2 * r2
        dx = x + x * rad + 2.0 * self.p1 * xy + self.p2 * (r2 + 2.0 * x2)
        dy = y + y * rad + 2.0 * self.p2 * xy + self.p1 * (r2 + 2.0 * y2)
        return torch.stack([dx, dy], dim=-1)

    def _jacobian_entries(self, p: torch.Tensor):
        x, y = p[..., 0], p[..., 1]
        x2, y2, xy = x * x, y * y, x * y
        r2 = x2 + y2
        rad = self.k1 * r2 + self.k2 * r2 * r2
        j00 = 1.0 + rad + 2.0 * self.k1 * x2 + 4.0 * self.k2 * x2 * r2 \
            + 2.0 * self.p1 * y + 6.0 * self.p2 * x
        j01 = 2.0 * self.k1 * xy + 4.0 * self.k2 * r2 * xy \
            + 2.0 * self.p1 * x + 2.0 * self.p2 * y
        j11 = 1.0 + rad + 2.0 * self.k1 * y2 + 4.0 * self.k2 * y2 * r2 \
            + 2.0 * self.p2 * x + 6.0 * self.p1 * y
        return j00, j01, j11

    def distort_jacobian(self, p: torch.Tensor) -> torch.Tensor:
        """[..., 2, 2] Jacobian of :meth:`distort` (symmetric)."""
        j00, j01, j11 = self._jacobian_entries(p)
        row0 = torch.stack([j00, j01], dim=-1)
        row1 = torch.stack([j01, j11], dim=-1)
        return torch.stack([row0, row1], dim=-2)

    def undistort(self, p: torch.Tensor, num_iters: int = 5) -> torch.Tensor:
        """Gauss-Newton inverse of :meth:`distort`: a fixed ``num_iters``
        iterations, no early exit; the 2x2 normal equations are solved in
        closed form with the determinant set to 1e-12 where |det| < 1e-12."""
        u = p
        for _ in range(num_iters):
            e = p - self.distort(u)
            j00, j01, j11 = self._jacobian_entries(u)
            # J^T J and J^T e written out (J is symmetric: J[1,0] = J[0,1])
            a00 = j00 * j00 + j01 * j01
            a01 = j00 * j01 + j01 * j11
            a11 = j01 * j01 + j11 * j11
            b0 = j00 * e[..., 0] + j01 * e[..., 1]
            b1 = j01 * e[..., 0] + j11 * e[..., 1]
            det = a00 * a11 - a01 * a01
            det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
            du0 = (a11 * b0 - a01 * b1) / det
            du1 = (-a01 * b0 + a00 * b1) / det
            u = u + torch.stack([du0, du1], dim=-1)
        return u


class PinholeCamera(NamedTuple):
    """Pinhole camera: K = [fx, fy, cx, cy] at level 0, image size (height,
    width), optional rad-tan distortion of the normalised coordinates."""

    K: torch.Tensor
    height: int
    width: int
    distortion: Optional[RadTanDistortion] = None

    def level(self, lv: int) -> "PinholeCamera":
        """The camera of pyramid level ``lv`` (intrinsics and size halved lv
        times)."""
        return self._replace(K=scale_intrinsics(self.K, lv),
                             height=self.height // (2 ** lv), width=self.width // (2 ** lv))

    def project(self, P3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., 3] points -> ([..., 2] pixels, [...] valid = z > 0)."""
        z = P3d[..., 2]
        valid = z > 0
        iz = 1.0 / torch.where(valid, z, torch.ones_like(z))
        pn = P3d[..., :2] * iz[..., None]
        if self.distortion is not None:
            pn = self.distortion.distort(pn)
        return _pixels(self.K, pn), valid

    def unproject(self, xy: torch.Tensor, z) -> torch.Tensor:
        """Pixels and depth -> 3D points z * [(x - cx)/fx, (y - cy)/fy, 1]
        (normalised coordinates undistorted first)."""
        pn = _normalised(self.K, xy)
        if self.distortion is not None:
            pn = self.distortion.undistort(pn)
        ones = torch.ones_like(pn[..., :1])
        z = torch.as_tensor(z, dtype=pn.dtype, device=pn.device)
        return z[..., None] * torch.cat([pn, ones], dim=-1)

    def unit_ray(self, xy: torch.Tensor) -> torch.Tensor:
        """Unit-norm back-projected ray of each pixel."""
        ray = self.unproject(xy, torch.ones(xy.shape[:-1], dtype=xy.dtype, device=xy.device))
        return ray / torch.linalg.norm(ray, dim=-1, keepdim=True)

    def projection_jacobian(self, P3d: torch.Tensor) -> torch.Tensor:
        """[..., 2, 3] derivative of the (undistorted) pixel by the point."""
        fx, fy = self.K[0], self.K[1]
        x, y, z = P3d[..., 0], P3d[..., 1], P3d[..., 2]
        iz = 1.0 / z
        iz2 = iz * iz
        zero = torch.zeros_like(x)
        row0 = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
        row1 = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
        return torch.stack([row0, row1], dim=-2)


class UnifiedCamera(NamedTuple):
    """Unified (omnidirectional) camera with mirror parameter ``xi``."""

    K: torch.Tensor
    xi: torch.Tensor
    height: int
    width: int
    distortion: Optional[RadTanDistortion] = None

    def level(self, lv: int) -> "UnifiedCamera":
        return self._replace(K=scale_intrinsics(self.K, lv),
                             height=self.height // (2 ** lv), width=self.width // (2 ** lv))

    def project(self, P3d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """[..., 3] points -> ([..., 2] pixels, [...] valid = z >= 0); the
        denominator z + xi |P| is set to 1e-12 where its magnitude is below
        1e-12."""
        z = P3d[..., 2]
        valid = z >= 0
        d = torch.linalg.norm(P3d, dim=-1)
        denom = z + self.xi * d
        rz = 1.0 / torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
        pn = P3d[..., :2] * rz[..., None]
        if self.distortion is not None:
            pn = self.distortion.distort(pn)
        return _pixels(self.K, pn), valid

    def unproject(self, xy: torch.Tensor, z) -> torch.Tensor:
        """Lift each pixel to the unit sphere (beta clamped at 0), then scale
        the ray to z-depth ``z`` (its z set to 1e-12 where below 1e-12 in
        magnitude)."""
        pn = _normalised(self.K, xy)
        if self.distortion is not None:
            pn = self.distortion.undistort(pn)
        rho2 = torch.sum(pn * pn, dim=-1)
        beta = 1.0 + (1.0 - self.xi ** 2) * rho2
        beta = torch.clamp(beta, min=0.0)
        lam = (self.xi + torch.sqrt(beta)) / (1.0 + rho2)
        P = torch.cat([lam[..., None] * pn, (lam - self.xi)[..., None]], dim=-1)
        pz = P[..., 2:3]
        pz = torch.where(torch.abs(pz) < 1e-12, torch.full_like(pz, 1e-12), pz)
        z = torch.as_tensor(z, dtype=pn.dtype, device=pn.device)
        return P / pz * z[..., None]
