"""Non-planar synthetic scenes: exact ray-cast rendering and depth maps.

Counterpart of ``mba_vo_tpu/data/scene3d.py``: a slanted textured plane and
a field of textured spheres, rendered by exact per-pixel ray casting, so a
blurred sequence is an exact forward model from any pose and each view's
z-depth map is exact. Rays meet every primitive at once and the nearest
hit wins (masked selects, in sphere order, a sphere replacing the current
hit only when strictly nearer). :func:`render_scene` takes one pose or a
batch of poses; :func:`synthesize_blurred_image_scene` renders all of an
exposure's samples in one batched call and averages them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.lie import quat_rotate
from ..core.spline import SplineKnots, spline_pose_at_times, virtual_pose_times
from ..ops.image import bilinear_sample

NO_HIT = 1e9    # ray parameter of a miss; the depth there is 0


class Scene3D(NamedTuple):
    """Slanted textured plane + spheres in the world (= keyframe camera at
    identity) frame.

    plane_point [3], plane_normal [3] (unit, toward the camera), plane_axes
    [2, 3] (orthonormal in-plane texture axes u, v), texture [Ht, Wt]
    albedo, texture_scale (texture pixels per metre), sphere_c [M, 3],
    sphere_r [M], sphere_phase [M] (phase offsets of the procedural albedo).
    """

    plane_point: torch.Tensor
    plane_normal: torch.Tensor
    plane_axes: torch.Tensor
    texture: torch.Tensor
    texture_scale: torch.Tensor
    sphere_c: torch.Tensor
    sphere_r: torch.Tensor
    sphere_phase: torch.Tensor


def default_scene(texture: np.ndarray, depth: float = 2.0, tilt_deg: float = 18.0,
                  num_spheres: int = 5, seed: int = 7, dtype=torch.float32,
                  device=None) -> Scene3D:
    """A plane at mean distance ``depth`` tilted ``tilt_deg`` about the y
    axis (left edge nearer), carrying ``texture``, and ``num_spheres``
    spheres drawn from ``seed`` between the camera and the plane."""
    t = np.deg2rad(tilt_deg)
    normal = np.array([np.sin(t), 0.0, -np.cos(t)])
    u = np.array([np.cos(t), 0.0, np.sin(t)])
    v = np.array([0.0, 1.0, 0.0])
    rng = np.random.default_rng(seed)
    c = np.stack([
        rng.uniform(-0.45, 0.45, num_spheres) * depth,
        rng.uniform(-0.33, 0.33, num_spheres) * depth,
        rng.uniform(0.55, 0.9, num_spheres) * depth,
    ], axis=-1)
    r = rng.uniform(0.06, 0.13, num_spheres) * depth
    ph = rng.uniform(0, 2 * np.pi, num_spheres)
    texture = np.asarray(texture)
    f = lambda x: torch.tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    return Scene3D(
        plane_point=f([0.0, 0.0, depth]), plane_normal=f(normal),
        plane_axes=f(np.stack([u, v])), texture=f(texture),
        texture_scale=f(texture.shape[1] / (2.2 * depth)),
        sphere_c=f(c.reshape(num_spheres, 3)), sphere_r=f(r), sphere_phase=f(ph),
    )


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of length 3, in a fixed order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _sphere_albedo(scene: Scene3D, X: torch.Tensor, m: int) -> torch.Tensor:
    """Smooth procedural albedo of sphere m at world points X [..., 3]."""
    ph = scene.sphere_phase[m]
    k = 26.0 / torch.clamp(scene.sphere_r[m], min=1e-6)
    s = (torch.sin(k * X[..., 0] + ph)
         + torch.sin(k * 0.8 * X[..., 1] + 2.1 * ph)
         + torch.sin(k * 1.3 * X[..., 2] + 0.5 * ph))
    return 128.0 + 40.0 * s


def render_scene(scene: Scene3D, pose_t: torch.Tensor, pose_q: torch.Tensor,
                 K: torch.Tensor, H: int, W: int):
    """(image, z-depth) seen from camera pose(s) T_c2w: [H, W] each for a
    pose_t [3] / pose_q [4], [B, H, W] each for a batch [B, 3] / [B, 4].

    The ray of pixel (x, y) is d_cam = ((x - cx)/fx, (y - cy)/fy, 1), so its
    parameter at a hit is the camera-frame z-depth."""
    tex = scene.texture
    dtype, dev = tex.dtype, tex.device
    batched = pose_t.dim() == 2
    o = (pose_t if batched else pose_t[None])[:, None, None, :]          # [B, 1, 1, 3]
    q = (pose_q if batched else pose_q[None])[:, None, None, :]
    ys, xs = torch.meshgrid(torch.arange(H, device=dev), torch.arange(W, device=dev),
                            indexing="ij")
    d_cam = torch.stack([(xs.to(dtype) - K[2]) / K[0], (ys.to(dtype) - K[3]) / K[1],
                         torch.ones((H, W), dtype=dtype, device=dev)], dim=-1)
    d = quat_rotate(q, d_cam)                                           # [B, H, W, 3]
    big = torch.tensor(NO_HIT, dtype=dtype, device=dev)

    # plane hit
    n = scene.plane_normal
    denom = _dot3(d, n)
    small = torch.abs(denom) < 1e-9
    t_pl = _dot3(scene.plane_point - o, n) / torch.where(small, torch.full_like(denom, 1e-9),
                                                          denom)
    t_pl = torch.where((t_pl > 1e-4) & ~small, t_pl, big)
    X_pl = o + t_pl[..., None] * d
    rel = X_pl - scene.plane_point
    uv = torch.stack([_dot3(rel, scene.plane_axes[0]), _dot3(rel, scene.plane_axes[1])],
                     dim=-1) * scene.texture_scale
    Ht, Wt = tex.shape
    tex_x = uv[..., 0] + (Wt - 1) / 2.0
    tex_y = uv[..., 1] + (Ht - 1) / 2.0
    # tile the texture by reflection; the remainder's sign follows the
    # divisor (torch.remainder, as jnp.mod)
    period_x, period_y = 2.0 * (Wt - 1), 2.0 * (Ht - 1)
    mx = torch.remainder(tex_x, period_x)
    my = torch.remainder(tex_y, period_y)
    mx = torch.where(mx > Wt - 1, period_x - mx, mx)
    my = torch.where(my > Ht - 1, period_y - my, my)
    col_best = bilinear_sample(tex, torch.stack([mx, my], dim=-1))
    t_best = t_pl

    # nearest sphere hit, in sphere order
    dd = _dot3(d, d)
    for m in range(scene.sphere_c.shape[0]):
        oc = o - scene.sphere_c[m]
        b = _dot3(d, oc)
        cterm = _dot3(oc, oc) - scene.sphere_r[m] ** 2
        disc = b * b - dd * cterm
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        t_m = (-b - sq) / dd
        t_m = torch.where((disc > 0) & (t_m > 1e-4), t_m, big)
        col_m = _sphere_albedo(scene, o + t_m[..., None] * d, m)
        closer = t_m < t_best
        col_best = torch.where(closer, col_m, col_best)
        t_best = torch.where(closer, t_m, t_best)

    z = torch.where(t_best >= big, torch.zeros_like(t_best), t_best)
    if not batched:
        return col_best[0], z[0]
    return col_best, z


def apply_photometric_disturbance(img: torch.Tensor, gain: float = 1.0, bias: float = 0.0,
                                  vignette: float = 0.0) -> torch.Tensor:
    """``(gain * img + bias) * (1 - vignette * (r / r_corner)^2)``: per-frame
    gain and bias and radial vignetting."""
    Himg, Wimg = img.shape
    dtype = img.dtype
    ys, xs = torch.meshgrid(torch.arange(Himg, device=img.device),
                            torch.arange(Wimg, device=img.device), indexing="ij")
    cy, cx = (Himg - 1) / 2.0, (Wimg - 1) / 2.0
    r2 = (((xs.to(dtype) - cx) / cx) ** 2 + ((ys.to(dtype) - cy) / cy) ** 2) / 2.0
    return (gain * img + bias) * (1.0 - vignette * r2)


def degrade_depth(z: np.ndarray, quantize: float = 5000.0, noise_sigma: float = 0.0,
                  seed: int = 0) -> np.ndarray:
    """Keyframe depth as a sensor gives it: round(z * quantize) / quantize
    (the 16-bit PNG contract at 5000) plus optional Gaussian noise from
    ``seed``."""
    z = np.asarray(z)
    zq = np.round(z * quantize) / quantize
    if noise_sigma > 0:
        zq = zq + np.random.default_rng(seed).normal(0, noise_sigma, z.shape)
    return zq.astype(z.dtype)


def with_occluder(scene: Scene3D, center, radius: float) -> Scene3D:
    """The scene with one more (foreground) sphere appended."""
    f = lambda x: torch.tensor(x, dtype=scene.sphere_r.dtype,  # noqa: E731
                               device=scene.sphere_r.device)
    return scene._replace(
        sphere_c=torch.cat([scene.sphere_c, f([list(center)])], dim=0),
        sphere_r=torch.cat([scene.sphere_r, f([radius])]),
        sphere_phase=torch.cat([scene.sphere_phase, f([1.7])]),
    )


def scene_depth_map(scene: Scene3D, pose_t, pose_q, K, H: int, W: int) -> torch.Tensor:
    """Exact z-depth map from a pose."""
    return render_scene(scene, pose_t, pose_q, K, H, W)[1]


def synthesize_blurred_image_scene(scene: Scene3D, knots: SplineKnots, degree: int,
                                   capture_time: float, exposure_time: float,
                                   num_samples: int, K: torch.Tensor, H: int,
                                   W: int) -> torch.Tensor:
    """Mean of the exact renders at the spline's poses across the exposure,
    all samples rendered in one batched call."""
    dtype, dev = scene.texture.dtype, scene.texture.device
    times = virtual_pose_times(torch.as_tensor(capture_time, dtype=dtype, device=dev),
                               exposure_time, num_samples)
    p = spline_pose_at_times(knots, times, degree)
    img, _ = render_scene(scene, p.t, p.q, K, H, W)
    return img.mean(dim=0)
