"""Synthetic test scenes and the motion-blur forward model.

Counterpart of ``mba_vo_tpu/data/synthetic.py``: a planar scene warped
through the same frontoparallel-plane model the tracker inverts and
averaged over spline-sampled virtual poses, so recovering the generating
spline from the blurred frames is an exact end-to-end oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.spline import SplineKnots, spline_pose_at, virtual_pose_times
from ..ops.image import bilinear_sample
from ..ops.warp import frontoparallel_warp


def _fill_rect(img: np.ndarray, x0: int, y0: int, w: int, h: int, value: float):
    img[y0 : y0 + h, x0 : x0 + w] = value


def _fill_triangle(img: np.ndarray, pts, value: float):
    """Rasterize a triangle via barycentric half-plane tests."""
    H, W = img.shape
    ys, xs = np.mgrid[0:H, 0:W]
    (x0, y0), (x1, y1), (x2, y2) = pts

    def edge(ax, ay, bx, by, px, py):
        return (px - ax) * (by - ay) - (py - ay) * (bx - ax)

    area = edge(x0, y0, x1, y1, x2, y2)
    if area == 0:
        return
    s = np.sign(area)
    e0 = edge(x0, y0, x1, y1, xs, ys) * s
    e1 = edge(x1, y1, x2, y2, xs, ys) * s
    e2 = edge(x2, y2, x0, y0, xs, ys) * s
    img[(e0 >= 0) & (e1 >= 0) & (e2 >= 0)] = value


def shapes_image(H: int = 480, W: int = 640, dtype=np.float32) -> np.ndarray:
    """White rectangles + triangles on black, placed for 640x480 and scaled
    proportionally for other canvas sizes."""
    img = np.zeros((H, W), dtype=dtype)
    sx, sy = W / 640.0, H / 480.0

    def rect(x, y, w, h):
        _fill_rect(img, int(x * sx), int(y * sy),
                   max(1, int(w * sx)), max(1, int(h * sy)), 255.0)

    def tri(pts):
        _fill_triangle(img, [(x * sx, y * sy) for x, y in pts], 255.0)

    rect(300, 50, 50, 100)
    rect(250, 200, 100, 50)
    rect(400, 300, 100, 100)
    rect(500, 50, 100, 100)
    rect(250, 300, 100, 100)
    tri([(500, 50), (400, 150), (550, 250)])
    tri([(150, 300), (50, 450), (250, 400)])
    return img


def _box_filter_1d(img: np.ndarray, k: int, axis: int) -> np.ndarray:
    """Edge-padded (2k+1)-wide box filter along one axis (cumsum trick)."""
    pad = [(0, 0), (0, 0)]
    pad[axis] = (k, k)
    p = np.pad(img, pad, mode="edge")
    c = np.cumsum(p, axis=axis)
    zero = np.zeros_like(np.take(c, [0], axis=axis))
    c = np.concatenate([zero, c], axis=axis)
    n = c.shape[axis]
    upper = np.take(c, range(2 * k + 1, n), axis=axis)
    lower = np.take(c, range(0, n - 2 * k - 1), axis=axis)
    return (upper - lower) / (2 * k + 1)


def smooth_shapes_image(H: int = 480, W: int = 640, sigma: float = 2.0,
                        dtype=np.float32) -> np.ndarray:
    """Box-blurred variant of :func:`shapes_image`."""
    img = shapes_image(H, W, dtype=np.float64)
    k = max(1, int(sigma))
    img = _box_filter_1d(img, k, 0)
    img = _box_filter_1d(img, k, 1)
    return img.astype(dtype)


def warp_image(
    img_ref: torch.Tensor,
    pose_t: torch.Tensor,
    pose_q: torch.Tensor,
    plane_depth: float,
    K: torch.Tensor,
) -> torch.Tensor:
    """Render the reference image as seen from pose T_c2r through the
    frontoparallel-plane model."""
    H, W = img_ref.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=img_ref.device),
                            torch.arange(W, device=img_ref.device), indexing="ij")
    xy = torch.stack([xs, ys], dim=-1).to(img_ref.dtype)  # [H, W, 2]
    depth = torch.as_tensor(plane_depth, dtype=img_ref.dtype, device=img_ref.device)
    ref_xy = frontoparallel_warp(pose_t, pose_q, depth, K, xy.reshape(-1, 2))
    return bilinear_sample(img_ref, ref_xy).reshape(H, W)


def synthesize_blurred_image(
    img_ref: torch.Tensor,
    knots: SplineKnots,
    degree: int,
    capture_time: float,
    exposure_time: float,
    num_samples: int,
    plane_depth: float,
    K: torch.Tensor,
    quantize: bool = False,
) -> torch.Tensor:
    """Average of warped views at spline poses across the exposure window."""
    cap = torch.as_tensor(capture_time, dtype=img_ref.dtype, device=img_ref.device)
    times = virtual_pose_times(cap, exposure_time, num_samples)
    renders = []
    for tt in times:
        p = spline_pose_at(knots, tt, degree)
        img = warp_image(img_ref, p.t, p.q, plane_depth, K)
        if quantize:
            img = torch.floor(torch.clamp(img, 0.0, 255.0))
        renders.append(img)
    out = torch.stack(renders).mean(dim=0)
    if quantize:
        out = torch.floor(torch.clamp(out, 0.0, 255.0) + 0.5)
    return out
