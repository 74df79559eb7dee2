"""Visualisation: keypoint overlays, blur-kernel polylines, jet colour map.

Counterpart of ``mba_vo_tpu/utils/viz.py``: headless RGB numpy images
written as PNG files. The drawing helpers are numpy; only
:func:`blur_kernel_segments` reads the spline (the port's knots, on any
device), in one batched projection and one copy to the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def jet_color(v: float) -> np.ndarray:
    """Scalar in [0, 1] -> RGB jet colour in [0, 1]."""
    v = float(np.clip(v, 0.0, 1.0))
    four = 4.0 * v
    r = np.clip(min(four - 1.5, -four + 4.5), 0.0, 1.0)
    g = np.clip(min(four - 0.5, -four + 3.5), 0.0, 1.0)
    b = np.clip(min(four + 0.5, -four + 2.5), 0.0, 1.0)
    return np.array([r, g, b])


def scalar_to_color(value: float, vmin: float, vmax: float) -> np.ndarray:
    if vmax <= vmin:
        return jet_color(0.0)
    return jet_color((value - vmin) / (vmax - vmin))


def to_rgb(gray: np.ndarray) -> np.ndarray:
    g = np.clip(np.asarray(gray), 0, 255).astype(np.uint8)
    return np.stack([g, g, g], axis=-1)


def draw_points(img_rgb: np.ndarray, points: np.ndarray, color=(0, 255, 0),
                radius: int = 1) -> np.ndarray:
    """Filled squares at the points (rounded half to even), on a copy."""
    out = img_rgb.copy()
    H, W = out.shape[:2]
    for x, y in np.asarray(points).reshape(-1, 2):
        xi, yi = int(round(x)), int(round(y))
        if 0 <= xi < W and 0 <= yi < H:
            y0, y1 = max(0, yi - radius), min(H, yi + radius + 1)
            x0, x1 = max(0, xi - radius), min(W, xi + radius + 1)
            out[y0:y1, x0:x1] = color
    return out


def draw_segments(img_rgb: np.ndarray, segments: Sequence[np.ndarray],
                  color=(255, 0, 0)) -> np.ndarray:
    """Polylines (a keypoint's projected path across the exposure), drawn
    as dense samples rounded to pixels, on a copy."""
    out = img_rgb.copy()
    H, W = out.shape[:2]
    for seg in segments:
        seg = np.asarray(seg).reshape(-1, 2)
        for a, b in zip(seg[:-1], seg[1:]):
            n = int(max(abs(b[0] - a[0]), abs(b[1] - a[1])) * 2 + 2)
            xs = np.linspace(a[0], b[0], n)
            ys = np.linspace(a[1], b[1], n)
            for x, y in zip(xs, ys):
                xi, yi = int(round(x)), int(round(y))
                if 0 <= xi < W and 0 <= yi < H:
                    out[yi, xi] = color
    return out


def blur_kernel_segments(knots, kp_xy, kp_z, K, cap_time, exp_time, degree,
                         num_samples: int = 3):
    """Each keypoint (pixel ``kp_xy`` [N, 2] at depth ``kp_z`` [N] in the
    keyframe) projected through the spline's poses at ``num_samples`` times
    across the exposure: a list of N [num_samples, 2] polylines (float64).
    The points are lifted in float64; the poses keep the knots' dtype."""
    import torch

    from ..core.lie import quat_conjugate, quat_rotate
    from ..core.spline import spline_pose_at_times

    times = np.linspace(cap_time - 0.5 * exp_time, cap_time + 0.5 * exp_time, num_samples)
    kp_xy, kp_z = np.asarray(kp_xy, np.float64), np.asarray(kp_z, np.float64)
    P3d = np.stack([kp_z * (kp_xy[:, 0] - K[2]) / K[0], kp_z * (kp_xy[:, 1] - K[3]) / K[1],
                    kp_z], axis=-1)
    dev = knots.t.device
    p = spline_pose_at_times(knots, torch.tensor(times, dtype=knots.t.dtype, device=dev),
                             degree)
    P = torch.tensor(P3d, dtype=torch.float64, device=dev)
    Pc = quat_rotate(quat_conjugate(p.q)[:, None, :], P[None] - p.t[:, None, :])
    Pc = Pc.cpu().numpy()                                             # [S, N, 3]
    xy = np.stack([Pc[..., 0] / Pc[..., 2] * K[0] + K[2],
                   Pc[..., 1] / Pc[..., 2] * K[1] + K[3]], axis=-1)
    return [xy[:, i] for i in range(len(P3d))]


def save_png(path: str, img_rgb: np.ndarray) -> None:
    """Write an [H, W, 3] RGB image as an 8-bit PNG (data/png.py)."""
    from ..data.png import write_png

    write_png(path, np.asarray(img_rgb).astype(np.uint8))
