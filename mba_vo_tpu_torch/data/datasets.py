"""Dataset loaders and trajectory I/O.

Counterpart of ``mba_vo_tpu/data/datasets.py``, with the same contract:
  * "unreal": ASCII ray-depth maps (whitespace-separated floats, row-major,
    values > 100 m zeroed) and the ray-depth to z-depth conversion;
  * "eth3d": 16-bit PNG depth divided by 5000;
  * sorted image folders; TUM trajectory files ("t x y z qx qy qz qw",
    '#' comments); ASCII PLY point clouds; unreal ground-truth pose files
    and IMU logs ("t ax ay az gx gy gz").

PNGs go through ``data/png.py`` (grey 8- and 16-bit). A 16-bit frame read
by :func:`load_gray_image` saturates at 255, as PIL's ``I;16`` to ``L``
conversion does.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .png import read_png

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".pgm")


# ------------------------------------------------------------------ depth maps


def load_depth_ascii(path: str, height: int, width: int) -> np.ndarray:
    """Unreal ASCII depth map: H*W floats, > 100 m clamped to 0."""
    vals = np.loadtxt(path).reshape(-1)
    if vals.size != height * width:
        raise ValueError(
            f"{path}: expected {height * width} depth values, got {vals.size}"
        )
    depth = vals.reshape(height, width).astype(np.float32)
    depth[depth > 100.0] = 0.0
    return depth


def ray_depth_to_z(depth_ray: np.ndarray, K: Sequence[float]) -> np.ndarray:
    """Distance along the ray to z-depth: z = d / sqrt(1 + x_n^2 + y_n^2)."""
    H, W = depth_ray.shape
    fx, fy, cx, cy = K
    xs = (np.arange(W) - cx) / fx
    ys = (np.arange(H) - cy) / fy
    xn, yn = np.meshgrid(xs, ys)
    z_hat = 1.0 / np.sqrt(1.0 + xn * xn + yn * yn)
    return (depth_ray * z_hat).astype(np.float32)


def load_depth_png16(path: str, scale: float = 5000.0) -> np.ndarray:
    """ETH3D-style 16-bit PNG depth / 5000 -> meters."""
    return read_png(path).astype(np.float32) / scale


def load_depth(
    path: str,
    dataset_type: str,
    K: Optional[Sequence[float]] = None,
    height: Optional[int] = None,
    width: Optional[int] = None,
) -> np.ndarray:
    """Depth map of a dataset type ("unreal" or "eth3d")."""
    if dataset_type == "unreal":
        if K is None or height is None or width is None:
            raise ValueError("unreal depth needs K + image size")
        return ray_depth_to_z(load_depth_ascii(path, height, width), K)
    if dataset_type == "eth3d":
        return load_depth_png16(path)
    raise ValueError(f"unknown dataset type {dataset_type!r}")


# ---------------------------------------------------------------- image folder


def list_image_folder(folder: str) -> List[str]:
    """Sorted list of image paths."""
    names = sorted(
        f for f in os.listdir(folder)
        if f.lower().endswith(IMAGE_EXTENSIONS)
    )
    return [os.path.join(folder, f) for f in names]


def gray_image(pixels: np.ndarray) -> np.ndarray:
    """``read_png``'s pixels as float32 in [0, 255] (16-bit values saturate
    at 255)."""
    if pixels.dtype == np.uint16:
        pixels = np.minimum(pixels, 255)
    return pixels.astype(np.float32)


def load_gray_image(path: str) -> np.ndarray:
    """A grey PNG as float32 in [0, 255] (16-bit values saturate at 255)."""
    return gray_image(read_png(path))


# --------------------------------------------------------------- trajectory IO


def load_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load 't x y z qx qy qz qw' lines, '#' comments skipped.
    Returns (times [N], t [N,3], q_xyzw [N,4])."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [float(x) for x in line.split()]
            if len(parts) < 8:
                continue
            rows.append(parts[:8])
    arr = np.asarray(rows, dtype=np.float64)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:8]


def save_tum_trajectory(
    path: str, times: np.ndarray, t: np.ndarray, q_xyzw: np.ndarray,
    header: str = "timestamp tx ty tz qx qy qz qw",
) -> None:
    with open(path, "w") as f:
        f.write(f"# {header}\n")
        for i in range(len(times)):
            f.write(
                f"{times[i]:.9f} "
                + " ".join(f"{v:.9f}" for v in t[i])
                + " "
                + " ".join(f"{v:.9f}" for v in q_xyzw[i])
                + "\n"
            )


def knots_from_tum(path: str, device="cpu"):
    """SplineKnots (float64) from a TUM knot file, t0/dt from the first two
    stamps: the first knot's stamp is consumed before dt is known, so t0 is
    the second stamp."""
    from ..core.spline import make_knots

    times, t, q = load_tum_trajectory(path)
    if len(times) < 2:
        raise ValueError(f"{path}: need at least 2 knots")
    dt = times[1] - times[0]
    t0 = times[1]
    f64 = dict(dtype=torch.float64, device=device)
    return make_knots(torch.tensor(t, **f64), torch.tensor(q, **f64), t0, dt)


# ------------------------------------------------------------------------- PLY


def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray] = None):
    """ASCII PLY point cloud."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]} {points[i, 1]} {points[i, 2]}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


# ----------------------------------------------------- unreal ground-truth logs


def load_unreal_gt_poses(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unreal ground-truth nav-state file, rows 'time x y z qx qy qz qw ...'.
    Returns (times, t [N,3], q_xyzw [N,4])."""
    return load_tum_trajectory(path)


def load_imu_log(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """IMU log rows 'time ax ay az gx gy gz' ('#' comments and short rows
    skipped). Returns (times, acc [N,3], gyro [N,3])."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = [float(x) for x in line.split()]
            if len(parts) >= 7:
                rows.append(parts[:7])
    arr = np.asarray(rows, dtype=np.float64)
    return arr[:, 0], arr[:, 1:4], arr[:, 4:7]
