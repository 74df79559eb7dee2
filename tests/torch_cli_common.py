"""The eth3d-format fixture and helpers shared by tests/test_torch_cli*.py.

The command line tracks from a standing start, where the first frame's
patch anchors are integer pixels up to the last bit and the jitted JAX
tracker and eager torch may floor them onto different pixels (ROADMAP.md
Queue 3). The fixture's camera (fx = fy = 64, principal point at the
centre, first depth 2 m) makes that round trip exact in any order of
evaluation, so both trackers start from the same layout.
"""

import contextlib
import io
import json
import os

import jax.numpy as jnp
import numpy as np
from PIL import Image as PILImage

from mba_vo_tpu.core.spline import spline_pose_at
from mba_vo_tpu.data import datasets as jds
from mba_vo_tpu.data.synthetic import synthesize_blurred_image, warp_image
from mba_vo_tpu_torch.data import datasets as tds

from test_tracker import smooth_texture, world_spline

H, W, FX = 96, 128, 64.0
KVEC = np.array([FX, FX, (W - 1) / 2, (H - 1) / 2])
DEPTH, EXPOSURE, FRAME_DT = 2.0, 0.03, 0.1
N_FRAMES = 5


def make_eth3d(root):
    """images/ (8-bit PNG), sharp/, depths/ (16-bit PNG / 5000), times.txt,
    groundtruth.txt, a float64 tracker config that keyframes most frames and
    a backend config, written under ``root``."""
    for d in ("images", "sharp", "depths"):
        os.makedirs(root / d)
    img0 = jnp.asarray(smooth_texture(H, W, seed=13))
    traj = world_spline(num_knots=N_FRAMES + 5, dt=FRAME_DT)
    K = jnp.asarray(KVEC)
    lines, gt = [], []
    for i in range(N_FRAMES + 1):
        cap = i * FRAME_DT
        p = spline_pose_at(traj, cap, 2)
        blurred = img0 if i == 0 else synthesize_blurred_image(
            img0, traj, 2, cap, EXPOSURE, 5, DEPTH, K)
        sharp = img0 if i == 0 else warp_image(img0, p.t, p.q, DEPTH, K)
        name = f"frame_{i:04d}.png"
        for d, a in (("images", blurred), ("sharp", sharp)):
            PILImage.fromarray(np.clip(np.asarray(a), 0, 255).astype(np.uint8)).save(
                root / d / name)
        depth = np.full((H, W), DEPTH - float(p.t[2]), np.float32)
        PILImage.fromarray(np.clip(depth * 5000.0, 0, 65535).astype(np.uint16)).save(
            root / "depths" / name)
        lines.append(f"{name} {cap} {EXPOSURE}")
        gt.append((cap, np.asarray(p.t), np.asarray(p.q)))
    (root / "times.txt").write_text("\n".join(lines) + "\n")
    jds.save_tum_trajectory(str(root / "groundtruth.txt"), np.array([g[0] for g in gt]),
                            np.stack([g[1] for g in gt]), np.stack([g[2] for g in gt]))
    (root / "config.json").write_text(json.dumps({
        "num_pyramid_levels": 2, "num_virtual_poses": [3, 3], "huber_a": 10.0,
        "min_abs_cost_decrease": 1e-6, "max_num_iterations": 8,
        "keyframe_max_flow_mag0": 0.5, "keyframe_max_flow_mag1": 1.0,
        "keyframe_max_blur_kernel_mag": 1e9,
        "detector": {"score_threshold": 5.0, "cell_h": 12, "cell_w": 12,
                     "max_keypoints": 256},
        "dtype": "float64",
    }))
    (root / "backend.json").write_text(json.dumps({
        "window_size": 3, "loop_skip_recent": 1,
        "detector": {"score_threshold": 1.0, "cell_h": 8, "cell_w": 8, "max_keypoints": 256},
        "ba": {"max_iterations": 8},
    }))
    return root


def track_args(root, out, extra=()):
    return ["track", "--images", str(root / "images"), "--sharp-images", str(root / "sharp"),
            "--depths", str(root / "depths"), "--dataset-type", "eth3d",
            "--times", str(root / "times.txt"),
            "--intrinsics", ",".join(str(v) for v in KVEC), "--output", str(root / out),
            "--config", str(root / "config.json"),
            "--backend-config", str(root / "backend.json"), *extra]


def run_quiet(main, argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = main(argv)
    assert rc == 0
    return out.getvalue()


def tum(path):
    times, t, q = tds.load_tum_trajectory(str(path))
    return np.concatenate([times[:, None], t, q], axis=1)


