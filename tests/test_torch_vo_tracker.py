"""A tracker with a backend: the port's BlurAwareTracker(backend=VOBackend)
against the JAX tracker with the JAX backend, float64 on the CPU, through
track_frame, track_frames and track_frames_joint from a moving state, with
a keyframe at most frames (each hands the backend a keyframe and adopts its
refined pose).

Both backends detect on the image in float64 here: in float32, XLA and
torch round the detector's sums differently and the keypoints differ by
float32 rounding, which tests/test_torch_vo_backend.py pins on its own.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mba_vo_tpu.backend import vo_backend as jvb
from mba_vo_tpu.core.spline import make_knots, spline_pose_at_times
from mba_vo_tpu.tracker import blur_tracker as jbt
from mba_vo_tpu.tracker.detector import DetectorOptions
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.backend import vo_backend as tvb
from mba_vo_tpu_torch.tracker import blur_tracker as tbt

from torch_port_common import (
    DEPTH, EXPOSURE, FRAME_DT, VEL, moving_scene, npy, poses_array,
)

POSE_TOL = 1e-8
SCENE_HW = (96, 128)
SCENE_K = np.array([90.0, 90.0, 63.5, 47.5])
N_FRAMES = 4
CHUNK = 3


def tracker_config():
    return jbt.TrackerConfig(
        num_pyramid_levels=2, num_virtual_poses=(3, 3), huber_a=10.0,
        min_abs_cost_decrease=1e-6, max_num_iterations=6,
        keyframe_max_flow_mag0=0.5, keyframe_max_flow_mag1=1.0,   # a keyframe most frames
        keyframe_max_blur_kernel_mag=1e9,
        detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8, max_keypoints=64),
        dtype="float64")


def backend_config():
    return jvb.BackendConfig(window_size=3, loop_skip_recent=1,
                             detector=DetectorOptions(score_threshold=1.0, cell_h=8,
                                                      cell_w=8, max_keypoints=128),
                             ba=jvb.BAOptions(max_iterations=8))


@pytest.fixture(scope="module")
def scene():
    return moving_scene(N_FRAMES, h=SCENE_HW[0], w=SCENE_HW[1], kvec=SCENE_K)


@pytest.fixture
def float64_detection():
    saved = jvb.detect_sparse, tvb.detect_sparse
    jvb.detect_sparse = lambda img, opts: saved[0](img.astype(jnp.float64), opts)
    tvb.detect_sparse = lambda img, opts: saved[1](img.double(), opts)
    yield
    jvb.detect_sparse, tvb.detect_sparse = saved


def tracker_pair(scene):
    """(JAX tracker, port tracker) with backends, after the bootstrap frame,
    with the same velocity installed."""
    h, w = scene["hw"]
    cfg = tracker_config()
    jb = jvb.VOBackend(backend_config(), scene["kvec"])
    tb = tvb.VOBackend(interop.backend_config_from_fields(backend_config()), scene["kvec"],
                       device="cpu")
    j = jbt.BlurAwareTracker(cfg, scene["kvec"], (h, w), backend=jb)
    t = tbt.BlurAwareTracker(interop.config_from_fields(cfg), scene["kvec"], (h, w),
                             backend=tb, device="cpu")
    for tr in (j, t):
        tr.track_frame(scene["img"], scene["img"], 0.0, EXPOSURE, np.full((h, w), DEPTH))
    j.neigh_velocity = jnp.asarray(VEL)
    interop.install_tracker_state(t, {"neigh_velocity": VEL})
    return j, t


def install_moving_window(j, t, scene):
    """A joint window that already moves (see tests/test_torch_joint.py)."""
    K = CHUNK + 2 - 1
    t0 = scene["caps"][0] - 0.5 * EXPOSURE
    p = spline_pose_at_times(scene["traj"], jnp.asarray(t0 + FRAME_DT * np.arange(K)), 2)
    j._joint_knots = make_knots(p.t, p.q, t0, FRAME_DT)
    j._joint_dt = FRAME_DT
    interop.install_tracker_state(t, {
        "joint_knots": dict(t=np.asarray(p.t), q=np.asarray(p.q), t0=t0, dt=FRAME_DT),
        "joint_dt": FRAME_DT})


def run_path(tracker, scene, path):
    if path == "track_frame":
        out = [tracker.track_frame(s, b, c, EXPOSURE, d) for s, b, c, d in zip(
            scene["sharp"], scene["blurred"], scene["caps"], scene["depth"])]
        tracker.flush()
        return poses_array(out)
    return poses_array(getattr(tracker, path)(
        scene["blurred"], scene["caps"], scene["exps"], sharp_imgs=scene["sharp"],
        depth_maps=scene["depth"], chunk=CHUNK, inflight=2))


@pytest.mark.parametrize("path", ["track_frame", "track_frames", "track_frames_joint"])
def test_tracker_with_backend_matches_jax(scene, path, float64_detection):
    j, t = tracker_pair(scene)
    if path == "track_frames_joint":
        install_moving_window(j, t, scene)
    pj = run_path(j, scene, path)
    pt = run_path(t, scene, path)
    np.testing.assert_allclose(pt, pj, rtol=0, atol=POSE_TOL)
    assert len(t.backend.keyframes) == len(j.backend.keyframes) >= 3
    np.testing.assert_allclose(npy(t.T_keyframe.t), np.asarray(j.T_keyframe.t), rtol=0,
                               atol=POSE_TOL)
    for kj, kt in zip(j.backend.keyframes, t.backend.keyframes):
        np.testing.assert_allclose(kt.pose.t, np.asarray(kj.pose.t), rtol=0, atol=POSE_TOL)
    assert sorted(j.backend.landmarks) == sorted(t.backend.landmarks)
    # the backend refined the chain: the anchor is not the odometry's alone
    assert len(t.backend.stats) == len(t.backend.keyframes)
