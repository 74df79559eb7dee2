"""Events inside a chunk of the port's BlurAwareTracker.track_frames: a
keyframe switch, a rejected frame, both in one chunk in both orders, and both
on the same frame. Each run is held against the JAX tracker's track_frames,
against inflight=1 and against the port's own track_frame loop, float64 on
the CPU from a moving start, poses to 1e-8 (tests/test_torch_multiframe.py
has the runs without events).
"""

import numpy as np
import pytest

from torch_port_common import H, W, npy, scene_ate

from test_torch_multiframe import (  # noqa: F401  (scene is a fixture)
    N_FRAMES, POSE_TOL, assert_same_state, jax_config, run_all, scene,
)


def test_keyframe_switch_mid_chunk(scene):
    """A 1.5 px flow bound fires on the third frame of the first chunk: the
    frames after it re-track against the new keyframe in every variant."""
    cfg = jax_config(keyframe_max_flow_mag1=1.5)
    (pj, p2, p1, pf), (j, t2, _, _) = run_all(cfg, scene, candidates=True)
    assert np.abs(np.asarray(j.T_keyframe.t)).max() > 0.01    # switches happened
    np.testing.assert_allclose(p2, pj, atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(p2, p1)
    np.testing.assert_allclose(p2, pf, atol=POSE_TOL, rtol=0)
    assert_same_state(j, t2)
    assert scene_ate(p2, scene) < 2e-3


def test_nan_frame_mid_chunk(scene):
    """Frame 2 (third of the first chunk) is NaN: it is rejected with the
    last good pose repeated, the failure logged, and tracking resumes."""
    frames = list(scene["blurred"])
    frames[2] = np.full((H, W), np.nan)
    (pj, p2, p1, pf), (j, t2, _, tf) = run_all(jax_config(), scene, frames)
    np.testing.assert_allclose(p2, pj, atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(p2, p1)
    assert_same_state(j, t2)
    assert [e.cap_time for e in t2.failure_log] == [scene["caps"][2]]
    assert t2.failure_log[0].reason == "non-finite LM cost (corrupted frame data)"
    np.testing.assert_array_equal(p2[2], p2[1])
    assert np.isnan(t2.last_track_stats[2]).all() and np.isnan(j.last_track_stats[2]).all()
    # the track_frame loop returns the rejected frame's own (garbage) pose
    # and rejects it one frame later; every other frame agrees
    good = [i for i in range(N_FRAMES) if i != 2]
    np.testing.assert_allclose(p2[good], pf[good], atol=POSE_TOL, rtol=0)
    assert [e.cap_time for e in tf.failure_log] == [scene["caps"][2]]
    assert scene_ate(p2, scene, skip=(2,)) < 1e-3


@pytest.mark.parametrize("nan_at,expect_kf_first", [(3, True), (1, False)])
def test_keyframe_and_failure_in_one_chunk(scene, nan_at, expect_kf_first):
    """The keyframe fires on frame 2. A NaN frame after it (3) is re-tracked
    against the new keyframe and rejected there; a NaN frame before it (1)
    is rejected first and the keyframe fires on the re-tracked rest."""
    cfg = jax_config(keyframe_max_flow_mag1=1.5)
    frames = list(scene["blurred"])
    frames[nan_at] = np.full((H, W), np.nan)
    (pj, p2, p1, pf), (j, t2, _, _) = run_all(cfg, scene, frames, candidates=True)
    np.testing.assert_allclose(p2, pj, atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(p2, p1)
    assert_same_state(j, t2)
    assert [e.cap_time for e in t2.failure_log] == [scene["caps"][nan_at]]
    good = [i for i in range(N_FRAMES) if i != nan_at]
    np.testing.assert_allclose(p2[good], pf[good], atol=POSE_TOL, rtol=0)
    assert np.abs(npy(t2.T_keyframe.t)).max() > 0.01
    assert expect_kf_first == (nan_at > 2)


def test_failure_and_keyframe_on_the_same_frame(scene):
    """With a sanity bound (1.45 px) just under the keyframe bound (1.5 px)
    the frame that fires the keyframe criterion also fails the health check.
    The health check runs first, so the failure wins and no keyframe is
    installed; every later frame is further away still and is rejected too."""
    sub = {k: (v[:5] if isinstance(v, list) else v) for k, v in scene.items()}
    cfg = jax_config(keyframe_max_flow_mag1=1.5, max_sane_flow=1.45)
    (pj, p2, p1, _), (j, t2, _, _) = run_all(cfg, sub, candidates=True)
    np.testing.assert_allclose(p2, pj, atol=POSE_TOL, rtol=0)
    np.testing.assert_array_equal(p2, p1)
    assert len(t2.failure_log) == len(j.failure_log) >= 1
    assert "exceeds sanity bound" in t2.failure_log[0].reason
    assert np.abs(npy(t2.T_keyframe.t)).max() == 0.0
    assert_same_state(j, t2)
