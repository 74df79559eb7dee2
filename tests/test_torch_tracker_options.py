"""The tracker's two residual options, sampling="direct" and
affine_brightness, through BlurAwareTracker against the JAX tracker: float64
on the CPU, the same frames from the same moving start, poses to 1e-8.

With affine_brightness the coarser levels run pure intensity, and the finest
level runs pure intensity to convergence and then an affine pass from that
optimum; the frames here carry a gain and a bias that drift, which only that
last pass can absorb.
"""

import numpy as np
import pytest

from mba_vo_tpu.tracker import blur_tracker as jbt
from mba_vo_tpu.tracker.detector import DetectorOptions

from torch_port_common import bootstrap_pair, moving_scene, npy, poses_array, scene_ate

N_FRAMES = 3
POSE_TOL = 1e-8


def jax_config(**kw):
    base = dict(num_pyramid_levels=2, num_virtual_poses=(3, 3), huber_a=10.0,
                min_abs_cost_decrease=1e-6, keyframe_max_flow_mag0=1e9,
                keyframe_max_flow_mag1=1e9,
                detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                         max_keypoints=64),
                dtype="float64")
    base.update(kw)
    return jbt.TrackerConfig(**base)


@pytest.fixture(scope="module")
def scene():
    sc = moving_scene(N_FRAMES)
    sc["drifting"] = [(1.0 + 0.04 * (i + 1)) * b + 2.0 * (i + 1)
                      for i, b in enumerate(sc["blurred"])]
    return sc


def per_frame(tracker, scene, frames):
    out = [tracker.track_frame(None, b, c, e)
           for b, c, e in zip(frames, scene["caps"], scene["exps"])]
    tracker.flush()
    return poses_array(out)


@pytest.mark.parametrize("options,frames", [
    (dict(sampling="direct"), "blurred"),
    (dict(affine_brightness=True), "drifting"),
    (dict(sampling="direct", affine_brightness=True), "drifting"),
])
def test_track_frame_with_option_matches_jax(scene, options, frames):
    cfg = jax_config(**options)
    j, t = bootstrap_pair(cfg, scene)
    pj = per_frame(j, scene, scene[frames])
    pt = per_frame(t, scene, scene[frames])
    np.testing.assert_allclose(pt, pj, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(npy(t.knots.t), np.asarray(j.knots.t), atol=POSE_TOL, rtol=0)
    assert [s.num_iterations for _, s in t.last_summaries] == [
        int(s.num_iterations) for _, s in j.last_summaries]
    if len(options) == 1:
        assert scene_ate(pt, scene) < 1e-3
    else:
        # the direct path pairs the corrected residual with the Jacobian at
        # frozen gain and bias (tests/test_torch_residual.py pins it); under
        # this drift both trackers leave the spline, on the same poses
        assert scene_ate(pt, scene) > 1e-2
    if options.get("sampling") == "direct":
        assert t.keyframe_levels[0]["wincache"] is not None   # extracted, unused


def test_affine_cascade_beats_pure_intensity_under_drift(scene):
    """The same drifting frames without the option land off the spline, and
    track_frames gives the option's per-frame poses."""
    _, t_plain = bootstrap_pair(jax_config(), scene)
    _, t_aff = bootstrap_pair(jax_config(affine_brightness=True), scene)
    _, t_batch = bootstrap_pair(jax_config(affine_brightness=True), scene)
    p_plain = per_frame(t_plain, scene, scene["drifting"])
    p_aff = per_frame(t_aff, scene, scene["drifting"])
    p_batch = poses_array(t_batch.track_frames(scene["drifting"], scene["caps"],
                                               scene["exps"], chunk=2))
    assert scene_ate(p_aff, scene) < 0.2 * scene_ate(p_plain, scene)
    np.testing.assert_allclose(p_batch, p_aff, atol=POSE_TOL, rtol=0)
