"""The port's BlurAwareTracker.track_frames against the JAX tracker's and
against the port's own track_frame loop, float64 on the CPU.

All three must give the same poses to 1e-8 on the same frames from the same
moving start, and ``inflight`` (chunks dispatched ahead of their statistics)
must not change a result. tests/test_torch_multiframe_events.py has the runs
with a keyframe switch or a rejected frame inside a chunk.
"""

import numpy as np
import pytest

from mba_vo_tpu.tracker import blur_tracker as jbt
from mba_vo_tpu.tracker.detector import DetectorOptions

from torch_port_common import (
    EXPOSURE, H, W, bootstrap_pair, moving_scene, npy, poses_array, scene_ate,
)

N_FRAMES = 9          # chunks of 4, 4 and a tail of 1
CHUNK = 4
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
    return moving_scene(N_FRAMES)


def batch(tracker, scene, frames=None, candidates=False, **kw):
    frames = scene["blurred"] if frames is None else frames
    extra = dict(sharp_imgs=scene["sharp"], depth_maps=scene["depth"]) if candidates else {}
    return poses_array(tracker.track_frames(frames, scene["caps"], scene["exps"],
                                            chunk=CHUNK, **extra, **kw))


def per_frame(tracker, scene, frames=None, candidates=False):
    frames = scene["blurred"] if frames is None else frames
    out = []
    for i, (c, b) in enumerate(zip(scene["caps"], frames)):
        sharp, depth = (scene["sharp"][i], scene["depth"][i]) if candidates else (None, None)
        out.append(tracker.track_frame(sharp, b, c, EXPOSURE, depth))
    tracker.flush()
    return poses_array(out)


def run_all(cfg, scene, frames=None, candidates=False):
    """(JAX track_frames, port track_frames at inflight 2, at inflight 1,
    port track_frame loop) and the trackers that produced them."""
    j, t2 = bootstrap_pair(cfg, scene)
    _, t1 = bootstrap_pair(cfg, scene)
    _, tf = bootstrap_pair(cfg, scene)
    pj = batch(j, scene, frames, candidates, inflight=2)
    p2 = batch(t2, scene, frames, candidates, inflight=2)
    p1 = batch(t1, scene, frames, candidates, inflight=1)
    pf = per_frame(tf, scene, frames, candidates)
    return (pj, p2, p1, pf), (j, t2, t1, tf)


def assert_same_state(j, t):
    np.testing.assert_allclose(npy(t.knots.t), np.asarray(j.knots.t), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(npy(t.knots.q), np.asarray(j.knots.q), atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(npy(t.T_keyframe.t), np.asarray(j.T_keyframe.t),
                               atol=POSE_TOL, rtol=0)
    assert t.prev_timestamp == j.prev_timestamp
    assert [(e.cap_time, e.reason) for e in t.failure_log] == [
        (e.cap_time, e.reason) for e in j.failure_log]


@pytest.fixture(scope="module")
def plain_run(scene):
    return run_all(jax_config(), scene)


def test_track_frames_matches_jax(plain_run, scene):
    (pj, p2, _, _), (j, t2, _, _) = plain_run
    np.testing.assert_allclose(p2, pj, atol=POSE_TOL, rtol=0)
    assert_same_state(j, t2)
    assert scene_ate(p2, scene) < 1e-3


def test_inflight_does_not_change_the_result(plain_run):
    (_, p2, p1, _), _ = plain_run
    np.testing.assert_array_equal(p2, p1)


def test_track_frames_equals_the_track_frame_loop(plain_run):
    (_, p2, _, pf), (_, t2, _, tf) = plain_run
    np.testing.assert_allclose(p2, pf, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(npy(t2.knots.t), npy(tf.knots.t), atol=POSE_TOL, rtol=0)


def test_last_summaries_and_stats_as_in_jax(plain_run):
    """After track_frames, last_summaries is a list of (level, iterations)
    ints of the last committed frame, and last_track_stats the (flow, blur
    kernel) rows of the committed frames."""
    _, (j, t2, _, tf) = plain_run
    assert t2.last_summaries == j.last_summaries
    assert all(isinstance(n, int) for _, n in t2.last_summaries)
    assert [lv for lv, _ in t2.last_summaries] == [1, 0]
    assert t2.last_track_stats.shape == (N_FRAMES, 2)
    np.testing.assert_allclose(t2.last_track_stats, j.last_track_stats, atol=1e-6, rtol=0)
    assert t2.avg_kernel_length == pytest.approx(j.avg_kernel_length, abs=1e-6)
    # the per-frame path reports LMSummary objects with the same counts
    assert [(lv, s.num_iterations) for lv, s in tf.last_summaries] == t2.last_summaries


def test_frame_callback_calls(scene):
    """cb(batch index, that frame's knots) at commit; None for a rejected
    frame."""
    frames = list(scene["blurred"])
    frames[5] = np.full((H, W), np.nan)
    j, t = bootstrap_pair(jax_config(), scene)
    calls_j, calls_t = [], []
    j.frame_callback = lambda i, k: calls_j.append(
        (i, None if k is None else np.asarray(k.t)))
    t.frame_callback = lambda i, k: calls_t.append((i, None if k is None else npy(k.t)))
    batch(j, scene, frames)
    batch(t, scene, frames)
    assert [i for i, _ in calls_t] == [i for i, _ in calls_j] == list(range(N_FRAMES))
    for (_, a), (_, b) in zip(calls_j, calls_t):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b, a, atol=POSE_TOL, rtol=0)
    assert calls_t[5][1] is None


def test_bootstrap_through_track_frames(scene):
    """A fresh tracker takes its first frame as the keyframe inside
    track_frames; the returned poses are tensors on the tracker's device."""
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.tracker import blur_tracker as tbt

    t = tbt.BlurAwareTracker(interop.config_from_fields(jax_config()), scene["kvec"], (H, W),
                             device="cpu")
    imgs = [scene["img"]] + scene["blurred"][:2]
    caps = [0.0] + scene["caps"][:2]
    depth = [np.full((H, W), 2.0)] + scene["depth"][:2]
    poses = t.track_frames(imgs, caps, [EXPOSURE] * 3, sharp_imgs=imgs, depth_maps=depth,
                           chunk=CHUNK)
    assert len(poses) == 3 and all(p.t.device.type == "cpu" for p in poses)
    np.testing.assert_array_equal(npy(poses[0].t), np.zeros(3))
    np.testing.assert_array_equal(t.last_track_stats[0], [0.0, 0.0])
    assert t.track_frames([], [], []) == []
