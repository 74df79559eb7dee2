"""The port's BlurAwareTracker.track_frames_joint against the JAX tracker's,
on the CPU: the counterparts of tests/test_joint_window.py's cases that need
no backend and no checkpoint, at degree 2 in float64
(tests/test_torch_joint_deg4.py has degree 4, float32 and the multi-frame
residual).

Both trackers start from the same moving joint window (installed through
``interop.install_tracker_state``): an identity window puts the first patch
anchors on integer pixels up to the last bit, where the jitted JAX tracker
and eager torch may floor them differently. Knots and poses must then agree
to 1e-8 in float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mba_vo_tpu.core.spline import make_knots as jmake, spline_pose_at_times
from mba_vo_tpu.tracker import blur_tracker as jbt
from mba_vo_tpu.tracker.detector import DetectorOptions
from mba_vo_tpu_torch import interop

from torch_port_common import (
    EXPOSURE, FRAME_DT, H, W, bootstrap_pair, moving_scene, npy, poses_array,
    scene_ate,
)

CHUNK = 4
TOL = 1e-8


def jax_config(degree=2, **kw):
    base = dict(num_pyramid_levels=2, num_virtual_poses=(3, 3), spline_degree=degree,
                huber_a=10.0, max_chi_square_error=3.0, min_abs_cost_decrease=1e-6,
                # the joint LM retries rejected steps, and a level whose steps
                # are all rejected once it has converged runs to this limit
                max_num_iterations=6,
                keyframe_max_flow_mag0=1e9, keyframe_max_flow_mag1=1e9,
                detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                         max_keypoints=64),
                dtype="float64")
    base.update(kw)
    return jbt.TrackerConfig(**base)


@pytest.fixture(scope="module")
def scene():
    return moving_scene(6, knot_noise_seed=9)


def start_pair(cfg, scene, noise_seed=3):
    """Both trackers after the keyframe, with one moving joint window
    installed: knots sampled from the generating spline at the window's knot
    times (the keyframe sits at the identity at t = 0) plus millimetre noise,
    so the first chunk's LM has work to do."""
    j, t = bootstrap_pair(cfg, scene, exposure=max(scene["exps"]))
    K = CHUNK + cfg.spline_degree - 1
    dts = np.diff(np.asarray(scene["caps"]))
    dt = float(max(np.median(dts), max(scene["exps"]), 1e-3))
    t0 = scene["caps"][0] - 0.5 * max(scene["exps"])
    p = spline_pose_at_times(scene["traj"], jnp.asarray(t0 + dt * np.arange(K)), 2)
    rng = np.random.default_rng(noise_seed)
    kt = np.asarray(p.t) + rng.normal(0, 1e-3, (K, 3))
    q = np.asarray(p.q) + rng.normal(0, 1e-3, (K, 4))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    dtype = jnp.float32 if cfg.dtype == "float32" else jnp.float64
    j._joint_knots = jmake(jnp.asarray(kt, dtype), jnp.asarray(q, dtype), t0, dt)
    j._joint_dt = dt
    interop.install_tracker_state(
        t, {"joint_knots": dict(t=kt, q=q, t0=t0, dt=dt), "joint_dt": dt})
    return j, t


def joint(tracker, scene, frames=None, candidates=False, sl=slice(None), **kw):
    frames = scene["blurred"] if frames is None else frames
    extra = dict(sharp_imgs=scene["sharp"][sl], depth_maps=scene["depth"][sl]) \
        if candidates else {}
    return poses_array(tracker.track_frames_joint(
        frames[sl], scene["caps"][sl], scene["exps"][sl], chunk=CHUNK, **extra, **kw))


def assert_same_window(j, t, tol=TOL):
    assert t._joint_knots.num_knots == j._joint_knots.num_knots
    for name in ("t", "q", "t0", "dt"):
        np.testing.assert_allclose(npy(getattr(t._joint_knots, name)),
                                   np.asarray(getattr(j._joint_knots, name)),
                                   atol=tol, rtol=0, err_msg=name)
    np.testing.assert_allclose(npy(t.T_keyframe.t), np.asarray(j.T_keyframe.t),
                               atol=tol, rtol=0)
    assert t._joint_dt == j._joint_dt
    assert [(e.cap_time, e.reason) for e in t.failure_log] == [
        (e.cap_time, e.reason) for e in j.failure_log]


def check_sliding_window(scene, degree):
    """6 frames in chunks of 4: a (4 + degree - 1)-knot window slides once,
    and the last chunk holds 2 frames padded by repeating the last one; the
    repeated frames are residuals of the one LM problem, so dropping the
    padding would change the knots. Returns the config and the port's poses."""
    cfg = jax_config(degree)
    j, t = start_pair(cfg, scene)
    pj, pt = joint(j, scene), joint(t, scene)
    assert pt.shape == (6, 7) and t._joint_knots.num_knots == CHUNK + degree - 1
    np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)
    assert_same_window(j, t)
    np.testing.assert_allclose(t.last_track_stats, j.last_track_stats, atol=1e-6, rtol=0)
    assert t.avg_kernel_length == pytest.approx(j.avg_kernel_length, abs=1e-6)
    assert scene_ate(pt, scene) < 1e-3
    return cfg, pt


def test_sliding_window_and_tail_padding(scene):
    """At degree 2 (a 5-knot window); inflight 1 gives the same result."""
    cfg, pt = check_sliding_window(scene, 2)
    _, t1 = start_pair(cfg, scene)
    np.testing.assert_array_equal(pt, joint(t1, scene, inflight=1))


def test_keyframe_switch_in_joint_mode(scene):
    """A 1.5 px flow bound fires on the third frame of the first chunk: the
    window re-anchors to identity there, the pose folds into the chain and
    the rest re-tracks against the new keyframe."""
    cfg = jax_config(keyframe_max_flow_mag1=1.5)
    j, t = start_pair(cfg, scene)
    pj = joint(j, scene, candidates=True)
    pt = joint(t, scene, candidates=True)
    assert np.abs(np.asarray(j.T_keyframe.t)).max() > 0.01
    np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)
    assert_same_window(j, t)
    assert len(j.failure_log) == 0
    assert np.abs(pt[:, :3] - poses_truth(scene)[:, :3]).max() < 1e-2


def poses_truth(scene):
    p = spline_pose_at_times(scene["traj"], jnp.asarray(scene["caps"]), 2)
    return np.concatenate([np.asarray(p.t), np.asarray(p.q)], axis=1)


def test_failure_recovery_in_joint_mode(scene):
    """A NaN frame is screened on the host and never enters a chunk: its
    pose is held at the last good one, and tracking resumes after the gap
    (the knot slide absorbs the hole)."""
    frames = list(scene["blurred"])
    frames[2] = np.full((H, W), np.nan)
    j, t = start_pair(jax_config(), scene)
    calls = []
    t.frame_callback = lambda i, k: calls.append((i, k is None))
    pj, pt = joint(j, scene, frames), joint(t, scene, frames)
    np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)
    assert_same_window(j, t)
    assert [(e.cap_time, e.reason) for e in t.failure_log] == [
        (scene["caps"][2], "non-finite input frame")]
    np.testing.assert_array_equal(pt[2], pt[1])
    assert np.isnan(t.last_track_stats[2]).all()
    assert calls == [(i, i == 2) for i in range(6)]
    assert scene_ate(pt, scene, skip=(2,)) < 1e-3


def test_failure_localizes_mid_chunk_frame(scene):
    """A finite but astronomically scaled frame passes the input screen and
    overflows its own patch costs only: the per-frame costs
    (patch_costs.sum over keypoints, which ignore the outlier mask) name
    frame 2 of the chunk, frames 0-1 are committed, the pre-chunk window is
    restored, and the rest tracks well."""
    frames = list(scene["blurred"])
    frames[2] = np.full((H, W), 1e200)
    j, t = start_pair(jax_config(), scene)
    pj, pt = joint(j, scene, frames), joint(t, scene, frames)
    np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)
    assert_same_window(j, t)
    assert [e.cap_time for e in t.failure_log] == [scene["caps"][2]]
    assert t.failure_log[0].reason == "non-finite LM cost (corrupted frame data)"
    assert np.isnan(t.last_track_stats[2, 0])
    assert np.isfinite(t.last_track_stats[[0, 1, 3, 4, 5]]).all()
    errs = np.linalg.norm(pt[3:, :3] - poses_truth(scene)[3:, :3], axis=1)
    assert float(np.sqrt(np.mean(errs ** 2))) < 1e-3


def test_non_uniform_timing_and_exposure():
    """Jittered frame intervals and per-frame exposures: the fixed-dt window
    and integer knot slides cover every chunk."""
    rng = np.random.default_rng(3)
    caps, exps, tm = [], [], 0.0
    for _ in range(6):
        tm += FRAME_DT * float(rng.uniform(0.7, 1.3))
        caps.append(tm)
        exps.append(EXPOSURE * float(rng.uniform(0.6, 1.2)))
    sc = moving_scene(6, knot_noise_seed=9, caps=caps, exps=exps)
    j, t = start_pair(jax_config(), sc)
    pj, pt = joint(j, sc), joint(t, sc)
    np.testing.assert_allclose(pt, pj, atol=TOL, rtol=0)
    assert_same_window(j, t)
    assert scene_ate(pt, sc) < 2e-3


def test_window_is_rebuilt_at_the_current_pose_when_timing_changes(scene):
    """A second batch at twice the cadence fails the recreation gate: both
    trackers rebuild the window constant at the current pose rather than at
    the identity."""
    j, t = start_pair(jax_config(), scene)
    joint(j, scene, sl=slice(0, 4))
    joint(t, scene, sl=slice(0, 4))
    caps = [scene["caps"][3] + 2 * FRAME_DT * (i + 1) for i in range(2)]
    for tr in (j, t):
        tr.track_frames_joint(scene["blurred"][4:6], caps, [EXPOSURE] * 2, chunk=CHUNK)
    assert t._joint_dt == j._joint_dt == pytest.approx(2 * FRAME_DT)
    assert_same_window(j, t)
    assert np.abs(npy(t._joint_knots.t)).max() > 1e-3


def test_window_errors_stay_on_the_host(scene):
    """The two RuntimeErrors of the integer knot slide."""
    _, t = start_pair(jax_config(), scene)
    far = [c + 100.0 for c in scene["caps"][:2]]
    with pytest.raises(RuntimeError, match="must slide"):
        t.track_frames_joint(scene["blurred"][:2], far, [EXPOSURE] * 2, chunk=CHUNK)
    _, t = start_pair(jax_config(), scene)
    # a live window whose first chunk starts before its support
    early = [scene["caps"][0] - 0.5 * FRAME_DT + FRAME_DT * i for i in range(4)]
    with pytest.raises(RuntimeError, match="cannot cover the chunk"):
        t.track_frames_joint(scene["blurred"][:4], early, [EXPOSURE] * 4, chunk=CHUNK)


def test_cold_window_loses_fast_motion_in_both_packages():
    """A fault of the reference, reproduced: the joint path has no
    constant-velocity prediction for a fresh window. At 3 px of image motion
    a frame (fx = 240 here), the identity window is 12 px off by the first
    chunk's last frame and the joint LM leaves the spline, in the JAX tracker
    as in the port (on different poses once they have diverged), where the
    per-frame path tracks the same frames. chip_smoke.py therefore starts its
    joint runs from a window that already moves."""
    kvec = np.array([240.0, 240.0, (W - 1) / 2, (H - 1) / 2])
    sc = moving_scene(4, kvec=kvec)
    j, t = bootstrap_pair(jax_config(), sc)
    _, t_pf = bootstrap_pair(jax_config(), sc)
    cold = [poses_array(tr.track_frames_joint(sc["blurred"], sc["caps"], sc["exps"],
                                              chunk=CHUNK)) for tr in (j, t)]
    per_frame = poses_array(t_pf.track_frames(sc["blurred"], sc["caps"], sc["exps"],
                                              chunk=CHUNK))
    assert scene_ate(cold[0], sc) > 0.1 and scene_ate(cold[1], sc) > 0.1
    assert scene_ate(per_frame, sc) < 1e-2
    assert np.isfinite(cold[1]).all() and len(t.failure_log) == 0
