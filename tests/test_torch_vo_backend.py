"""The port's VOBackend against the JAX package's, float64 solvers on the
CPU: both are fed the same keyframe sequence (an out-and-back trajectory
with injected odometry drift, as in
tests/test_vo_backend.py::test_loop_closure_corrects_injected_drift) and
must agree on the keyframe poses, the landmark table, the loop edges, the
landmark budget and the BA/PG iteration counts.
tests/test_torch_vo_tracker.py runs trackers with a backend.

Both packages detect the backend's corners in float32 (the reference casts
the keyframe image), and XLA and torch round the float32 box sums and
orientation moments differently: keypoints agree to float32 rounding
(about 1e-5 px), descriptors and matches exactly. A PnP loop edge carries
that difference into the poses at about 1e-8 m, so after the first loop
closure the poses are held to LOOP_TOL. The same run with both detectors
fed the image in float64 ("float64" below) holds everything to POSE_TOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mba_vo_tpu.backend import vo_backend as jvb
from mba_vo_tpu.core.transform import Pose as JPose
from mba_vo_tpu.data.synthetic import warp_image
from mba_vo_tpu.utils.checkpoint import _backend_state_pytree, _restore_backend_state
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.backend import vo_backend as tvb

from torch_port_common import DEPTH, smooth_texture

H, W, FX = 128, 160, 120.0
KVEC = np.array([FX, FX, (W - 1) / 2, (H - 1) / 2])
POSE_TOL = 1e-8
LOOP_TOL = 1e-7   # float32 detection, once a PnP loop edge has moved the chain
# landmark positions (m) and observations (px) by detection dtype: float32
# keypoints differ by float32 rounding, lifted at ~2 m depth
LM_TOL = {"float32": 1e-5, "float64": 1e-9}
OBS_TOL = {"float32": 1e-4, "float64": 1e-9}
QID = np.array([0.0, 0.0, 0.0, 1.0])


def drift_sequence():
    """(sharp images, fed poses) of the out-and-back run with a drift of
    12 mm in y per keyframe."""
    img0 = jnp.asarray(smooth_texture(H, W, seed=5))
    xs = [0.0, 0.12, 0.24, 0.36, 0.24, 0.12, 0.01]
    drift = np.array([0.0, 0.012, 0.0])
    sharp, fed = [], []
    for k, x in enumerate(xs):
        t_true = jnp.asarray([x, 0.0, 0.0])
        sharp.append(np.asarray(warp_image(img0, t_true, jnp.asarray(QID), DEPTH,
                                           jnp.asarray(KVEC))))
        fed.append(np.array([x, 0.0, 0.0]) + drift * k)
    return sharp, fed


def record_loop_edges(be):
    edges = []
    inner = be._detect_loop_closures

    def wrapped(idx):
        out = inner(idx)
        edges.append([(int(a), int(b), np.asarray(t), np.asarray(q), float(w))
                      for a, b, t, q, w in out])
        return out
    be._detect_loop_closures = wrapped
    return edges


@pytest.fixture(scope="module", params=["float32", "float64"])
def drift_run(request):
    """Both backends over the drift sequence, detecting in float32 as
    shipped, or with both detectors fed the image in float64."""
    sharp, fed = drift_sequence()
    depth = np.full((H, W), DEPTH, np.float32)
    kw = dict(window_size=3, loop_min_matches=15, loop_skip_recent=1)
    jb = jvb.VOBackend(jvb.BackendConfig(**kw), KVEC)
    tb = tvb.VOBackend(tvb.BackendConfig(**kw), KVEC, device="cpu", profile=True)
    jedges, tedges = record_loop_edges(jb), record_loop_edges(tb)
    saved = jvb.detect_sparse, tvb.detect_sparse
    if request.param == "float64":
        jvb.detect_sparse = lambda img, opts: saved[0](img.astype(jnp.float64), opts)
        tvb.detect_sparse = lambda img, opts: saved[1](img.double(), opts)
    try:
        steps = run_drift(jb, tb, sharp, fed, depth)
    finally:
        jvb.detect_sparse, tvb.detect_sparse = saved
    return dict(mode=request.param, jb=jb, tb=tb, jedges=jedges, tedges=tedges,
                steps=steps, fed=fed)


def run_drift(jb, tb, sharp, fed, depth):
    steps = []
    for k, (img, t) in enumerate(zip(sharp, fed)):
        rj = jb.on_keyframe(img, depth, JPose(t=jnp.asarray(t), q=jnp.asarray(QID)), float(k))
        rt = tb.on_keyframe(img, depth, interop.pose_from_arrays(t, QID), float(k))
        steps.append(dict(
            refined=(rj is None, rt is None),
            ba_iters=(int(jb.last_summary.num_iterations) if jb.last_summary else None,
                      tb.last_summary.num_iterations if tb.last_summary else None),
            loops=(jb.last_num_loop_edges, tb.last_num_loop_edges),
            dropped=(jb.last_landmarks_dropped, tb.last_landmarks_dropped),
            poses=(np.stack([np.concatenate([np.asarray(kf.pose.t), np.asarray(kf.pose.q)])
                             for kf in jb.keyframes]),
                   np.stack([np.concatenate([kf.pose.t, kf.pose.q]) for kf in tb.keyframes])),
        ))
    return steps


def pose_tol(run, k):
    looped = any(s["loops"][0] for s in run["steps"][:k + 1])
    return LOOP_TOL if run["mode"] == "float32" and looped else POSE_TOL


def test_keyframe_poses_match_at_every_step(drift_run):
    for k, s in enumerate(drift_run["steps"]):
        assert s["refined"][0] == s["refined"][1], k
        np.testing.assert_allclose(s["poses"][1], s["poses"][0], rtol=0,
                                   atol=pose_tol(drift_run, k), err_msg=f"keyframe {k}")


def test_loop_closure_corrects_the_drift_in_both(drift_run):
    tb, steps, fed = drift_run["tb"], drift_run["steps"], drift_run["fed"]
    loops = [s["loops"] for s in steps]
    assert [a for a, _ in loops] == [b for _, b in loops]
    assert sum(a for a, _ in loops) >= 2
    err = np.linalg.norm(tb.keyframes[-1].pose.t - np.array([0.01, 0.0, 0.0]))
    fed_err = np.linalg.norm(fed[-1] - np.array([0.01, 0.0, 0.0]))
    assert err < 0.5 * fed_err


def test_loop_edges_match(drift_run):
    jedges, tedges = drift_run["jedges"], drift_run["tedges"]
    tol = LOOP_TOL if drift_run["mode"] == "float32" else POSE_TOL
    assert len(jedges) == len(tedges)
    for ej, et in zip(jedges, tedges):
        assert [(a, b, w) for a, b, _, _, w in ej] == [(a, b, w) for a, b, _, _, w in et]
        for (_, _, tj, qj, _), (_, _, tt, qt, _) in zip(ej, et):
            np.testing.assert_allclose(tt, tj, rtol=0, atol=tol)
            np.testing.assert_allclose(qt, qj, rtol=0, atol=tol)


def test_iteration_counts_and_budget_match(drift_run):
    tb, steps = drift_run["tb"], drift_run["steps"]
    for k, s in enumerate(steps):
        assert s["ba_iters"][0] == s["ba_iters"][1], k
        assert s["dropped"][0] == s["dropped"][1], k
    # every keyframe after the first ran BA; the pose graph ran where edges were
    assert all(st["ba_iterations"] > 0 for st in tb.stats[1:])
    assert [st["pg_iterations"] > 0 for st in tb.stats] == [s["loops"][1] > 0 for s in steps]
    assert set(tb.stats[-1]["ms"]) <= set(tvb.STAGES)


def test_landmark_tables_match(drift_run):
    jb, tb, mode = drift_run["jb"], drift_run["tb"], drift_run["mode"]
    assert sorted(jb.landmarks) == sorted(tb.landmarks)
    assert jb._next_lm == tb._next_lm
    for lid, lj in jb.landmarks.items():
        lt = tb.landmarks[lid]
        assert lt.anchor == lj.anchor
        assert sorted(lt.obs) == sorted(lj.obs), lid
        for k in lj.obs:
            np.testing.assert_allclose(lt.obs[k], np.asarray(lj.obs[k]), rtol=0,
                                       atol=OBS_TOL[mode])
        np.testing.assert_allclose(lt.position, np.asarray(lj.position), rtol=0,
                                   atol=LM_TOL[mode])
        np.testing.assert_array_equal(lt.desc, np.asarray(lj.desc))
    for kj, kt in zip(jb.keyframes, tb.keyframes):
        np.testing.assert_array_equal(kt.feat_landmark, kj.feat_landmark)
        np.testing.assert_array_equal(kt.desc_np, np.asarray(kj.desc_np))
        np.testing.assert_allclose(kt.kp_np, np.asarray(kj.kp_np), rtol=0, atol=OBS_TOL[mode])


def test_state_carried_across_continues_alike(drift_run):
    """interop.install_backend_state starts the port's backend from the JAX
    backend's chain and landmark table (the layout the JAX checkpoint
    writes): one more keyframe, detected in float32 with a loop closure,
    then gives the same poses in both."""
    kw = dict(window_size=3, loop_min_matches=15, loop_skip_recent=1)
    ref = _backend_state_pytree(drift_run["jb"])
    jb = jvb.VOBackend(jvb.BackendConfig(**kw), KVEC)
    _restore_backend_state(jb, ref)
    tb = tvb.VOBackend(tvb.BackendConfig(**kw), KVEC, device="cpu")
    interop.install_backend_state(tb, ref)
    back = interop.backend_state_arrays(tb)
    for key in ("landmark_ids", "landmark_anchor", "obs_row", "obs_kf", "next_lm"):
        np.testing.assert_array_equal(back[key], np.asarray(ref[key]))
    for key in ("landmark_pos", "obs_xy", "landmark_desc"):
        np.testing.assert_array_equal(back[key], np.asarray(ref[key]))
    img = np.asarray(warp_image(jnp.asarray(smooth_texture(H, W, seed=5)),
                                jnp.asarray([0.05, 0.0, 0.0]), jnp.asarray(QID), DEPTH,
                                jnp.asarray(KVEC)))
    depth = np.full((H, W), DEPTH, np.float32)
    t = np.array([0.05, 0.09, 0.0])
    jb.on_keyframe(img, depth, JPose(t=jnp.asarray(t), q=jnp.asarray(QID)), 7.0)
    tb.on_keyframe(img, depth, interop.pose_from_arrays(t, QID), 7.0)
    assert tb.last_num_loop_edges == jb.last_num_loop_edges > 0
    for kj, kt in zip(jb.keyframes, tb.keyframes):
        np.testing.assert_allclose(kt.pose.t, np.asarray(kj.pose.t), rtol=0, atol=LOOP_TOL)


def test_backend_config_from_fields():
    cfg = jvb.BackendConfig(window_size=5, max_landmarks=128)
    assert interop.backend_config_from_fields(cfg) == tvb.BackendConfig(
        window_size=5, max_landmarks=128)
    # sharded BA: the reference's ValueErrors where one process cannot shard
    # (tests/test_torch_parallel.py runs it on four ranks)
    with pytest.raises(ValueError, match=r"max_landmarks \(512\) must be a multiple of "
                                         r"shard_devices \(3\)"):
        tvb.VOBackend(tvb.BackendConfig(shard_devices=3), KVEC, device="cpu")
    with pytest.raises(ValueError, match="shard_devices=2 but only 1 devices are visible"):
        tvb.VOBackend(tvb.BackendConfig(shard_devices=2), KVEC, device="cpu")
    assert tvb.VOBackend(tvb.BackendConfig(), KVEC, device="cpu").mesh is None
