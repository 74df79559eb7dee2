"""The slice as a whole: the port's BlurAwareTracker.track_frame against the
JAX tracker on a small blurred sequence, float64 on the CPU.

Both trackers track the same frames from the same keyframe state and must
return the same poses to 1e-8, recover the generating spline (ATE < 1e-3,
the bound of tests/test_tracker.py), switch keyframes on the same frame and
reject the same corrupted frame.

The scenes start tracking with a non-zero constant-velocity prediction.
From a standing start the first frame's patch anchors land on integer
pixels up to the last bit, and which pixel ``floor`` picks there depends on
how each framework rounds the projection (XLA fuses it, eager torch does
not); from a moving start they are generic. The one standing-start case
runs the JAX tracker op by op, which rounds as the port does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core import lie as jlie
from mba_vo_tpu.core.spline import make_knots, spline_pose_at
from mba_vo_tpu.data.synthetic import synthesize_blurred_image, warp_image
from mba_vo_tpu.tracker import blur_tracker as jbt
from mba_vo_tpu.tracker.detector import DetectorOptions
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.tracker import blur_tracker as tbt

from torch_port_common import DEPTH, EXPOSURE, FRAME_DT, H, KVEC, W, npy, smooth_texture

N_FRAMES = 4
VEL = np.array([0.06, -0.04, 0.02, 0.02, 0.05, -0.08])   # [translation; rotation] per s
POSE_TOL = 1e-8


def jax_config(**kw):
    base = dict(num_pyramid_levels=2, num_virtual_poses=(5, 5), huber_a=10.0,
                min_abs_cost_decrease=1e-6, keyframe_max_flow_mag0=1e9,
                keyframe_max_flow_mag1=1e9,
                detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                         max_keypoints=96),
                dtype="float64")
    base.update(kw)
    return jbt.TrackerConfig(**base)


@pytest.fixture(scope="module")
def scene():
    """A smooth texture seen by a camera moving at constant velocity: the
    sharp keyframe, the blurred frames, and per-frame sharp/depth keyframe
    candidates."""
    img = smooth_texture(H, W, seed=5)
    kt, kq = [np.zeros(3)], [np.array([0.0, 0.0, 0.0, 1.0])]
    for _ in range(N_FRAMES + 3):
        kt.append(kt[-1] + VEL[:3] * FRAME_DT)
        q = np.asarray(jlie.quat_multiply(jnp.asarray(kq[-1]),
                                          jlie.quat_exp(jnp.asarray(VEL[3:] * FRAME_DT))))
        kq.append(q / np.linalg.norm(q))
    traj = make_knots(jnp.asarray(np.array(kt)), jnp.asarray(np.array(kq)), 0.0, FRAME_DT)
    K, img_j = jnp.asarray(KVEC), jnp.asarray(img)
    caps = [FRAME_DT * i for i in range(1, N_FRAMES + 1)]
    blur = jax.jit(lambda c: synthesize_blurred_image(img_j, traj, 2, c, EXPOSURE, 5, DEPTH, K))
    sharp_at = jax.jit(lambda c: warp_image(img_j, *spline_pose_at(traj, c, 2), DEPTH, K))
    blurred = [np.asarray(blur(c)) for c in caps]
    sharp = [np.asarray(sharp_at(c)) for c in caps]
    depth = [np.full((H, W), DEPTH - float(spline_pose_at(traj, c, 2).t[2])) for c in caps]
    return dict(img=img, traj=traj, caps=caps, blurred=blurred, sharp=sharp, depth=depth)


def bootstrap(cfg, scene):
    """Both trackers after their first (keyframe) frame, with the same
    non-zero velocity installed."""
    j = jbt.BlurAwareTracker(cfg, KVEC, (H, W))
    t = tbt.BlurAwareTracker(interop.config_from_fields(cfg), KVEC, (H, W), device="cpu")
    depth0 = np.full((H, W), DEPTH)
    for tr in (j, t):
        tr.track_frame(scene["img"], scene["img"], 0.0, EXPOSURE, depth0)
    j.neigh_velocity = jnp.asarray(VEL)
    interop.install_tracker_state(t, {"neigh_velocity": VEL})
    return j, t


def track(tracker, scene, frames=None, candidates=False):
    frames = scene["blurred"] if frames is None else frames
    out = []
    for i, (c, b) in enumerate(zip(scene["caps"], frames)):
        kw = dict(sharp_img=scene["sharp"][i], depth_map=scene["depth"][i]) if candidates \
            else dict(sharp_img=None, depth_map=None)
        p = tracker.track_frame(kw["sharp_img"], b, c, EXPOSURE, kw["depth_map"])
        out.append(np.concatenate([npy(p.t), npy(p.q)]))
    tracker.flush()
    return np.stack(out)


def ate(poses, scene):
    errs = [np.linalg.norm(p[:3] - np.asarray(spline_pose_at(scene["traj"], c, 2).t))
            for p, c in zip(poses, scene["caps"])]
    return float(np.sqrt(np.mean(np.square(errs))))


def jax_state(j) -> dict:
    """The JAX tracker's state as numpy arrays, in interop's layout."""
    pose = lambda p: dict(t=np.asarray(p.t), q=np.asarray(p.q))  # noqa: E731
    return dict(
        knots=dict(t=np.asarray(j.knots.t), q=np.asarray(j.knots.q),
                   t0=np.asarray(j.knots.t0), dt=np.asarray(j.knots.dt)),
        T_keyframe=pose(j.T_keyframe), T_prev_b2w=pose(j.T_prev_b2w),
        neigh_velocity=np.asarray(j.neigh_velocity), prev_timestamp=j.prev_timestamp,
        keyframe_levels=[dict(img=np.asarray(lv["img"]), grad=np.asarray(lv["grad"]),
                              kp_xy=np.asarray(lv["kp_xy"]), kp_z=np.asarray(lv["kp_z"]),
                              kp_mask=np.asarray(lv["kp_mask"]),
                              wincache=tuple(np.asarray(x) for x in lv["wincache"]))
                         for lv in j.keyframe_levels])


@pytest.fixture(scope="module")
def own_keyframes(scene):
    j, t = bootstrap(jax_config(), scene)
    state = jax_state(j)
    levels = (list(j.keyframe_levels), list(t.keyframe_levels))
    return levels, track(j, scene), track(t, scene), (j, t), state


def test_keyframe_processing_matches(own_keyframes):
    (jl, tl), *_ = own_keyframes
    assert len(jl) == len(tl) == 2
    for a, b in zip(jl, tl):
        for k in ("img", "grad", "kp_xy", "kp_z", "kp_mask"):
            np.testing.assert_allclose(npy(b[k]), np.asarray(a[k]), rtol=1e-15, atol=0,
                                       err_msg=k)
        np.testing.assert_allclose(npy(b["wincache"][0]), np.asarray(a["wincache"][0]),
                                   rtol=1e-15, atol=0)
        np.testing.assert_array_equal(npy(b["wincache"][1]), np.asarray(a["wincache"][1]))
        assert npy(b["kp_mask"]).sum() > 20


def test_track_frame_matches_jax(own_keyframes):
    _, pj, pt, (j, t), _ = own_keyframes
    np.testing.assert_allclose(pt, pj, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(npy(t.neigh_velocity), np.asarray(j.neigh_velocity),
                               atol=1e-6, rtol=0)
    assert [s.num_iterations for _, s in t.last_summaries] == [
        int(s.num_iterations) for _, s in j.last_summaries]


def test_track_frame_recovers_the_spline(own_keyframes, scene):
    _, _, pt, _, _ = own_keyframes
    assert ate(pt, scene) < 1e-3


def test_interop_carried_state(scene, own_keyframes):
    """The port tracks from the JAX tracker's keyframe state, handed over as
    numpy arrays."""
    _, pj, _, _, state = own_keyframes
    t = tbt.BlurAwareTracker(interop.config_from_fields(jax_config()), KVEC, (H, W),
                             device="cpu")
    interop.install_tracker_state(t, state)
    assert not t.is_first_frame
    np.testing.assert_allclose(track(t, scene), pj, atol=POSE_TOL, rtol=0)


def test_keyframe_switch(scene):
    """A 1.5 px flow bound switches the keyframe after the third frame; both
    trackers switch on the same frame and fold the same pose into the chain."""
    cfg = jax_config(keyframe_max_flow_mag1=1.5)
    j, t = bootstrap(cfg, scene)
    pj = track(j, scene, candidates=True)
    pt = track(t, scene, candidates=True)
    assert np.abs(np.asarray(j.T_keyframe.t)).max() > 0.01   # a switch happened
    np.testing.assert_allclose(pt, pj, atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(npy(t.T_keyframe.t), np.asarray(j.T_keyframe.t),
                               atol=POSE_TOL, rtol=0)
    np.testing.assert_allclose(npy(t.knots.t), np.asarray(j.knots.t), atol=POSE_TOL, rtol=0)
    assert ate(pt, scene) < 1e-3


def test_corrupted_frame_is_rejected(scene):
    """A NaN frame leaves a non-finite LM cost; auto_recover rejects it when
    the next frame resolves the decision, restores the pre-frame state, and
    tracking goes on from there in both trackers alike."""
    j, t = bootstrap(jax_config(), scene)
    frames = list(scene["blurred"])
    frames[1] = np.full((H, W), np.nan)
    pj, pt = track(j, scene, frames), track(t, scene, frames)
    assert [(e.cap_time, e.reason) for e in t.failure_log] == [
        (e.cap_time, e.reason) for e in j.failure_log] == [
        (scene["caps"][1], "non-finite LM cost (corrupted frame data)")]
    np.testing.assert_allclose(pt, pj, atol=POSE_TOL, rtol=0)


def test_float32_from_a_standing_start_follows_jax_op_by_op():
    """chip_smoke.py's bench scenario (VGA, 512 keypoints, 3 levels, 5
    virtual poses) from a standing start, on the options of the drift rule
    in tests/test_precision.py. Frame 2's finest level is a knife edge: its
    first step is rejected, and the level goes on only if that step lowered
    the cost by more than min_abs_cost_decrease. In float64 it does and the
    level converges onto the spline; in float32 it raises the cost, the
    level ends and the frame lands millimetres off. The JAX tracker, run op
    by op in float32 from the port's state after frame 1, ends the level
    the same way on the same pose: the early exit is the reference's, not
    the port's. This is why chip_smoke.py measures, and does not check, the
    drift rule on this scenario."""
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as smoke

    img, traj, frames = smoke.make_scenario("cpu", 2)
    (cap1, blur1), (cap2, blur2) = frames
    p64, _, it64 = smoke.run_tracker(smoke.bench_config("float64", **smoke.DRIFT_F64),
                                     "cpu", img, frames)

    cfg = smoke.bench_config("float32", **smoke.DRIFT_F32)
    t = tbt.BlurAwareTracker(cfg, smoke.KVEC, img.shape, device="cpu")
    t.track_frame(img, img, 0.0, smoke.EXPOSURE, np.full(img.shape, smoke.DEPTH))
    t.track_frame(None, blur1, cap1, smoke.EXPOSURE)
    t.flush()

    jcfg = jbt.TrackerConfig(**{
        f.name: getattr(cfg, f.name) for f in dataclasses.fields(jbt.TrackerConfig)
        if f.name != "detector"}, detector=DetectorOptions(**dataclasses.asdict(cfg.detector)))
    j = jbt.BlurAwareTracker(jcfg, smoke.KVEC, img.shape)
    f32 = lambda x: jnp.asarray(npy(x))  # noqa: E731
    j.is_first_frame = False
    j.knots = t.knots._replace(**{k: f32(v) for k, v in t.knots._asdict().items()})
    j.neigh_velocity = f32(t.neigh_velocity)
    j.T_prev_b2w = type(j.T_prev_b2w)(t=f32(t.T_prev_b2w.t), q=f32(t.T_prev_b2w.q))
    j.prev_timestamp = t.prev_timestamp
    j.keyframe_levels = [
        dict(img=f32(lv["img"]), grad=f32(lv["grad"]), kp_xy=f32(lv["kp_xy"]),
             kp_z=f32(lv["kp_z"]), kp_mask=f32(lv["kp_mask"]),
             wincache=tuple(f32(x) for x in lv["wincache"]))
        for lv in t.keyframe_levels]

    pt = t.track_frame(None, blur2, cap2, smoke.EXPOSURE)
    with jax.disable_jit():
        pj = j.track_frame(None, blur2, cap2, smoke.EXPOSURE)
    pt = np.concatenate([npy(pt.t), npy(pt.q)]).astype(np.float64)
    pj = np.concatenate([npy(pj.t), npy(pj.q)]).astype(np.float64)

    it32 = [s.num_iterations for _, s in t.last_summaries]
    assert it32 == [int(s.num_iterations) for _, s in j.last_summaries] == [1, 1, 1]
    assert it64[1][-1] > 1
    np.testing.assert_allclose(pt, pj, atol=1e-5, rtol=0)
    err32 = smoke.frame_errors(pt[None], traj, frames[1:])[0]
    err64 = smoke.frame_errors(p64[1:], traj, frames[1:])[0]
    assert err64 < 1e-5 < 1e-3 < err32


# ------------------------------------------------------------ the surface


def test_config_defaults_and_fields():
    jd, td = dataclasses.asdict(jbt.TrackerConfig()), dataclasses.asdict(tbt.TrackerConfig())
    assert td == jd
    cfg = jax_config(huber_a=7.0, precision="highest")
    assert dataclasses.asdict(interop.config_from_fields(cfg)) == dataclasses.asdict(cfg)
    assert dataclasses.asdict(tbt.TrackerConfig().lm_options()) == {
        f.name: getattr(jbt.TrackerConfig().lm_options(), f.name)
        for f in dataclasses.fields(tbt.LMOptions)}


@pytest.mark.parametrize("kw,call", [
    (dict(sampling="direct"), None),
    (dict(affine_brightness=True), None),
    (dict(shard_devices=2), None),
    (dict(), "backend"),
    (dict(), "track_frames"),
    (dict(), "track_frames_joint"),
])
def test_unported_entry_points_raise(kw, call):
    """Every entry point is ported: sampling="direct", affine_brightness,
    track_frames, track_frames_joint and a backend (the bootstrap keyframe
    reaches it) construct and run; shard_devices raises the reference's
    ValueErrors where a single process cannot shard (the counterpart of
    tests/test_parallel.py::test_shard_devices_validation; the sharded
    runs are in tests/test_torch_parallel.py)."""
    cfg = tbt.TrackerConfig(**kw)
    if call == "backend":
        from mba_vo_tpu_torch.backend.vo_backend import BackendConfig, VOBackend

        backend = VOBackend(BackendConfig(), KVEC, device="cpu")
        tracker = tbt.BlurAwareTracker(cfg, KVEC, (H, W), backend=backend, device="cpu")
        img = smooth_texture(H, W, seed=5)
        tracker.track_frame(img, img, 0.0, EXPOSURE, np.full((H, W), DEPTH))
        assert len(backend.keyframes) == 1 and tracker.backend is backend
        return
    if kw.get("shard_devices"):
        # the shard count must divide the keypoint slots ...
        with pytest.raises(ValueError, match="multiple of shard_devices"):
            tbt.BlurAwareTracker(dataclasses.replace(cfg, shard_devices=7), KVEC, (H, W),
                                 device="cpu")
        # ... and the ranks of a process group must be there to take them
        with pytest.raises(ValueError, match="shard_devices=2 but only 1 devices are visible"):
            tbt.BlurAwareTracker(cfg, KVEC, (H, W), device="cpu")
        return
    tracker = tbt.BlurAwareTracker(cfg, KVEC, (H, W), device="cpu")
    opts = tracker.cfg.lm_options()
    assert opts.sampling == kw.get("sampling", "windowed")
    assert opts.affine_brightness == kw.get("affine_brightness", False)
    if call is not None:
        img = smooth_texture(H, W, seed=5)
        poses = getattr(tracker, call)([img], [0.0], [EXPOSURE], sharp_imgs=[img],
                                       depth_maps=[np.full((H, W), DEPTH)])
        assert len(poses) == 1 and not tracker.is_first_frame
        np.testing.assert_array_equal(tracker.last_track_stats, [[0.0, 0.0]])


def test_unknown_sampling_is_refused():
    with pytest.raises(ValueError, match="unknown sampling"):
        tbt.BlurAwareTracker(tbt.TrackerConfig(sampling="nearest"), KVEC, (H, W), device="cpu")


def test_cuda_device_without_a_card_raises():
    """No silent move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbt.BlurAwareTracker(tbt.TrackerConfig(), KVEC, (H, W))


def test_depth_gather_is_clamped():
    """Keypoints past the edge of a smaller depth map read its last row or
    column, as JAX's gather does (torch indexing would raise on the CPU and
    read out of bounds on CUDA)."""
    img = smooth_texture(H, W, seed=3)
    depth = np.random.default_rng(1).uniform(1.0, 3.0, (H - 9, W - 13))
    cfg = jax_config()
    tcfg = interop.config_from_fields(cfg)
    want = jbt._process_keyframe_fused(
        jnp.asarray(img), jnp.asarray(depth), num_levels=2, det=cfg.detector,
        margin=cfg.keypoint_border_margin, min_depth=cfg.min_keypoint_depth,
        window=cfg.sampling_window, windowed=True)
    got = tbt.process_keyframe_levels(
        torch.tensor(img), torch.tensor(depth), num_levels=2, det=tcfg.detector,
        margin=tcfg.keypoint_border_margin, min_depth=tcfg.min_keypoint_depth,
        window=tcfg.sampling_window)
    beyond = 0
    for lv, (a, b) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(npy(b["kp_z"]), np.asarray(a[3]))
        np.testing.assert_array_equal(npy(b["kp_mask"]), np.asarray(a[4]))
        beyond += int((npy(b["kp_xy"])[:, 0] * 2 ** lv + 0.5 >= depth.shape[1]).sum())
    assert beyond > 0
