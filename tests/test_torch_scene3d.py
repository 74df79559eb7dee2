"""The port's data/scene3d.py against the JAX package, float64 on the CPU:
every function at 48 x 64 with 3 exposure samples to 1e-10 (images
relative to their grey level: a sphere's procedural albedo changes by 40 k
~ 8,600 grey levels a metre, so the last-bit difference of a ray's hit
point, 1e-13 m, reaches 9e-10 grey levels at 125); track_frame
over a ray-cast sequence of the non-planar scene from a moving state to
1e-8 against the JAX tracker; and the port alone on the clean scene and on
the last rung of the realism ladder (tests/test_scene3d.py) at that test's
bounds."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core import lie as jlie
from mba_vo_tpu.core.spline import make_knots as jmake
from mba_vo_tpu.data import scene3d as js
from mba_vo_tpu.tracker import blur_tracker as jbt
from mba_vo_tpu.tracker.detector import DetectorOptions as JDet
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.core.spline import spline_pose_at as tpose_at
from mba_vo_tpu_torch.data import scene3d as ts
from mba_vo_tpu_torch.tracker import blur_tracker as tbt

from torch_port_common import (
    EXPOSURE, FRAME_DT, VEL, bootstrap_pair, knots_arrays, knots_pair, npy, poses_array,
    random_quats, smooth_texture, t64,
)

TOL = 1e-10
SH, SW = 48, 64
SK = np.array([50.0, 50.0, (SW - 1) / 2, (SH - 1) / 2])
QID = np.array([0.0, 0.0, 0.0, 1.0])


def close(a, b, tol=TOL):
    np.testing.assert_allclose(npy(b), npy(a), atol=tol, rtol=0)


def close_image(a, b):
    np.testing.assert_allclose(npy(b), npy(a), atol=0, rtol=TOL)


def scenes(texture_seed=5, **kw):
    j = js.default_scene(smooth_texture(SH, SW, seed=texture_seed), dtype=jnp.float64, **kw)
    return j, interop.scene_from_fields(j)


def poses(n=4, seed=0):
    """[n, 3], [n, 4]: the identity, then small random motions."""
    rng = np.random.default_rng(seed)
    t = np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.05, (n - 1, 3))])
    q = np.concatenate([QID[None], random_quats(rng, n - 1, 0.05)])
    return t, q


def test_default_scene_matches():
    for kw in ({}, dict(depth=3.0, tilt_deg=-10.0, num_spheres=7, seed=2),
               dict(num_spheres=0)):
        j, t = scenes(**kw)
        for f in js.Scene3D._fields:
            close(getattr(j, f), getattr(t, f), 0.0)


def test_sphere_albedo():
    j, t = scenes()
    X = np.random.default_rng(1).normal(0, 1, (20, 3))
    for m in range(5):
        close_image(js._sphere_albedo(j, jnp.asarray(X), m), ts._sphere_albedo(t, t64(X), m))


@pytest.mark.parametrize("with_occluder", [False, True])
def test_render_scene_matches(with_occluder):
    """Image and depth from four poses, one by one and as one batch."""
    j, t = scenes()
    if with_occluder:
        j = js.with_occluder(j, [0.1, 0.05, 1.1], 0.14)
        t = ts.with_occluder(t, [0.1, 0.05, 1.1], 0.14)
        close(j.sphere_c, t.sphere_c, 0.0)
    pt, pq = poses()
    bi, bz = ts.render_scene(t, t64(pt), t64(pq), t64(SK), SH, SW)
    assert bi.shape == bz.shape == (4, SH, SW)
    for k in range(4):
        ij, zj = js.render_scene(j, jnp.asarray(pt[k]), jnp.asarray(pq[k]), jnp.asarray(SK),
                                 SH, SW)
        it, zt = ts.render_scene(t, t64(pt[k]), t64(pq[k]), t64(SK), SH, SW)
        close_image(ij, it)
        close(zj, zt)
        close(it, bi[k], 0.0)
        close(zt, bz[k], 0.0)
    # spheres are in view: depth spans the plane and the spheres
    z = npy(bz[0])
    assert (z.max() - z.min()) / z.mean() > 0.3


def test_render_tiles_the_texture_and_marks_misses():
    """Far off the texture's centre the plane is tiled by reflection (the
    texture coordinate's remainder takes the divisor's sign: jnp.mod, not
    fmod); a camera turned away from the plane hits nothing (depth 0)."""
    j, t = scenes(num_spheres=0)
    shift = np.array([-3.0, 2.0, 0.0])
    close_image(
        js.render_scene(j, jnp.asarray(shift), jnp.asarray(QID), jnp.asarray(SK), SH, SW)[0],
        ts.render_scene(t, t64(shift), t64(QID), t64(SK), SH, SW)[0])
    away = np.array([0.0, 1.0, 0.0, 0.0])          # 180 degrees about y
    zj = js.scene_depth_map(j, jnp.zeros(3), jnp.asarray(away), jnp.asarray(SK), SH, SW)
    zt = ts.scene_depth_map(t, t64(np.zeros(3)), t64(away), t64(SK), SH, SW)
    assert not npy(zt).any() and not np.asarray(zj).any()


def test_photometric_disturbance_and_degraded_depth():
    img = smooth_texture(SH, SW, seed=2)
    close_image(js.apply_photometric_disturbance(jnp.asarray(img), 1.12, 6.0, 0.15),
                ts.apply_photometric_disturbance(t64(img), 1.12, 6.0, 0.15))
    z = np.random.default_rng(3).uniform(0.5, 3.0, (SH, SW))
    for kw in ({}, dict(noise_sigma=0.005, seed=4)):
        np.testing.assert_array_equal(ts.degrade_depth(z, 5000.0, **kw),
                                      js.degrade_depth(z, 5000.0, **kw))


def test_blurred_image_scene():
    """Three exposure samples rendered as one batch and averaged."""
    j, t = scenes()
    jk, tk = knots_pair(knots_arrays(seed=3, num_knots=3, t0=0.0, dt=0.1))
    a = js.synthesize_blurred_image_scene(j, jk, 2, 0.12, 0.03, 3, jnp.asarray(SK), SH, SW)
    b = ts.synthesize_blurred_image_scene(t, tk, 2, 0.12, 0.03, 3, t64(SK), SH, SW)
    assert b.shape == (SH, SW)
    close_image(a, b)


# ---------------------------------------------------------------- tracking

def scene_sequence(n_frames, h, w, kvec, samples=5):
    """The default scene (texture seed 5) seen from a camera moving at VEL:
    the sharp keyframe, its exact depth, and n_frames blurred frames, all
    rendered by the JAX package in float64."""
    js_scene = js.default_scene(smooth_texture(h, w, seed=5), depth=2.0, dtype=jnp.float64)
    kt, kq = [np.zeros(3)], [QID]
    for _ in range(n_frames + 4):
        kt.append(kt[-1] + VEL[:3] * FRAME_DT)
        q = np.asarray(jlie.quat_multiply(jnp.asarray(kq[-1]),
                                          jlie.quat_exp(jnp.asarray(VEL[3:] * FRAME_DT))))
        kq.append(q / np.linalg.norm(q))
    traj = jmake(jnp.asarray(np.array(kt)), jnp.asarray(np.array(kq)), 0.0, FRAME_DT)
    K = jnp.asarray(kvec)
    img, z = js.render_scene(js_scene, jnp.zeros(3), jnp.asarray(QID), K, h, w)
    caps = [FRAME_DT * i for i in range(1, n_frames + 1)]
    return dict(
        img=np.asarray(img), depth0=np.asarray(z), traj=traj, caps=caps, hw=(h, w),
        kvec=np.asarray(kvec),
        blurred=[np.asarray(js.synthesize_blurred_image_scene(
            js_scene, traj, 2, c, EXPOSURE, samples, K, h, w)) for c in caps])


def test_track_frame_on_the_scene_matches_jax():
    """track_frame over three blurred frames of the non-planar scene, both
    trackers from the same moving state: poses to 1e-8."""
    seq = scene_sequence(3, 64, 80, np.array([60.0, 60.0, 39.5, 31.5]))
    cfg = jbt.TrackerConfig(
        num_pyramid_levels=2, num_virtual_poses=(3, 3), huber_a=10.0,
        max_chi_square_error=3.0, min_abs_cost_decrease=1e-6,
        keyframe_max_flow_mag0=1e9, keyframe_max_flow_mag1=1e9,
        detector=JDet(score_threshold=5.0, cell_h=8, cell_w=8, max_keypoints=96),
        dtype="float64")
    j, t = bootstrap_pair(cfg, seq)
    pj = [j.track_frame(None, b, c, EXPOSURE) for b, c in zip(seq["blurred"], seq["caps"])]
    pt = [t.track_frame(None, b, c, EXPOSURE) for b, c in zip(seq["blurred"], seq["caps"])]
    np.testing.assert_allclose(poses_array(pt), poses_array(pj), atol=1e-8, rtol=0)


# tests/test_scene3d.py's recipe: 128 x 160, fx 120, 4 frames, 3 levels
LH, LW = 128, 160
LK = np.array([120.0, 120.0, (LW - 1) / 2, (LH - 1) / 2])


def ladder_ate(scene_of_frame, depth_fn=None, img_fn=None, affine=False, num_frames=4):
    """tests/test_scene3d.py::TestRealismLadder._track on the port alone:
    the JAX test's world spline (tests/test_tracker.py) and the port's
    renderer and tracker."""
    from mba_vo_tpu.tracker.detector import DetectorOptions
    from test_tracker import world_spline

    jtraj = world_spline()
    traj = interop.knots_from_arrays(jtraj.t, jtraj.q, jtraj.t0, jtraj.dt)
    K = t64(LK)
    sharp0, z0 = ts.render_scene(scene_of_frame(0), t64(np.zeros(3)), t64(QID), K, LH, LW)
    z0 = z0.numpy()
    if depth_fn is not None:
        z0 = depth_fn(z0)
    if img_fn is not None:
        sharp0 = img_fn(0, sharp0)
    cfg = interop.config_from_fields(jbt.TrackerConfig(
        num_pyramid_levels=3, num_virtual_poses=(5, 5, 5), huber_a=10.0,
        max_chi_square_error=3.0, min_abs_cost_decrease=1e-6, keyframe_max_flow_mag0=1e9,
        keyframe_max_flow_mag1=1e9,
        detector=DetectorOptions(score_threshold=5.0, cell_h=12, cell_w=12, max_keypoints=256),
        dtype="float64", affine_brightness=affine))
    tracker = tbt.BlurAwareTracker(cfg, LK, (LH, LW), device="cpu")
    tracker.track_frame(sharp0.numpy(), sharp0.numpy(), 0.0, EXPOSURE, z0)
    errors = []
    for i in range(1, num_frames + 1):
        cap = i * FRAME_DT
        blurred = ts.synthesize_blurred_image_scene(scene_of_frame(i), traj, 2, cap, EXPOSURE,
                                                    5, K, LH, LW)
        if img_fn is not None:
            blurred = img_fn(i, blurred)
        est = tracker.track_frame(None, blurred.numpy(), cap, EXPOSURE)
        errors.append(float(torch.linalg.norm(est.t - tpose_at(traj, cap, 2).t)))
    return float(np.sqrt(np.mean(np.square(errors))))


@pytest.fixture(scope="module")
def ladder_scene():
    return ts.default_scene(smooth_texture(LH, LW, seed=5), depth=2.0, dtype=torch.float64)


def test_port_tracks_the_clean_scene(ladder_scene):
    """tests/test_scene3d.py::TestTrackerNonPlanar's bound: ATE < 1e-2 m."""
    ate = ladder_ate(lambda i: ladder_scene)
    print(f"non-planar scene ATE {ate:.3e} m")
    assert ate < 1e-2, ate


def test_port_holds_the_full_realism_ladder(ladder_scene):
    """Rung 4: depth quantised with 5 mm noise, gain / bias drift with
    vignetting under the affine residual, and a moving occluder: ATE < 3e-2 m."""
    def disturb(i, img):
        return ts.apply_photometric_disturbance(img, gain=1.0 + 0.04 * i, bias=2.0 * i,
                                                vignette=0.15)

    def scene_at(i):
        x = -0.35 * 2.0 / 2 + 0.1 * i * 2.0 / 2
        return ts.with_occluder(ladder_scene, [x, 0.05, 0.55 * 2.0], 0.07 * 2.0)

    ate = ladder_ate(scene_at, depth_fn=lambda z: ts.degrade_depth(z, 5000.0, noise_sigma=0.005),
                     img_fn=disturb, affine=True)
    print(f"ladder rung 4 ATE {ate:.3e} m")
    assert ate < 3e-2, ate
