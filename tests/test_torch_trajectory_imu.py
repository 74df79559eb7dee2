"""The port's models/trajectory.py, core/navstate.py, models/sensors.py and
the quaternion/pose helpers they use (core/lie.py quat_to_matrix,
quat_normalize, quat_boxplus; core/transform.py pose_apply,
pose_normalize, pose_rpy, pose_from_rpy) against the JAX package, float64
on the CPU. IMU synthesis nests two forward-mode derivatives through the
spline (torch.func.jvp in the port, jax.jvp in the reference): to 1e-10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core import lie as jlie
from mba_vo_tpu.core import navstate as jnav
from mba_vo_tpu.core import transform as jtf
from mba_vo_tpu.models import sensors as jsen
from mba_vo_tpu.models import trajectory as jtr
from mba_vo_tpu.tracker.detector import DetectorOptions as JDet
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.core import lie as tlie
from mba_vo_tpu_torch.core import navstate as tnav
from mba_vo_tpu_torch.core import transform as ttf
from mba_vo_tpu_torch.models import sensors as tsen
from mba_vo_tpu_torch.models import trajectory as ttr
from mba_vo_tpu_torch.tracker.detector import DetectorOptions as TDet

from torch_port_common import knots_pair, npy, random_quats, t64

TOL = 1e-12
IMU_TOL = 1e-10
RNG = np.random.default_rng(31)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(npy(b), npy(a), atol=tol, rtol=0)


# ---------------------------------------------------------- lie, transform


def test_quaternion_helpers():
    q = random_quats(RNG, 8, 1.0)
    close(jlie.quat_to_matrix(jnp.asarray(q)), tlie.quat_to_matrix(t64(q)))
    raw = RNG.normal(0, 1, (8, 4))
    close(jlie.quat_normalize(jnp.asarray(raw)), tlie.quat_normalize(t64(raw)))
    w = RNG.normal(0, 0.5, (8, 3))
    close(jlie.quat_boxplus(jnp.asarray(q), jnp.asarray(w)), tlie.quat_boxplus(t64(q), t64(w)))


def test_pose_helpers():
    t, q = RNG.normal(0, 1, (6, 3)), random_quats(RNG, 6, 0.8)
    jp, tp = jtf.Pose(jnp.asarray(t), jnp.asarray(q)), ttf.Pose(t64(t), t64(q))
    x = RNG.normal(0, 2, (6, 3))
    close(jtf.pose_apply(jp, jnp.asarray(x)), ttf.pose_apply(tp, t64(x)))
    raw = ttf.Pose(t64(t), t64(2.5 * q))
    close(jtf.pose_normalize(jtf.Pose(jnp.asarray(t), jnp.asarray(2.5 * q))).q,
          ttf.pose_normalize(raw).q)
    close(jtf.pose_rpy(jp), ttf.pose_rpy(tp))
    # gimbal lock: the pitch argument clipped at 1
    lock = np.array([[0.0, np.sqrt(0.5), 0.0, np.sqrt(0.5) + 1e-12]])
    close(jtf.pose_rpy(jtf.Pose(jnp.zeros((1, 3)), jnp.asarray(lock))),
          ttf.pose_rpy(ttf.Pose(t64(np.zeros((1, 3))), t64(lock))))
    r, p, y = RNG.uniform(-3, 3, (3, 5))
    a = jtf.pose_from_rpy(jnp.asarray(r), jnp.asarray(p), jnp.asarray(y), dtype=jnp.float64)
    b = ttf.pose_from_rpy(t64(r), t64(p), t64(y), dtype=torch.float64)
    close(a.q, b.q)
    close(a.t, b.t)
    a = jtf.pose_from_rpy(0.1, -0.2, 0.3, t=[1.0, 2.0, 3.0], dtype=jnp.float64)
    b = ttf.pose_from_rpy(0.1, -0.2, 0.3, t=[1.0, 2.0, 3.0], dtype=torch.float64)
    close(a.q, b.q)
    close(a.t, b.t)


# -------------------------------------------------------------- trajectory


def imu_params():
    j = jtr.ImuParams(gravity=jnp.float64(9.81), bias_gyro=jnp.asarray([-0.003, 0.004, 0.002]),
                      bias_acc=jnp.asarray([0.02, -0.01, 0.005]))
    return j, interop.imu_params_from_fields(j)


def imu_knots(seed=4):
    """tests/test_sensors_navstate.py's spline: 8 knots 0.25 s apart."""
    rng = np.random.default_rng(seed)
    dt = 0.25
    kt, kq = [np.zeros(3)], [np.array([0.0, 0.0, 0.0, 1.0])]
    for _ in range(7):
        kt.append(kt[-1] + np.array([0.05, -0.03, 0.02]) * dt + rng.normal(0, 1e-3, 3))
        q = np.asarray(jlie.quat_multiply(jnp.asarray(kq[-1]), jlie.quat_exp(
            jnp.asarray(np.array([0.04, 0.06, -0.05]) * dt))))
        kq.append(q / np.linalg.norm(q))
    return knots_pair((np.array(kt), np.array(kq), 0.0, dt))


def test_default_imu_params():
    j, t = jtr.default_imu_params(jnp.float64), ttr.default_imu_params(torch.float64)
    for a, b in zip(j, t):
        close(a, b, 0.0)


@pytest.mark.parametrize("degree", [2, 4])
def test_sample_pose_velocity(degree):
    jk, tk = imu_knots()
    for time in (0.3, 0.77, 1.2):
        (pj, vj, dqj), (pt, vt, dqt) = (jtr.sample_pose_velocity(jk, time, degree),
                                        ttr.sample_pose_velocity(tk, time, degree))
        close(pj.t, pt.t)
        close(pj.q, pt.q)
        close(vj, vt, IMU_TOL)
        close(dqj, dqt, IMU_TOL)


@pytest.mark.parametrize("degree", [2, 4])
def test_sample_imu_and_sequence(degree):
    """sample_imu at scalar times and sample_imu_sequence over a vector of
    times (one batched pass in the port, vmap in the reference)."""
    jk, tk = imu_knots()
    jp, tp = imu_params()
    times = np.linspace(0.26, 1.6, 23)
    js = jtr.sample_imu_sequence(jk, jnp.asarray(times), degree, jp)
    ts = ttr.sample_imu_sequence(tk, t64(times), degree, tp)
    close(js[0].t, ts[0].t)
    close(js[0].q, ts[0].q)
    for a, b in zip(js[1:], ts[1:]):
        assert b.shape == (23, 3)
        close(a, b, IMU_TOL)
    for k in (0, 11):
        j1, t1 = jtr.sample_imu(jk, times[k], degree, jp), ttr.sample_imu(tk, times[k], degree, tp)
        close(j1[0].q, t1[0].q)
        for a, b in zip(j1[1:], t1[1:]):
            close(a, b, IMU_TOL)
        for a, b in zip(t1[1:], ts[1:]):
            close(b[k], a, 1e-13)


# ---------------------------------------------------------------- navstate


def test_navstate_identity_and_retract():
    close(jnav.identity_navstate(jnp.float64).pose.q, tnav.identity_navstate(torch.float64).pose.q)
    j0 = jnav.NavState(
        pose=jtf.Pose(jnp.asarray(RNG.normal(0, 1, 3)), jnp.asarray(random_quats(RNG, 1)[0])),
        velocity=jnp.asarray(RNG.normal(0, 1, 3)), bias_acc=jnp.asarray(RNG.normal(0, 0.1, 3)),
        bias_gyro=jnp.asarray(RNG.normal(0, 0.1, 3)))
    t0 = interop.navstate_from_fields(j0)
    d = RNG.normal(0, 0.1, 15)
    a, b = jnav.navstate_retract(j0, jnp.asarray(d)), tnav.navstate_retract(t0, t64(d))
    for x, y in zip(jax.tree_util.tree_leaves(a), [b.pose.t, b.pose.q, *b[1:]]):
        close(x, y)
    acc, gyro, g = RNG.normal(0, 1, 3), RNG.normal(0, 0.3, 3), np.array([0.0, 0.0, -9.81])
    a = jnav.propagate_imu(j0, jnp.asarray(acc), jnp.asarray(gyro), 0.01, jnp.asarray(g))
    b = tnav.propagate_imu(t0, t64(acc), t64(gyro), 0.01, t64(g))
    for x, y in zip(jax.tree_util.tree_leaves(a), [b.pose.t, b.pose.q, *b[1:]]):
        close(x, y)


def test_propagation_reintegrates_the_spline_imu():
    """tests/test_sensors_navstate.py's recipe: integrate 800 midpoint IMU
    samples (1 kHz) of the degree-4 spline from 0.3 s; the port's state
    equals the reference's to 1e-10 and both stay within that test's
    bounds of the spline's own pose and velocity."""
    jk, tk = imu_knots()
    jp, tp = imu_params()
    g = np.array([0.0, 0.0, -9.81])
    t_start, h = 0.3, 1e-3
    times = np.arange(t_start, 1.1, h)
    _, _, jgyro, jacc = jtr.sample_imu_sequence(jk, jnp.asarray(times + 0.5 * h), 4, jp)
    _, _, tgyro, tacc = ttr.sample_imu_sequence(tk, t64(times + 0.5 * h), 4, tp)
    close(jgyro, tgyro, IMU_TOL)
    close(jacc, tacc, IMU_TOL)
    p0, v0, _ = jtr.sample_pose_velocity(jk, t_start, 4)
    js = jnav.NavState(pose=p0, velocity=v0, bias_acc=jp.bias_acc, bias_gyro=jp.bias_gyro)
    ts = interop.navstate_from_fields(js)
    step = jax.jit(lambda s, a, w: jnav.propagate_imu(s, a, w, h, jnp.asarray(g)))
    for k in range(len(times)):
        js = step(js, jacc[k], jgyro[k])
        ts = tnav.propagate_imu(ts, tacc[k], tgyro[k], h, t64(g))
    close(js.pose.t, ts.pose.t, IMU_TOL)
    close(js.velocity, ts.velocity, IMU_TOL)
    close(js.pose.q, ts.pose.q, IMU_TOL)
    p_end, v_end, _ = ttr.sample_pose_velocity(tk, float(times[-1]) + h, 4)
    assert float(torch.linalg.norm(ts.pose.t - p_end.t)) < 2e-3
    assert float(torch.linalg.norm(ts.velocity - v_end)) < 5e-3
    dq = tlie.quat_multiply(tlie.quat_conjugate(ts.pose.q), p_end.q)
    assert float(torch.linalg.norm(tlie.quat_log(dq))) < 1e-3


# ----------------------------------------------------------------- sensors


def test_sensor_system_registry_and_extrinsics():
    def poses(t, w):
        return (jtf.Pose(jnp.asarray(t, jnp.float64), jlie.quat_exp(jnp.asarray(w, jnp.float64))),
                ttf.Pose(t64(t), tlie.quat_exp(t64(w))))

    ja, ta = poses([0.1, -0.05, 0.02], [0.03, -0.01, 0.2])
    jb, tb = poses([-0.2, 0.06, 0.01], [-0.1, 0.04, -0.05])
    js, ts = jsen.SensorSystem(), tsen.SensorSystem()
    js.add_camera(0, jnp.zeros(4), ja, name="cam0")
    js.add_camera(1, jnp.zeros(4), jb, name="cam1")
    ts.add_camera(0, torch.zeros(4), ta, name="cam0")
    ts.add_camera(1, torch.zeros(4), tb, name="cam1")
    for s in (js, ts):
        s.add_paired_camera(0, 1)
    js.add_imu(0, jtr.default_imu_params(), name="imu0")
    ts.add_imu(0, ttr.default_imu_params(), name="imu0")
    assert ts.get_dev_id("cam1") == js.get_dev_id("cam1") == 1
    assert ts.get_dev_id("imu0") == 0
    assert ts.get_paired_cameras() == js.get_paired_cameras() == {0: 1}
    assert len(ts.get_cameras()) == 2
    assert float(ts.get_imu(0).params.gravity) == pytest.approx(9.81)
    ra, rb = js.relative_extrinsics(0, 1), ts.relative_extrinsics(0, 1)
    close(ra.t, rb.t)
    close(ra.q, rb.q)
    with pytest.raises(ValueError):
        ts.add_camera(0, torch.zeros(4))
    with pytest.raises(ValueError):
        ts.add_paired_camera(0, 7)
    with pytest.raises(ValueError):
        ts.add_imu(0, ttr.default_imu_params())
    assert ts.get_camera(1).T_b2s is tb
    default = tsen.SensorSystem()
    default.add_camera(3, torch.zeros(4))
    assert default.get_camera(3).T_b2s.t.dtype == torch.float32


def test_multi_camera_frame_pyramids_and_detection():
    rng = np.random.default_rng(0)
    jf, tf = jsen.MultiCameraFrame(1.5, 0.02), tsen.MultiCameraFrame(1.5, 0.02)
    opts = dict(score_threshold=1.0, cell_h=16, cell_w=16, max_keypoints=32)
    for cid in (0, 1):
        img = rng.uniform(0, 255, (64, 80))
        jf.add_image(cid, img)
        tf.add_image(cid, img)
    assert tf.camera_ids() == jf.camera_ids() == [0, 1]
    with pytest.raises(ValueError, match="compute_pyramid first"):
        tf.compute_grad_pyramid(0)
    for cid in (0, 1):
        for a, b in zip(jf.compute_pyramid(cid, 3), tf.compute_pyramid(cid, 3)):
            close(a, b)
        for a, b in zip(jf.compute_grad_pyramid(cid), tf.compute_grad_pyramid(cid)):
            close(a, b)
        assert tf.pyramid(cid)[1].shape == (32, 40)
        assert tf.grad_pyramid(cid)[0].shape == (64, 80, 2)
        for level in (0, 1):
            ja = jf.detect_features(cid, level, JDet(**opts))
            ta = tf.detect_features(cid, level, TDet(**opts))
            for a, b in zip(ja, ta):
                close(a, b)
            assert float(ta[2].sum()) > 0
    assert not torch.equal(tf.image(0), tf.image(1))
