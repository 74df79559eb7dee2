"""The port's core/lie.py, core/transform.py and core/spline.py against the
JAX package, float64 on the CPU, at 1e-12 (both sides compute the same
closed forms; the only differences are last-ulp rounding of transcendentals)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core import lie as jlie
from mba_vo_tpu.core import spline as jsp
from mba_vo_tpu.core import transform as jtf
from mba_vo_tpu_torch.core import lie as tlie
from mba_vo_tpu_torch.core import spline as tsp
from mba_vo_tpu_torch.core import transform as ttf

from torch_port_common import knots_arrays, knots_pair, npy, random_quats, t64

TOL = 1e-12
RNG = np.random.default_rng(17)


def close(a, b, tol=TOL):
    np.testing.assert_allclose(npy(b), npy(a), atol=tol, rtol=0)


def _omegas():
    """Rotation vectors from zero through the Taylor switch (|w|^2 = 1e-20)
    to large angles."""
    big = RNG.normal(0, 1.0, (6, 3))
    small = RNG.normal(0, 1.0, (4, 3)) * np.array([[1e-13], [1e-11], [1e-9], [1e-6]])
    return np.concatenate([np.zeros((1, 3)), small, big])


# --------------------------------------------------------------------- lie


@pytest.mark.parametrize("name", ["quat_multiply", "quat_rotate"])
def test_binary_quaternion_ops(name):
    q = random_quats(RNG, 8, 1.0)
    other = random_quats(RNG, 8, 1.0) if name == "quat_multiply" else RNG.normal(0, 3, (8, 3))
    close(getattr(jlie, name)(jnp.asarray(q), jnp.asarray(other)),
          getattr(tlie, name)(t64(q), t64(other)))


@pytest.mark.parametrize("name", ["quat_conjugate", "quat_log", "so3_hat"])
def test_unary_quaternion_ops(name):
    x = random_quats(RNG, 8, 1.0)
    if name == "so3_hat":
        x = x[:, :3]
    close(getattr(jlie, name)(jnp.asarray(x)), getattr(tlie, name)(t64(x)))


def test_quat_exp_and_log_across_the_small_angle_switch():
    w = _omegas()
    close(jlie.quat_exp(jnp.asarray(w)), tlie.quat_exp(t64(w)))
    q = np.asarray(jlie.quat_exp(jnp.asarray(w)))
    close(jlie.quat_log(jnp.asarray(q)), tlie.quat_log(t64(q)))


def test_small_angle_threshold_depends_on_dtype():
    assert tlie._small_threshold(torch.float64) == jlie._small_threshold(jnp.float64) == 1e-20
    assert tlie._small_threshold(torch.float32) == jlie._small_threshold(jnp.float32) == 1e-10
    # at |w|^2 = 1e-12 float32 takes the Taylor branch and float64 does not
    w = np.array([[1e-6, 0.0, 0.0]])
    for dt_j, dt_t in ((jnp.float32, torch.float32), (jnp.float64, torch.float64)):
        np.testing.assert_allclose(
            npy(tlie.quat_log(tlie.quat_exp(torch.as_tensor(w, dtype=dt_t)))),
            np.asarray(jlie.quat_log(jlie.quat_exp(jnp.asarray(w, dt_j)))),
            rtol=1e-6)


@pytest.mark.parametrize("name", ["se3_exp", "pose_exp"])
def test_se3_exp(name):
    tang = np.concatenate([RNG.normal(0, 1, (11, 3)), _omegas()], axis=1)
    if name == "se3_exp":
        (tj, qj), (tt, qt) = jlie.se3_exp(jnp.asarray(tang)), tlie.se3_exp(t64(tang))
    else:
        (tj, qj), (tt, qt) = jtf.pose_exp(jnp.asarray(tang)), ttf.pose_exp(t64(tang))
    close(tj, tt)
    close(qj, qt)


def test_se3_log():
    t = RNG.normal(0, 1, (8, 3))
    q = random_quats(RNG, 8, 0.5)
    close(jlie.se3_log(jnp.asarray(t), jnp.asarray(q)), tlie.se3_log(t64(t), t64(q)))
    close(jtf.pose_log(jtf.Pose(jnp.asarray(t), jnp.asarray(q))),
          ttf.pose_log(ttf.Pose(t64(t), t64(q))))


# --------------------------------------------------------------- transform


def _pose_pair(n, seed):
    rng = np.random.default_rng(seed)
    t, q = rng.normal(0, 1, (n, 3)), random_quats(rng, n, 1.0)
    return jtf.Pose(jnp.asarray(t), jnp.asarray(q)), ttf.Pose(t64(t), t64(q))


def test_pose_compose_and_inverse():
    (aj, at), (bj, bt) = _pose_pair(6, 1), _pose_pair(6, 2)
    for pj, pt in ((jtf.pose_compose(aj, bj), ttf.pose_compose(at, bt)),
                   (jtf.pose_inverse(aj), ttf.pose_inverse(at))):
        close(pj.t, pt.t)
        close(pj.q, pt.q)


def test_pose_identity():
    pj = jtf.pose_identity(jnp.float64, (2, 3))
    pt = ttf.pose_identity(torch.float64, (2, 3))
    assert tuple(pt.t.shape) == (2, 3, 3) and tuple(pt.q.shape) == (2, 3, 4)
    close(pj.t, pt.t, 0)
    close(pj.q, pt.q, 0)


# ------------------------------------------------------------------ spline


@pytest.mark.parametrize("degree,num_knots", [(2, 2), (2, 5), (4, 4), (4, 6)])
def test_spline_pose_at_times(degree, num_knots):
    kj, kt = knots_pair(knots_arrays(seed=degree + num_knots, num_knots=num_knots,
                                     t0=0.2, dt=0.05))
    # times before the window, inside it, on knot boundaries and past its end
    span = 0.05 * (num_knots - degree + 1)
    times = np.concatenate([[0.1, 0.2, 0.25], np.linspace(0.2, 0.2 + span, 9),
                            [0.2 + span + 0.07]])
    pj = jsp.spline_pose_at_times(kj, jnp.asarray(times), degree)
    pt = tsp.spline_pose_at_times(kt, t64(times), degree)
    close(pj.t, pt.t)
    close(pj.q, pt.q)
    sj, st = jsp.spline_pose_at(kj, 0.23, degree), tsp.spline_pose_at(kt, 0.23, degree)
    close(sj.t, st.t)
    close(sj.q, st.q)


def test_segment_index_is_clamped():
    """Times outside the knot window clamp to its first or last segment, as
    the JAX gather does, instead of indexing past the knots."""
    times = np.array([-5.0, 0.0, 0.3, 0.49, 0.5, 9.0])
    for degree, K in ((2, 5), (4, 5)):
        ij, uj = jsp.spline_segment_start_and_u(jnp.asarray(times), 0.0, 0.1, K, degree)
        it, ut = tsp.spline_segment_start_and_u(t64(times), t64(0.0), t64(0.1), K, degree)
        np.testing.assert_array_equal(npy(it), np.asarray(ij))
        assert npy(it).min() == 0 and npy(it).max() == K - degree
        close(uj, ut)


@pytest.mark.parametrize("degree", [2, 4])
def test_spline_retract_flat_layout(degree):
    """A flat [6K] step is [all translations; all rotation tangents]."""
    K = degree + 1
    kj, kt = knots_pair(knots_arrays(seed=3, num_knots=K))
    step = RNG.normal(0, 0.05, 6 * K)
    rj, rt = jsp.spline_retract_flat(kj, jnp.asarray(step)), tsp.spline_retract_flat(kt, t64(step))
    close(rj.t, rt.t)
    close(rj.q, rt.q)
    close(rt.t - kt.t, step[: 3 * K].reshape(K, 3))


def test_spline_transforms():
    kj, kt = knots_pair(knots_arrays(seed=5, num_knots=3))
    dj, dt_ = _pose_pair(1, 9)
    dj, dt_ = jtf.Pose(dj.t[0], dj.q[0]), ttf.Pose(dt_.t[0], dt_.q[0])
    for aj, at in ((jsp.spline_transform_by_right(kj, dj),
                    tsp.spline_transform_by_right(kt, dt_)),
                   (jsp.spline_transform_to(kj, 0.11, dj, 2),
                    tsp.spline_transform_to(kt, 0.11, dt_, 2))):
        close(aj.t, at.t)
        close(aj.q, at.q)


def test_identity_and_make_knots():
    kj = jsp.identity_knots(3, t0=0.5, dt=0.25, dtype=jnp.float64)
    kt = tsp.identity_knots(3, t0=0.5, dt=0.25, dtype=torch.float64)
    for f in ("t", "q", "t0", "dt"):
        close(getattr(kj, f), getattr(kt, f), 0)
    assert kt.num_knots == 3
    mk = tsp.make_knots(t64(np.zeros((2, 3))), np.array([[0, 0, 0, 1.0]] * 2), 0.1, 0.2)
    assert all(x.dtype == torch.float64 for x in mk)


@pytest.mark.parametrize("num_vir", [1, 2, 5])
def test_virtual_pose_times(num_vir):
    """Includes V = 1, where the 1e-8 guard in the divisor makes the single
    sample the start of the exposure."""
    got = tsp.virtual_pose_times(t64(0.3), 0.04, num_vir)
    want = jsp.virtual_pose_times(jnp.asarray(0.3), 0.04, num_vir)
    close(want, got, 1e-15)
    if num_vir == 1:
        assert float(got[0]) == pytest.approx(0.28)
    # batched over frames, as sample_virtual_poses uses it
    caps, exps = np.array([0.1, 0.2]), np.array([0.03, 0.05])
    got = tsp.virtual_pose_times(t64(caps), t64(exps), num_vir)
    for f in range(2):
        close(jsp.virtual_pose_times(jnp.asarray(caps[f]), exps[f], num_vir), got[f], 1e-15)


# ------------------------------------------------ the joint window's knot ops


def _same_knots(kj, kt, tol=TOL):
    assert kt.num_knots == kj.num_knots
    for name in ("t", "q", "t0", "dt"):
        close(getattr(kj, name), getattr(kt, name), tol)


@pytest.mark.parametrize("name", ["insert_control_knot", "slide_control_window"])
def test_knot_window_ops_with_a_new_knot(name):
    kj, kt = knots_pair(knots_arrays(seed=11, num_knots=5))
    t_new, q_new = RNG.normal(0, 0.01, 3), random_quats(RNG, 1, 0.01)[0]
    aj = getattr(jsp, name)(kj, jnp.asarray(t_new), jnp.asarray(q_new))
    at = getattr(tsp, name)(kt, t64(t_new), t64(q_new))
    _same_knots(aj, at)
    assert at.num_knots == (6 if name == "insert_control_knot" else 5)
    close(at.t[-1], t_new)


def test_pop_front_and_extrapolate_knot():
    kj, kt = knots_pair(knots_arrays(seed=12, num_knots=5))
    _same_knots(jsp.pop_front_control_knot(kj), tsp.pop_front_control_knot(kt))
    assert float(tsp.pop_front_control_knot(kt).t0) == pytest.approx(0.185)
    pj, pt = jsp.extrapolate_knot(kj), tsp.extrapolate_knot(kt)
    close(pj.t, pt.t)
    close(pj.q, pt.q)
    # constant velocity: the new knot repeats the last relative transform
    slid = tsp.slide_control_window(kt, pt.t, pt.q)
    rel = lambda k, i: ttf.pose_compose(  # noqa: E731
        ttf.pose_inverse(ttf.Pose(k.t[i], k.q[i])), ttf.Pose(k.t[i + 1], k.q[i + 1]))
    close(rel(slid, 3).t, rel(kt, 3).t)
    close(rel(slid, 3).q, rel(kt, 3).q)


def test_spline_transform_by_left():
    kj, kt = knots_pair(knots_arrays(seed=13, num_knots=4))
    dj, dt_ = _pose_pair(1, 14)
    aj = jsp.spline_transform_by(kj, jtf.Pose(dj.t[0], dj.q[0]))
    at = tsp.spline_transform_by(kt, ttf.Pose(dt_.t[0], dt_.q[0]))
    _same_knots(aj, at)


def test_degree_four_window_of_seven_knots():
    """The joint window at chunk 4, degree 4: values across all four
    segments, the clamped ends included, and the [F, V, 7, 42] pose
    Jacobian of four frames."""
    from mba_vo_tpu.ops import residual as jres
    from mba_vo_tpu_torch.ops import residual as tres
    import jax

    kj, kt = knots_pair(knots_arrays(seed=15, num_knots=7, t0=0.085, dt=0.1))
    times = np.linspace(0.05, 0.55, 23)
    pj = jsp.spline_pose_at_times(kj, jnp.asarray(times), 4)
    pt = tsp.spline_pose_at_times(kt, t64(times), 4)
    close(pj.t, pt.t)
    close(pj.q, pt.q)
    caps, exps = 0.1 + 0.1 * np.arange(4), np.full(4, 0.03)
    Jj = jax.jit(jres.pose_jacobians, static_argnums=(3, 4))(
        kj, jnp.asarray(caps), jnp.asarray(exps), 5, 4)
    Jt = tres.pose_jacobians(kt, t64(caps), t64(exps), 5, 4)
    assert tuple(Jt.shape) == (4, 5, 7, 42)
    close(Jj, Jt)
    assert np.abs(npy(Jt)).max() > 0.1
