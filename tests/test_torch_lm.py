"""The port's solver/lm.py against the JAX package on the CPU in float64.

JAX runs the LM as one ``lax.while_loop``; the port runs a host loop over
the same branches. On one pyramid level both must take the same steps: the
same iteration count, knots to 1e-9 and the same final cost.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core.spline import make_knots as jmake
from mba_vo_tpu.data.synthetic import synthesize_blurred_image
from mba_vo_tpu.solver import lm as jlm
from mba_vo_tpu.tracker.patterns import PATTERNS
from mba_vo_tpu_torch.solver import lm as tlm

from torch_port_common import (
    DEPTH, EXPOSURE, H, KVEC, W, knots_arrays, knots_pair, level_arrays, level_pair, npy, t64,
)

PATTERN = PATTERNS["dso8"]()


def to_port(opts: jlm.LMOptions) -> tlm.LMOptions:
    return tlm.LMOptions(**{f.name: getattr(opts, f.name)
                            for f in dataclasses.fields(tlm.LMOptions)})


@pytest.fixture(scope="module")
def level():
    """One level whose current frame is rendered by the forward model from a
    known spline; the LM starts from shifted knots. (Keypoints whose warps
    leave the image would stall the first step: the tracker culls them with
    keypoint_border_margin.)"""
    # one knot segment spanning exactly the exposure: every knot is observed
    t_true, q_true, t0, dt = knots_arrays(seed=21, t0=0.1 - EXPOSURE / 2, dt=EXPOSURE)
    a = level_arrays(seed=9, n_kp=40, dead=4, border=False)
    # a low-curvature image, where the Lucas-Kanade gradient is close to the
    # interpolant's derivative and Gauss-Newton steps are accepted
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    a["img_ref"] = (128.0 + 60.0 * np.sin(xs / 7.0) * np.cos(ys / 9.0)
                    + 40.0 * np.sin(xs / 13.0 + ys / 11.0))
    a["cur_imgs"] = np.asarray(synthesize_blurred_image(
        jnp.asarray(a["img_ref"]), jmake(jnp.asarray(t_true), jnp.asarray(q_true), t0, dt),
        2, float(a["cap_times"][0]), EXPOSURE, 5, DEPTH, jnp.asarray(KVEC)))[None]
    a["cur_imgs"] = a["cur_imgs"] + np.random.default_rng(23).normal(0, 1.0, a["cur_imgs"].shape)
    a["kp_z"] = np.full_like(a["kp_z"], DEPTH)
    # start off by a shift of the whole exposure, a well-observed direction
    init = (t_true + np.array([4e-3, -3e-3, 5e-3]), q_true, t0, dt)
    return knots_pair(init), level_pair(a, PATTERN)


def run_both(level, **overrides):
    (kj, kt), (dj, dt) = level
    jo = jlm.LMOptions(**{**dict(sampling="windowed", huber_a=10.0,
                                 min_abs_cost_decrease=1e-6), **overrides})
    k1, s1 = jlm.optimize_level_jit(kj, dj, 5, 2, jo)
    k2, s2 = tlm.optimize_level(kt, dt, 5, 2, to_port(jo))
    return (k1, s1), (k2, s2)


@pytest.mark.parametrize("overrides", [
    {},
    {"compensated_sum": True},
    {"hoist_layout": True},
    {"max_chi_square_error": 1.0},      # outliers are flagged along the way
])
def test_optimize_level_matches(level, overrides):
    (k1, s1), (k2, s2) = run_both(level, **overrides)
    assert s2.num_iterations == int(s1.num_iterations) >= 2
    np.testing.assert_allclose(npy(k2.t), np.asarray(k1.t), atol=1e-9, rtol=0)
    np.testing.assert_allclose(npy(k2.q), np.asarray(k1.q), atol=1e-9, rtol=0)
    np.testing.assert_allclose(float(s2.final_cost), float(s1.final_cost), rtol=1e-9)
    np.testing.assert_array_equal(npy(s2.outlier_mask), np.asarray(s1.outlier_mask))
    np.testing.assert_allclose(npy(s2.patch_costs), np.asarray(s1.patch_costs),
                               atol=1e-9, rtol=0)


def test_optimize_level_lowers_the_cost(level):
    (_, kt), (_, dt) = level
    _, (_, s2) = run_both(level)
    ones = torch.ones(dt.kp_mask.shape[0], dtype=torch.float64)
    start = tlm.evaluate(kt, dt, 5, 2, 10.0, ones, sampling="windowed").cost
    # the frame carries unit-variance noise: the Huber cost floor is ~0.5
    assert 0.4 < float(s2.final_cost) < float(start) - 0.1


@pytest.fixture(scope="module")
def stalled_level(level):
    """The same level with two keypoints on the image border: their warps
    leave the image, and the first Gauss-Newton step raises the cost."""
    knots, (dj, _) = level
    a = level_arrays(seed=9, n_kp=40, dead=4, border=True)
    a.update(img_ref=np.asarray(dj.img_ref), cur_imgs=np.asarray(dj.cur_imgs),
             kp_z=np.asarray(dj.kp_z))
    return knots, level_pair(a, PATTERN)


def test_rejected_step_ends_the_level(stalled_level):
    """A valid step that raises the cost is rejected and ends the level after
    one iteration with the knots unchanged (the reference's
    terminate-on-reject); retry_rejected_steps shrinks the radius and goes on
    instead."""
    (_, kt), _ = stalled_level
    (k1, s1), (k2, s2) = run_both(stalled_level)
    assert s2.num_iterations == int(s1.num_iterations) == 1
    np.testing.assert_array_equal(npy(k2.t), npy(kt.t))
    (k1, s1), (k2, s2) = run_both(stalled_level, retry_rejected_steps=True, max_iterations=5)
    assert s2.num_iterations == int(s1.num_iterations) == 5
    np.testing.assert_allclose(npy(k2.t), np.asarray(k1.t), atol=1e-9, rtol=0)
    np.testing.assert_allclose(float(s2.final_cost), float(s1.final_cost), rtol=1e-9)


def test_repeated_rejections_accumulate_damping(level):
    """Rejected steps that still lower the cost keep the level going; each
    one carries the damped H, so the damping compounds and the steps shrink
    identically in both implementations."""
    (_, kt), _ = level
    (k1, s1), (k2, s2) = run_both(level, min_step_quality=1e9, max_iterations=6)
    assert s2.num_iterations == int(s1.num_iterations) == 6
    np.testing.assert_array_equal(npy(k2.t), npy(kt.t))
    np.testing.assert_allclose(float(s2.final_cost), float(s1.final_cost), rtol=1e-12)


def test_layout_hoist_is_an_option_not_the_environment(level, monkeypatch):
    """JAX's MBA_VO_NO_LAYOUT_HOIST=1 switches the hoist off at trace time;
    in the port that is hoist_layout=False, and the port reads no
    environment."""
    (kj, kt), (dj, dt) = level
    (k_hoisted, _), _ = run_both(level, hoist_layout=True)   # traced without the variable
    monkeypatch.setenv("MBA_VO_NO_LAYOUT_HOIST", "1")
    jo = jlm.LMOptions(sampling="windowed", huber_a=10.0, min_abs_cost_decrease=1e-6,
                       hoist_layout=True)
    # a new function object, so JAX traces it afresh and reads the variable
    k_env, _ = jax.jit(lambda k, d: jlm.optimize_level(k, d, 5, 2, jo))(kj, dj)
    k_off, _ = tlm.optimize_level(kt, dt, 5, 2, to_port(dataclasses.replace(
        jo, hoist_layout=False)))
    k_on, _ = tlm.optimize_level(kt, dt, 5, 2, to_port(jo))
    np.testing.assert_allclose(npy(k_off.t), np.asarray(k_env.t), atol=1e-9, rtol=0)
    np.testing.assert_allclose(npy(k_on.t), np.asarray(k_hoisted.t), atol=1e-9, rtol=0)
    assert np.abs(npy(k_on.t) - npy(k_off.t)).max() > 1e-9


# ------------------------------------------------------------ pieces


def test_non_positive_definite_step_is_invalid():
    """torch.linalg.cholesky raises where jnp.linalg.cholesky returns NaN;
    the port factors with cholesky_ex and hands back a NaN step, so the
    invalid-step branch fires: radius down, damping doubled, the damped H
    carried, the knots and the decrease left alone."""
    rng = np.random.default_rng(0)
    A = rng.normal(0, 1, (12, 12))
    H = -(A @ A.T) - np.eye(12)
    g = rng.normal(0, 1, 12)
    sj = jlm._solve(jnp.asarray(H), jnp.asarray(g), "cholesky")
    st = tlm._solve(t64(H), t64(g), "cholesky")
    assert np.isnan(np.asarray(sj)).all() and torch.isnan(st).all()
    Hpd = A @ A.T + np.eye(12)
    np.testing.assert_allclose(
        npy(tlm._solve(t64(Hpd), t64(g), "cholesky")),
        np.asarray(jlm._solve(jnp.asarray(Hpd), jnp.asarray(g), "cholesky")), atol=1e-10)

    kt = knots_pair(knots_arrays(seed=1))[1]
    cost = t64(5.0)
    s = tlm._LMState(knots=kt, H=t64(H), g=t64(g), cost=cost, radius=t64(1e4),
                     decrease_factor=t64(2.0), ev=tlm._evaluator_reset(cost),
                     outlier_mask=torch.ones(3, dtype=torch.float64), num_iterations=0,
                     abs_cost_decrease=t64(1e10), patch_costs=torch.zeros(1, 3))
    lv = tlm._Level(data=None, num_vir=5, degree=2, opts=tlm.LMOptions(), cache=None,
                    layout=None)
    s1 = tlm.lm_iteration(s, lv)   # data=None: an evaluation would fail
    assert s1.num_iterations == 1 and s1.knots is kt
    assert float(s1.radius) == 5e3 and float(s1.decrease_factor) == 4.0
    np.testing.assert_array_equal(npy(s1.H), H + np.diag(np.diag(H)) / 1e4)
    assert float(s1.abs_cost_decrease) == 1e10


def test_detect_outliers():
    rng = np.random.default_rng(4)
    pc = rng.uniform(0.5, 1.5, (2, 30))
    pc[:, 3] = 40.0          # an outlier
    pc[:, 5] = 0.0           # below 1e-8: out of the statistics
    pc[:, 7] = 1e-9
    mask = np.ones(30)
    mask[-4:] = 0.0          # padded slots
    pc[:, -1] = 90.0         # ... are never flagged
    mj, nj = jlm.detect_outliers(jnp.asarray(pc), jnp.asarray(mask), 3.0)
    mt, nt = tlm.detect_outliers(t64(pc), t64(mask), 3.0)
    np.testing.assert_array_equal(npy(mt), np.asarray(mj))
    assert int(nt) == int(nj) >= 1 and npy(mt)[3] == 0.0 and npy(mt)[-1] == 1.0


def test_step_evaluator_sequence():
    """Ceres' non-monotonic step evaluator over a run of accepted costs."""
    rng = np.random.default_rng(6)
    ej, et = jlm._evaluator_reset(jnp.asarray(10.0)), tlm._evaluator_reset(t64(10.0))
    for _ in range(12):
        cost, mcc = rng.uniform(5.0, 12.0), rng.uniform(0.1, 2.0)
        qj = jlm._step_quality(ej, jnp.asarray(cost), jnp.asarray(mcc))
        qt = tlm._step_quality(et, t64(cost), t64(mcc))
        assert float(qt) == pytest.approx(float(qj), rel=1e-14)
        ej = jlm._step_accepted(ej, jnp.asarray(cost), jnp.asarray(mcc), 3)
        et = tlm._step_accepted(et, t64(cost), t64(mcc), 3)
        for a, b in zip(ej, et):
            assert float(b) == pytest.approx(float(a), rel=1e-14)


def test_knot_prior_terms():
    kj, kt = knots_pair(knots_arrays(seed=3, num_knots=5))
    prior = jax.jit(jlm._prior_terms, static_argnums=(1,))
    for a, b in zip(prior(kj, 10.0), tlm._prior_terms(kt, 10.0)):
        np.testing.assert_allclose(npy(b), np.asarray(a), atol=1e-10, rtol=1e-10)


def test_affine_brightness_is_not_ported(level):
    """affine_brightness is ported: under a gain and a bias on the current
    frame both packages take the same steps, on either sampling path, and
    the plain residual cannot reach that cost."""
    (kj, kt), (dj, dt) = level
    dj2 = dj._replace(cur_imgs=1.2 * dj.cur_imgs + 9.0)
    dt2 = dt._replace(cur_imgs=1.2 * dt.cur_imgs + 9.0)
    for sampling in ("windowed", "direct"):
        jo = jlm.LMOptions(sampling=sampling, huber_a=10.0, min_abs_cost_decrease=1e-6,
                           affine_brightness=True)
        k1, s1 = jlm.optimize_level_jit(kj, dj2, 5, 2, jo)
        k2, s2 = tlm.optimize_level(kt, dt2, 5, 2, to_port(jo))
        assert s2.num_iterations == int(s1.num_iterations) >= 2
        np.testing.assert_allclose(npy(k2.t), np.asarray(k1.t), atol=1e-9, rtol=0)
        np.testing.assert_allclose(npy(k2.q), np.asarray(k1.q), atol=1e-9, rtol=0)
        np.testing.assert_allclose(float(s2.final_cost), float(s1.final_cost), rtol=1e-9)
        _, s3 = tlm.optimize_level(kt, dt2, 5, 2, to_port(dataclasses.replace(
            jo, affine_brightness=False)))
        assert float(s2.final_cost) < 0.1 * float(s3.final_cost)


def test_direct_sampling_matches(level):
    (k1, s1), (k2, s2) = run_both(level, sampling="direct")
    assert s2.num_iterations == int(s1.num_iterations) >= 2
    np.testing.assert_allclose(npy(k2.t), np.asarray(k1.t), atol=1e-9, rtol=0)
    np.testing.assert_allclose(npy(k2.q), np.asarray(k1.q), atol=1e-9, rtol=0)
    np.testing.assert_allclose(float(s2.final_cost), float(s1.final_cost), rtol=1e-9)


@pytest.fixture(scope="module")
def joint_level():
    """The joint window's problem at chunk 4, degree 4: four frames rendered
    from a 7-knot cubic spline, started from perturbed knots."""
    t_true, q_true, t0, dt = knots_arrays(seed=31, num_knots=7, t0=0.1 - EXPOSURE / 2 - 0.1,
                                          dt=0.1)
    a = level_arrays(seed=9, n_kp=32, dead=3, border=False, frames=4)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    a["img_ref"] = (128.0 + 60.0 * np.sin(xs / 7.0) * np.cos(ys / 9.0)
                    + 40.0 * np.sin(xs / 13.0 + ys / 11.0))
    truth = jmake(jnp.asarray(t_true), jnp.asarray(q_true), t0, dt)
    a["cur_imgs"] = np.stack([np.asarray(synthesize_blurred_image(
        jnp.asarray(a["img_ref"]), truth, 4, float(c), EXPOSURE, 5, DEPTH, jnp.asarray(KVEC)))
        for c in a["cap_times"]])
    a["kp_z"] = np.full_like(a["kp_z"], DEPTH)
    rng = np.random.default_rng(32)
    init = (t_true + rng.normal(0, 2e-3, t_true.shape), q_true, t0, dt)
    return knots_pair(init), level_pair(a, PATTERN)


def test_joint_problem_with_retry_and_knot_prior(joint_level):
    """The joint path's LM options on a joint problem (F = 4, K = 7, degree
    4): retry_rejected_steps, the knot prior (K > 2) and hoist_layout=False.
    Both packages take the same steps, and LMSummary.patch_costs comes back
    [F, N] (the joint tracker sums it per frame)."""
    (kj, kt), (dj, dt) = joint_level
    jo = jlm.LMOptions(sampling="windowed", huber_a=10.0, min_abs_cost_decrease=1e-6,
                       retry_rejected_steps=True, knot_prior_weight=1.0, hoist_layout=False,
                       max_iterations=8)
    k1, s1 = jlm.optimize_level_jit(kj, dj, 5, 4, jo)
    k2, s2 = tlm.optimize_level(kt, dt, 5, 4, to_port(jo))
    assert s2.num_iterations == int(s1.num_iterations) >= 3
    np.testing.assert_allclose(npy(k2.t), np.asarray(k1.t), atol=1e-9, rtol=0)
    np.testing.assert_allclose(npy(k2.q), np.asarray(k1.q), atol=1e-9, rtol=0)
    np.testing.assert_allclose(float(s2.final_cost), float(s1.final_cost), rtol=1e-9)
    assert tuple(s2.patch_costs.shape) == (4, 32) == s1.patch_costs.shape
    np.testing.assert_allclose(npy(s2.patch_costs), np.asarray(s1.patch_costs),
                               atol=1e-9, rtol=0)
    start = tlm.evaluate(kt, dt, 5, 4, 10.0, torch.ones(32, dtype=torch.float64),
                         sampling="windowed").cost
    assert float(s2.final_cost) < float(start)
    # without the prior the same options take another path
    k3, _ = tlm.optimize_level(kt, dt, 5, 4, to_port(dataclasses.replace(
        jo, knot_prior_weight=0.0)))
    assert np.abs(npy(k3.t) - npy(k2.t)).max() > 1e-9
