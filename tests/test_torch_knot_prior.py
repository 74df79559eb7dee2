"""The knot prior's plain version (K9's, ``solver/lm.py``'s
``_prior_terms`` in closed form) against the JAX package on the CPU.

JAX linearises the prior residual through the retraction with
``jax.linearize`` and a ``vmap`` over the 6K seeds; the port writes its
Jacobian out. Both are held together in float64 (1e-12 of each output's
largest magnitude) and float32 (1e-5) on knots made with numpy from a
seed: moving windows, a window from rest (identical knots), relative
rotations of 1e-9 rad (the Taylor branches of the log and of Jr^-1), past
pi/2 and near pi on either side. Then the closed form's structure exactly,
the dispatcher on CPU tensors, the LM recording its calls, and the
harness's old path (``torch.func.jacfwd``) against the closed form.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core.spline import make_knots as jmake
from mba_vo_tpu.solver import lm as jlm
from mba_vo_tpu.tracker.patterns import PATTERNS
from mba_vo_tpu_torch.core.spline import make_knots as tmake
from mba_vo_tpu_torch.experiments import residual_kernels as rk
from mba_vo_tpu_torch.solver import lm as tlm

from torch_port_common import knots_arrays, knots_pair, level_arrays, level_pair, npy

BOUND = {np.float64: 1e-12, np.float32: 1e-5}
CASES = ("moving", "rest", "taylor", "past_half_pi", "near_pi")


def _qexp(w):
    th = np.linalg.norm(w)
    if th == 0.0:
        return np.array([0.0, 0.0, 0.0, 1.0])
    return np.concatenate([np.sin(th / 2) * w / th, [np.cos(th / 2)]])


def _qmul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array([aw * bx + ax * bw + ay * bz - az * by, aw * by + ay * bw + az * bx - ax * bz,
                     aw * bz + az * bw + ax * by - ay * bx, aw * bw - ax * bx - ay * by - az * bz])


def prior_knots(K, case, seed=0):
    """(t [K, 3], q [K, 4]) in float64: each knot's rotation the last one's
    times exp of a random axis at the case's angle ("moving": up to 0.5 rad;
    "rest": every knot the identity at one translation; "taylor": 1e-9 rad;
    "past_half_pi": 2 rad; "near_pi": pi - 1e-3 and pi + 1e-3 in turn, the
    latter's log past pi)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0)
    if case == "rest":
        return np.tile(t[:1], (K, 1)), np.tile([[0.0, 0.0, 0.0, 1.0]], (K, 1))
    q0 = rng.normal(0, 1, 4)
    q = [q0 / np.linalg.norm(q0)]
    for k in range(K - 1):
        axis = rng.normal(0, 1, 3)
        axis /= np.linalg.norm(axis)
        angle = {"moving": rng.uniform(0, 0.5), "taylor": 1e-9, "past_half_pi": 2.0,
                 "near_pi": (np.pi - 1e-3, np.pi + 1e-3)[k % 2]}[case]
        q.append(_qmul(q[-1], _qexp(angle * axis)))
    return t, np.array(q)


_JAX_PRIOR = jax.jit(jlm._prior_terms, static_argnums=(1,))


def both(K, case, weight, dtype):
    t, q = (a.astype(dtype) for a in prior_knots(K, case, seed=K))
    ref = _JAX_PRIOR(jmake(jnp.asarray(t), jnp.asarray(q), 0.0, 0.1), weight)
    got = tlm._prior_terms(tmake(torch.tensor(t), torch.tensor(q), 0.0, 0.1), weight)
    return got, ref


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("weight", [1.0, 10.0])
@pytest.mark.parametrize("K", [3, 4, 7, 11])
def test_closed_form_matches_jax(K, weight, case, dtype):
    """cost, g and H within 1e-12 (float64) / 1e-5 (float32) of each
    output's largest magnitude (an output that is 0 in one is 0 in the
    other), in the knots' dtype."""
    got, ref = both(K, case, weight, dtype)
    for name, a, b in zip(("cost", "g", "H"), got, ref):
        b = np.asarray(b)
        assert a.dtype == {np.float64: torch.float64, np.float32: torch.float32}[dtype]
        assert tuple(a.shape) == b.shape == {"cost": (), "g": (6 * K,), "H": (6 * K, 6 * K)}[name]
        err, scale = np.abs(npy(a).astype(np.float64) - b).max(), np.abs(b).max()
        assert err <= BOUND[dtype] * scale, (name, err, scale)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("K", [3, 7, 11])
def test_closed_form_structure(K, case):
    """Exactly: the t-omega blocks are 0, the t-t block is weight (D2^T D2
    x I3) with D2 the [1, -2, 1] second difference, H is symmetric, and a
    window from rest has no cost and no gradient."""
    weight = 10.0
    t, q = prior_knots(K, case)
    cost, g, H = tlm._prior_terms(tmake(torch.tensor(t), torch.tensor(q), 0.0, 0.1), weight)
    Hn = npy(H)
    D2 = np.zeros((K - 2, K))
    for j in range(K - 2):
        D2[j, j:j + 3] = [1.0, -2.0, 1.0]
    assert np.array_equal(Hn[:3 * K, :3 * K], weight * np.kron(D2.T @ D2, np.eye(3)))
    assert not Hn[:3 * K, 3 * K:].any() and not Hn[3 * K:, :3 * K].any()
    assert np.array_equal(Hn, Hn.T)
    # the omega block's band: knots more than 2 apart share no prior block
    blocks = np.abs(Hn[3 * K:, 3 * K:]).reshape(K, 3, K, 3).max(axis=(1, 3))
    a, b = np.indices((K, K))
    assert not blocks[np.abs(a - b) > 2].any()
    if case == "rest":
        assert float(cost) == 0.0 and not npy(g).any()


@pytest.mark.parametrize("theta", [0.0, 1e-9, 5e-3, 0.3, 2.0, np.pi - 1e-3, np.pi + 0.5])
def test_right_jacobian_inverse(theta):
    """Jr^-1(w) inverts SO(3)'s right Jacobian Jr(w) = I - (1 - cos th) /
    th^2 [w]x + (th - sin th) / th^3 [w]x^2, on both sides of the Taylor
    threshold, in float64."""
    axis = np.array([0.3, -0.8, 0.52])
    w = theta * axis / np.linalg.norm(axis)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-3:    # the coefficients' Taylor forms, where the closed ones cancel
        a, b = 0.5 - theta ** 2 / 24, 1 / 6 - theta ** 2 / 120
    else:
        a, b = (1 - np.cos(theta)) / theta ** 2, (theta - np.sin(theta)) / theta ** 3
    Jr = np.eye(3) - a * W + b * W @ W
    inv = npy(tlm._right_jacobian_inverse(torch.tensor(w)))
    np.testing.assert_allclose(inv @ Jr, np.eye(3), atol=1e-13, rtol=0)


def test_lane_sum_is_the_sum():
    """The cost's lane order sums every entry, whatever the length."""
    rng = np.random.default_rng(0)
    for n in (1, 5, 31, 32, 33, 64, 100):
        v = rng.uniform(0, 1, n)
        assert float(tlm._lane_sum(torch.tensor(v))) == pytest.approx(v.sum(), rel=1e-14)


def test_solver_uses_no_forward_mode():
    """solver/lm.py imports nothing of torch.func and calls no jacfwd: the
    prior is the closed form."""
    source = inspect.getsource(tlm)
    tree = ast.parse(source)
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             for a in n.names} | {n.module or "" for n in ast.walk(tree)
                                  if isinstance(n, ast.ImportFrom)}
    assert "torch.func" not in names and "jacfwd" not in names
    assert "torch.func" not in source and "jacfwd" not in source


def test_dispatcher_on_cpu_tensors():
    """On CPU tensors the dispatcher gives the plain version's bits; the
    prior is off at weight 0 and at 2 knots."""
    t, q = (torch.tensor(a) for a in prior_knots(7, "moving"))
    got = tlm.knot_prior(t, q, 3.0)
    want = tlm._prior_terms(tmake(t, q, 0.0, 0.1), 3.0)
    assert rk.same_bits(got, want)
    knots = tmake(t, q, 0.0, 0.1)
    assert tlm._prior(knots, tlm.LMOptions(knot_prior_weight=0.0)) is None
    assert tlm._prior(knots._replace(t=t[:2], q=q[:2]),
                      tlm.LMOptions(knot_prior_weight=1.0)) is None
    assert rk.same_bits(tlm._prior(knots, tlm.LMOptions(knot_prior_weight=3.0)), want)


@pytest.mark.parametrize("case", ["moving", "taylor", "near_pi"])
def test_old_path_matches_the_closed_form(case):
    """The harness's old path (torch.func.jacfwd through the retraction,
    then J^T p and J^T J) against the closed form, 1e-12 of each output's
    magnitude in float64."""
    t, q = (torch.tensor(a) for a in prior_knots(7, case, seed=3))
    for a, b in zip(rk.knot_prior_jacfwd(t, q, 10.0), tlm.knot_prior_plain(t, q, 10.0)):
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max())


def test_lm_records_one_prior_a_start_and_an_iteration():
    """On a joint level (F = 4, K = 7, degree 4) the LM evaluates the prior
    once at the level's start and once an iteration, through the dispatcher
    that record_lm_calls records (its calls held to the plain version), and
    the plain seams (K6-K9) take the same steps."""
    t, q, t0, dt = knots_arrays(seed=31, num_knots=7, t0=0.1 - 0.015 - 0.1, dt=0.1)
    _, kt = knots_pair((t + np.random.default_rng(2).normal(0, 2e-3, t.shape), q, t0, dt))
    _, data = level_pair(level_arrays(seed=9, n_kp=24, dead=2, border=False, frames=4),
                         PATTERNS["dso8"]())
    opts = tlm.LMOptions(sampling="windowed", huber_a=10.0, knot_prior_weight=1.0,
                         retry_rejected_steps=True, min_abs_cost_decrease=1e-6,
                         max_iterations=4)
    with rk.record_lm_calls() as calls:
        k1, s1 = tlm.optimize_level(kt, data, 5, 4, opts)
    prior = calls[rk.PRIOR]
    assert s1.num_iterations >= 2 and len(prior) == 1 + s1.num_iterations
    assert all(len(c.args) == 3 and c.args[2] == 1.0 and c.D == 42 for c in prior)
    for c in prior:
        assert rk.hold_lm(c)["bits"] == 1.0
    saved = {k: getattr(tlm, k) for k in rk.LM_STAGES}
    try:
        for k in rk.LM_STAGES:
            setattr(tlm, k, rk.lm_plain_fn(k))
        k2, s2 = tlm.optimize_level(kt, data, 5, 4, opts)
    finally:
        for k, fn in saved.items():
            setattr(tlm, k, fn)
    assert s2.num_iterations == s1.num_iterations
    assert torch.equal(k1.t, k2.t) and torch.equal(k1.q, k2.q)
