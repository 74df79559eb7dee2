"""The LM iteration's stages (the plain versions of K6-K8 in
mba_vo_tpu_torch/solver/lm.py) and the branch-free level loop against the
JAX package on the CPU in float64.

Each plain stage is held to the JAX function it restates to 1e-12 relative
(flags and masks equal); the branch-free ``optimize_level`` to
``jlm.optimize_level_jit`` on levels that force each branch of JAX's body
(iteration counts equal, knots and final cost to 1e-9, masks equal); and
the loop reads the device once an iteration. All inputs are numpy from a
seed.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core.spline import make_knots as jmake
from mba_vo_tpu.core.spline import spline_retract_flat as jretract
from mba_vo_tpu.data.synthetic import synthesize_blurred_image
from mba_vo_tpu.ops.residual import assemble as jassemble
from mba_vo_tpu.solver import lm as jlm
from mba_vo_tpu.tracker.patterns import PATTERNS
from mba_vo_tpu_torch.experiments import residual_kernels as rk
from mba_vo_tpu_torch.ops.residual import inverse_residual_count, normal_equations_plain
from mba_vo_tpu_torch.solver import lm as tlm

from torch_port_common import (
    DEPTH, EXPOSURE, H, KVEC, W, knots_arrays, knots_pair, level_arrays, level_pair, npy, t64,
)

PATTERN = PATTERNS["dso8"]()
REL = 1e-12


def close(got, want, rel=REL):
    got, want = npy(got) if isinstance(got, torch.Tensor) else got, np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(np.abs(want).max(), 1e-300))


def scalars(cost=5.0, radius=1e4, decrease=2.0, acd=1e10, **entries):
    sc = torch.zeros(tlm.S_SIZE, dtype=torch.float64)
    sc[tlm.S_COST:tlm.S_CAND + 1] = cost
    sc[tlm.S_RADIUS], sc[tlm.S_DECREASE], sc[tlm.S_ACD] = radius, decrease, acd
    for name, v in entries.items():
        sc[getattr(tlm, f"S_{name.upper()}")] = v
    return sc


def spd(D, seed, scale=1.0):
    A = np.random.default_rng(seed).normal(0, 1, (D, D))
    return scale * (A @ A.T / D + np.eye(D))


# ------------------------------------------------------------ the stages


@pytest.mark.parametrize("K", [2, 7])
@pytest.mark.parametrize("case", ["valid", "not positive definite"])
def test_step_stage_matches_jax(K, case):
    """lm_step_plain: the damping, ``_solve``'s Cholesky step, the model cost
    change and the invalid flag as JAX's body computes them, and the
    candidate as JAX's ``spline_retract_flat`` (the knots when invalid)."""
    D = 6 * K
    rng = np.random.default_rng(K)
    Hm = spd(D, K, 1e3) * (-1 if case != "valid" else 1)
    g = rng.normal(0, 1, D)
    kj, kt = knots_pair(knots_arrays(seed=K, num_knots=K))
    H1, step, ct, cq, sc = tlm.lm_step_plain(t64(Hm), t64(g), scalars(radius=37.0), kt.t, kt.q)
    H1j = jnp.asarray(Hm) + jnp.diag(jnp.diag(jnp.asarray(Hm))) / 37.0
    sj = jlm._solve(H1j, jnp.asarray(g), "cholesky")
    mccj = -(jnp.asarray(g) @ sj + 0.5 * sj @ (H1j @ sj))
    invalid = bool((mccj < 0) | ~jnp.all(jnp.isfinite(sj)))
    close(H1, H1j)
    assert float(sc[tlm.S_INVALID]) == float(invalid) == float(case != "valid")
    if invalid:
        assert torch.isnan(step).all() and np.isnan(np.asarray(sj)).all()
        assert torch.equal(ct, kt.t) and torch.equal(cq, kt.q)
        return
    close(step, sj)
    close(sc[tlm.S_MCC], mccj)
    cand = jretract(kj, sj)
    close(ct, cand.t)
    close(cq, cand.q)


def test_step_stage_solvers():
    """``lu`` and ``svd`` keep their eager solve in the step stage; an
    unknown kind raises there and in optimize_level."""
    Hm, g = spd(12, 3), np.random.default_rng(3).normal(0, 1, 12)
    _, kt = knots_pair(knots_arrays(seed=3))
    for kind in ("lu", "svd"):
        _, step, *_ = tlm.lm_step(t64(Hm), t64(g), scalars(), kt.t, kt.q, kind)
        H1 = Hm + np.diag(np.diag(Hm)) / 1e4
        close(step, jlm._solve(jnp.asarray(H1), jnp.asarray(g), kind), 1e-10)
    with pytest.raises(ValueError, match="unknown solver"):
        tlm.lm_step(t64(Hm), t64(g), scalars(), kt.t, kt.q, "qr")


@pytest.mark.parametrize("F,N", [(1, 40), (4, 32)])
@pytest.mark.parametrize("prior", [False, True])
def test_decide_stage_matches_jax(F, N, prior):
    """lm_decide_plain: assemble's scaling of the raw cost, ``_step_quality``,
    success, the cost decrease and ``detect_outliers`` on the candidate's
    scaled patch costs, as JAX computes them; mu and sigma as numpy."""
    rng = np.random.default_rng(F * N)
    P = PATTERN.shape[0]
    patch = rng.uniform(0.5, 1.5, (F, N))
    patch[:, 3] = 50.0
    patch[:, 5] = 0.0
    kp_mask = np.ones(N)
    kp_mask[-4:] = 0.0
    old = np.ones(N)
    old[7] = 0.0
    kp_w = kp_mask * old
    inv_n = 1.0 / max(kp_w.sum() * F * P, 1.0)
    pc = 0.02 if prior else None
    ev = jlm._EvaluatorState(*(jnp.asarray(v) for v in (4.0, 5.0, 5.5, 4.5, 0.2, 0.1, 1)))
    for raw in (4.8 / inv_n, 5.2 / inv_n, 4.999 / inv_n):
        sc = scalars(min=4.0, cur=5.0, ref=5.5, cand=4.5, acc_ref=0.2, acc_cand=0.1,
                     nonmono=1.0, mcc=0.3)
        out, mask, w = tlm.lm_decide_plain(t64(raw), t64(patch), t64(kp_w), t64(kp_mask), sc,
                                           P, tlm.LMOptions(),
                                           None if pc is None else t64(pc))
        cand = raw * inv_n + (pc or 0.0)
        q = jlm._step_quality(ev, jnp.asarray(cand), jnp.asarray(0.3))
        close(out[tlm.S_CAND_COST], cand)
        close(out[tlm.S_QUALITY], q)
        assert float(out[tlm.S_SUCCESS]) == float((q > 0.5) & (cand < 5.0))
        close(out[tlm.S_ACD_NEW], 5.0 - cand)
        mj, _ = jlm.detect_outliers(jnp.asarray(patch * inv_n), jnp.asarray(kp_mask), 3.0)
        np.testing.assert_array_equal(npy(mask), np.asarray(mj))
        np.testing.assert_array_equal(npy(w), kp_mask * np.asarray(mj))
        c = (patch * inv_n).sum(0)
        live = (c >= 1e-8) & (kp_mask > 0)
        close(out[tlm.S_MU], c[live].mean())
        close(out[tlm.S_SIGMA], c[live].std())
        assert npy(mask)[3] == 0.0 and npy(mask)[-1] == 1.0


@pytest.mark.parametrize("branch", ["accepted", "rejected", "invalid"])
@pytest.mark.parametrize("retry", [False, True])
def test_commit_stage_matches_jax(branch, retry):
    """lm_commit_plain: assemble's scaling of K3's raw sums under the new
    mask (against JAX's ``assemble`` of the same r and J), the knot prior
    added, the radius rules, ``_step_accepted``, the acd rule and the
    continue flag, for each branch of JAX's body."""
    K, F = 2, 1
    D = 6 * K
    rng = np.random.default_rng(11)
    a = level_arrays(seed=9, n_kp=24, dead=3)
    dj, dt = level_pair(a, PATTERN)
    N, P = 24, PATTERN.shape[0]
    r = rng.normal(0, 15.0, (F, N, P))
    J = rng.normal(0, 3.0, (F, N, P, D))
    new_mask = np.ones(N)
    new_mask[4] = 0.0
    ev_f = jassemble(jnp.asarray(r), jnp.asarray(J), dj, 10.0, jnp.asarray(new_mask))
    kw = dt.kp_mask * t64(new_mask)
    cost, patch, g_raw, H_raw = normal_equations_plain(t64(r), t64(J), kw, 10.0)
    prior = (t64(0.03), t64(rng.normal(0, 0.01, D)), t64(spd(D, 5, 0.01)))
    kj, kt = knots_pair(knots_arrays(seed=2))
    Hm, g = spd(D, 6), rng.normal(0, 1, D)
    sc = scalars(cost=5.0, min=4.0, cur=5.0, ref=5.5, cand=4.5, acc_ref=0.2, acc_cand=0.1,
                 nonmono=4.0, mcc=0.7, quality=0.8, acd_new=0.9, acd=2.5,
                 invalid=float(branch == "invalid"), success=float(branch == "accepted"))
    s = tlm.LMState(kt.t, kt.q, t64(Hm), t64(g), sc, torch.ones(N, dtype=torch.float64),
                    dt.kp_mask.clone(), torch.zeros(F, N, dtype=torch.float64))
    H1 = t64(Hm * 1.01)
    ct, cq = kt.t + 1e-3, kt.q
    opts = tlm.LMOptions(retry_rejected_steps=retry)
    out = tlm.lm_commit_plain(s, H1, ct, cq, cost, g_raw, H_raw, patch, t64(new_mask), kw, P,
                              opts, True, prior)
    o = out.scalars
    if branch == "accepted":
        cost_f = float(ev_f.cost) + 0.03
        close(out.H, np.asarray(ev_f.hessian) + npy(prior[2]))
        close(out.g, np.asarray(ev_f.gradient) + npy(prior[1]))
        close(o[tlm.S_COST], cost_f)
        close(out.patch_costs, ev_f.patch_costs)
        radius = np.clip(1e4 / max(1 / 3, 1 - (2 * 0.8 - 1) ** 3), 10.0, 1e32)
        close(o[tlm.S_RADIUS], radius)
        assert float(o[tlm.S_DECREASE]) == 2.0
        ev = jlm._EvaluatorState(*(jnp.asarray(v) for v in (4.0, 5.0, 5.5, 4.5, 0.2, 0.1, 4)))
        evj = jlm._step_accepted(ev, jnp.asarray(cost_f), jnp.asarray(0.7), 5)
        for i, v in zip((tlm.S_MIN, tlm.S_CUR, tlm.S_REF, tlm.S_CAND, tlm.S_ACC_REF,
                         tlm.S_ACC_CAND, tlm.S_NONMONO), evj):
            close(o[i], v)
        assert torch.equal(out.t, ct) and torch.equal(out.mask, t64(new_mask))
        assert float(o[tlm.S_ACD]) == 0.9
    else:
        assert torch.equal(out.H, H1) and torch.equal(out.g, s.g) and torch.equal(out.t, kt.t)
        close(o[tlm.S_RADIUS], 1e4 / 2.0)
        assert float(o[tlm.S_DECREASE]) == 4.0 and float(o[tlm.S_COST]) == 5.0
        kept = branch == "invalid" or retry
        assert float(o[tlm.S_ACD]) == (2.5 if kept else 0.9)
        assert torch.equal(out.mask, s.mask) and torch.equal(out.kp_w, s.kp_w)
    assert float(o[tlm.S_CONTINUE]) == float(float(o[tlm.S_ACD]) >= 1e-3)
    last = tlm.lm_commit_plain(s, H1, ct, cq, cost, g_raw, H_raw, patch, t64(new_mask), kw, P,
                               opts, False, prior)
    assert float(last.scalars[tlm.S_CONTINUE]) == 0.0


def test_assemble_scaling_is_shared():
    """assemble's scale is inverse_residual_count: 1 / max(sum(w) F P, 1)."""
    w = t64([1.0, 0.0, 1.0, 1.0])
    assert float(inverse_residual_count(w, 2, 8)) == 1.0 / 48.0
    assert float(inverse_residual_count(w * 0.0, 2, 8)) == 1.0


# ------------------------------------------------------------ whole levels


def _level(num_knots=2, border=False, seed=9):
    """tests/test_torch_lm.py's level: one knot segment spanning the
    exposure, the frame rendered from a known spline, the LM started off by
    a shift; extra knots past the segment are observed by nothing."""
    t_true, q_true, t0, dt = knots_arrays(seed=21, t0=0.1 - EXPOSURE / 2, dt=EXPOSURE)
    a = level_arrays(seed=seed, n_kp=40, dead=4, border=border)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    a["img_ref"] = (128.0 + 60.0 * np.sin(xs / 7.0) * np.cos(ys / 9.0)
                    + 40.0 * np.sin(xs / 13.0 + ys / 11.0))
    a["cur_imgs"] = np.asarray(synthesize_blurred_image(
        jnp.asarray(a["img_ref"]), jmake(jnp.asarray(t_true), jnp.asarray(q_true), t0, dt),
        2, float(a["cap_times"][0]), EXPOSURE, 5, DEPTH, jnp.asarray(KVEC)))[None]
    a["cur_imgs"] = a["cur_imgs"] + np.random.default_rng(23).normal(0, 1.0, a["cur_imgs"].shape)
    a["kp_z"] = np.full_like(a["kp_z"], DEPTH)
    t = t_true + np.array([4e-3, -3e-3, 5e-3])
    q = q_true
    if num_knots > 2:
        extra = num_knots - 2
        t = np.concatenate([t, t[-1:] + 1e-3 * np.arange(1, extra + 1)[:, None]])
        q = np.concatenate([q, np.repeat(q[-1:], extra, 0)])
    return knots_pair((t, q, t0, dt)), level_pair(a, PATTERN)


@pytest.fixture(scope="module")
def level():
    return _level()


@pytest.fixture(scope="module")
def stalled_level():
    return _level(border=True)


@pytest.fixture(scope="module")
def unobserved_level():
    return _level(num_knots=3)


def run_both(lev, **overrides):
    (kj, kt), (dj, dt) = lev
    jo = jlm.LMOptions(**{**dict(sampling="windowed", huber_a=10.0,
                                 min_abs_cost_decrease=1e-6), **overrides})
    k1, s1 = jlm.optimize_level_jit(kj, dj, 5, 2, jo)
    po = tlm.LMOptions(**{f.name: getattr(jo, f.name) for f in dataclasses.fields(tlm.LMOptions)})
    k2, s2 = tlm.optimize_level(kt, dt, 5, 2, po)
    assert s2.num_iterations == int(s1.num_iterations)
    np.testing.assert_allclose(npy(k2.t), np.asarray(k1.t), atol=1e-9, rtol=0)
    np.testing.assert_allclose(npy(k2.q), np.asarray(k1.q), atol=1e-9, rtol=0)
    np.testing.assert_allclose(float(s2.final_cost), float(s1.final_cost), rtol=1e-9)
    np.testing.assert_array_equal(npy(s2.outlier_mask), np.asarray(s1.outlier_mask))
    np.testing.assert_allclose(npy(s2.patch_costs), np.asarray(s1.patch_costs),
                               atol=1e-9, rtol=0)
    return (k1, s1), (k2, s2)


def test_invalid_steps_match(unobserved_level):
    """A knot no exposure reaches leaves H singular: every damped H fails
    the factorisation, every step is invalid, and both loops shrink the
    radius until max_iterations with the knots where they started."""
    (_, kt), _ = unobserved_level
    _, (k2, s2) = run_both(unobserved_level, max_iterations=4)
    assert s2.num_iterations == 4
    assert torch.equal(k2.t, kt.t)


@pytest.mark.parametrize("branch", ["accepted", "rejected", "invalid"])
def test_commit_bound_counts_its_branch(branch):
    """K8's bound (``residual_kernels._lm_bound``) counts the bytes the
    call's branch moves, each state array once as written: always the
    scalars (read and written), the new keypoint weights (read) and H
    (written from one D x D input); on success also the candidate's knots,
    sums, mask and prior (read) and the rest of the state (written)."""
    K, F, N = 3, 2, 40
    D = 6 * K
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64)   # noqa: E731
    sc = scalars(invalid=float(branch == "invalid"), success=float(branch != "rejected"))
    s = tlm.LMState(z(K, 3), z(K, 4), z(D, D), z(D), sc, z(N), z(N), z(F, N))
    prior = (z(), z(D), z(D, D))
    args = (s, z(D, D), z(K, 3), z(K, 4), z(), z(D), z(D, D), z(F, N), z(N), z(N), 8,
            tlm.LMOptions(), True, prior)
    ms, by = rk._lm_bound(rk.LMCall("lm_commit", args))
    entries = 2 * tlm.S_SIZE + N + 2 * D * D
    if branch == "accepted":
        entries += (3 * K + 4 * K + 1 + D + F * N + N + (1 + D + D * D)
                    + 3 * K + 4 * K + D + N + N + F * N)
    assert by == "bytes"
    assert ms == pytest.approx(1e3 * 8 * entries / rk.kv.HBM_BYTES_PER_S, rel=1e-12)


def test_knot_prior_constrains_an_unobserved_knot(unobserved_level):
    """With the knot prior on, the same level's H is positive definite and
    the steps are accepted: the prior's cost, g and H enter the candidate
    cost and the committed state as in JAX."""
    (_, kt), _ = unobserved_level
    _, (k2, s2) = run_both(unobserved_level, knot_prior_weight=1.0, max_iterations=6)
    assert s2.num_iterations >= 2 and not torch.equal(k2.t, kt.t)


@pytest.mark.parametrize("retry", [False, True])
def test_rejected_steps_match(stalled_level, retry):
    """A valid step that raises the cost: rejected, ending the level after
    one iteration, or with retry_rejected_steps shrinking the radius until
    max_iterations."""
    _, (_, s2) = run_both(stalled_level, retry_rejected_steps=retry, max_iterations=5)
    assert s2.num_iterations == (5 if retry else 1)


@pytest.mark.parametrize("overrides", [
    {"max_consecutive_nonmonotonic_steps": 0},   # the limit reached at every improvement
    {"max_consecutive_nonmonotonic_steps": 1, "max_chi_square_error": 1.0},
    {"max_chi_square_error": 1.0},               # outliers flagged
    {"max_iterations": 2, "min_abs_cost_decrease": 0.0},
    {"affine_brightness": True},
    {"sampling": "direct"},
])
def test_level_matches(level, overrides):
    _, (_, s2) = run_both(level, **overrides)
    assert s2.num_iterations >= 2
    if overrides.get("max_chi_square_error") == 1.0:
        assert float(s2.outlier_mask.min()) == 0.0


def test_one_host_read_an_iteration(level):
    """optimize_level reads the device once an iteration (the continue
    flag): Tensor.__bool__ and Tensor.item counted over one level."""
    (_, kt), (_, dt) = level
    reads = []
    item, boolean = torch.Tensor.item, torch.Tensor.__bool__

    def counted(f):
        def wrapped(self, *args):
            reads.append(f.__name__)
            return f(self, *args)
        return wrapped

    torch.Tensor.item, torch.Tensor.__bool__ = counted(item), counted(boolean)
    try:
        _, s = tlm.optimize_level(kt, dt, 5, 2, tlm.LMOptions(
            sampling="windowed", huber_a=10.0, min_abs_cost_decrease=1e-6))
    finally:
        torch.Tensor.item, torch.Tensor.__bool__ = item, boolean
    assert s.num_iterations >= 2
    assert len(reads) == s.num_iterations, reads


def test_caller_knots_are_not_written(level):
    """The state's knots are copies: the kernels update them in place, the
    caller's stay as given."""
    (_, kt), (_, dt) = level
    t0, q0 = kt.t.clone(), kt.q.clone()
    k, _ = tlm.optimize_level(kt, dt, 5, 2, tlm.LMOptions(sampling="windowed", huber_a=10.0))
    assert torch.equal(kt.t, t0) and torch.equal(kt.q, q0)
    assert not torch.equal(k.t, kt.t)


@pytest.mark.parametrize("D,itemsize,shared", [
    (12, 4, True), (42, 8, True), (162, 8, True), (168, 8, True), (170, 8, False),
    (234, 4, True), (240, 4, False), (600, 8, False)])
def test_step_factor_placement(D, itemsize, shared):
    """K6 keeps the factor in shared memory while it fits the block's
    227 KiB (a 24-frame degree-4 chunk, D = 162, in f64 included), else in
    a global scratch matrix, with the right-hand side and the reduction
    slots still in shared memory: no D leaves the kernel."""
    from mba_vo_tpu_torch.ops import cuda_lm

    full = cuda_lm.step_smem_bytes(D, itemsize)
    rest = cuda_lm.step_rest_bytes(D, itemsize)
    assert (full > 0) == shared
    if shared:
        assert full == D * D * itemsize + rest <= cuda_lm.STEP_SMEM_LIMIT
    assert rest == (2 * D + cuda_lm.LM_THREADS) * itemsize <= cuda_lm.STEP_SMEM_LIMIT


@pytest.mark.parametrize("D", [12, 42])
@pytest.mark.parametrize("case", ["valid", "not positive definite"])
def test_kernel_order_solve_matches_jax(D, case):
    """K6's order of operations transcribed in torch, which the card tests
    and ``chip_smoke.py`` hold K6 to bit for bit
    (``residual_kernels.lm_step_kernel_order``: the right-looking Cholesky
    factorisation and solves, the refinement, the block-ordered model
    change), run here on CPU tensors, against JAX's ``_solve`` and model
    change at 1e-12; a NaN step where the factorisation fails."""
    rng = np.random.default_rng(D)
    Hm = spd(D, D, 1e3) * (1 if case == "valid" else -1)
    g = rng.normal(0, 1, D)
    step, mcc = rk.lm_step_kernel_order(t64(Hm), t64(g))
    sj = jlm._solve(jnp.asarray(Hm), jnp.asarray(g), "cholesky")
    if case != "valid":
        assert torch.isnan(step).all() and np.isnan(np.asarray(sj)).all()
        return
    close(step, sj)
    mccj = -(jnp.asarray(g) @ sj + 0.5 * sj @ (jnp.asarray(Hm) @ sj))
    close(mcc, mccj)
    # past one entry a thread (600 > 256): each thread's strided entries first
    v = rng.normal(0, 1, 600)
    assert abs(float(rk.block_sum(t64(v))) - math.fsum(v)) <= 1e-12 * np.abs(v).sum()
