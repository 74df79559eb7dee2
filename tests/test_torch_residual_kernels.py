"""The plain versions of kernels K2 and K3, composed as the windowed path
runs them (the pose Jacobian's chain ``virtual_poses_and_tangents`` ->
``warp_tangents_threads_plain``, which ``warp_tangents_plain`` composes
from the knots (tests/test_torch_warp_entry.py) -> the sampler K1's plain
version through
``sample_windows_lk`` -> ``blur_rows_plain`` (-> ``affine_correct_jvp``) ->
``normal_equations_plain``), against the JAX package's
``compute_residuals_windowed`` + ``assemble`` on the CPU.

Axes: F = 1 frame with 6K = 12 (2 knots, degree 2: the per-frame path) and
F = 4 with 6K = 42 (7 knots, degree 4: a joint chunk); the affine
elimination on and off; Kahan-compensated normal equations on and off; an
outlier mask; padded keypoint slots (kp_mask 0); a window of 12 px, so that
samples leave their windows, and keypoints at the image border, so that
patch pixels and samples leave the image; the cost-only mode.

Tolerances, each relative to the largest entry of the JAX result: 1e-12 in
float64 for r, J, cost, g, H and the patch costs (the two differ only in
rounding: ``jax.linearize`` against the chain rule written out; 5e-15
measured). In float32, 1e-5 for all of them: a sample's value
interpolates intensities of order 100 and its tangent passes through a
projection, each rounded in another order, and the sums run over
1,000-14,000 rows accumulated in another order (3e-6 measured, about 25
units of float32's epsilon).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.ops import residual as jres
from mba_vo_tpu.tracker.patterns import PATTERNS
from mba_vo_tpu_torch.ops import residual as tres
from mba_vo_tpu_torch.ops.window_sampling import sample_windows_lk

from torch_port_common import knots_arrays, knots_pair, level_arrays, level_pair, npy

PATTERN = PATTERNS["dso8"]()
HUBER_A = 10.0
NUM_VIR = 5
BOUNDS = {"float64": (1e-12, 1e-12), "float32": (1e-5, 1e-5)}
# (frames, knots, degree, knot start): 6K = 12 and 42
CONFIGS = {"F=1 6K=12": (1, 2, 2, 0.085), "F=4 6K=42": (4, 7, 4, 0.05)}


def _cast(tree, jdtype, tdtype):
    """The float fields of a (JAX, port) pair of named tuples in a dtype."""
    j, t = tree
    return (j._replace(**{k: v.astype(jdtype) for k, v in j._asdict().items()
                          if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating)}),
            t._replace(**{k: v.to(tdtype) for k, v in t._asdict().items()
                          if torch.is_tensor(v) and v.is_floating_point()}))


def _problem(config, dtype):
    frames, n_knots, degree, t0 = CONFIGS[config]
    knots = knots_pair(knots_arrays(seed=3, num_knots=n_knots, t0=t0, dt=0.1))
    level = level_pair(level_arrays(seed=8, n_kp=40, frames=frames, dead=5), PATTERN)
    jd, td = (jnp.float64, torch.float64) if dtype == "float64" else (jnp.float32,
                                                                      torch.float32)
    return _cast(knots, jd, td), _cast(level, jd, td), degree


def composed_plain(kt, dt, degree, window, affine, live_kp, compensated):
    """The port's windowed evaluation through the plain versions, step by
    step; returns (r, J, cost, g, H, patch_costs)."""
    H, W = dt.img_ref.shape
    pix, valid, obs = tres.prepare_frame_layout(kt, dt, NUM_VIR, degree)
    windows, starts = tres.prepare_window_cache(dt, window)
    pt, pq, dpose = tres.virtual_poses_and_tangents(kt, dt.cap_times, dt.exp_times,
                                                    NUM_VIR, degree)
    loc, vs, dxy = tres.warp_tangents_threads_plain(pt, pq, dpose, dt.kp_z, dt.K, pix, starts,
                                                    H, W)
    val, gx, gy = sample_windows_lk(windows, loc, vs)
    rows, drows = tres.blur_rows_plain(val, gx, gy, dxy, obs, valid, NUM_VIR, affine)
    r, J = tres.affine_correct_jvp(rows, obs, valid, drows) if affine else (rows, drows)
    cost, patch, g, Hm = tres.normal_equations_plain(r, J, live_kp, HUBER_A, compensated)
    F, P = dt.cur_imgs.shape[0], dt.pattern.shape[0]
    inv_n = 1.0 / torch.clamp(live_kp.sum() * F * P, min=1.0)
    scaled = [None if x is None else x * inv_n for x in (cost, g, Hm, patch)]
    return (r, J, *scaled), (vs, loc)


def _close(got, ref, bound, what):
    ref = np.asarray(ref, dtype=np.float64)
    got = npy(got).astype(np.float64)
    assert got.shape == ref.shape, what
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max() / scale
    assert err <= bound, f"{what}: {err:.3e} of the largest entry > {bound}"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_composed_plain_versions_match_jax(config, affine, dtype):
    (kj, kt), (dj, dt), degree = _problem(config, dtype)
    window = 12
    rows_bound, sums_bound = BOUNDS[dtype]
    j_res = jax.jit(lambda k, d: jres.compute_residuals_windowed(
        k, d, NUM_VIR, degree, True, window, affine=affine))
    rj, Jj, _ = j_res(kj, dj)
    N = dt.kp_xy.shape[0]
    outlier = np.ones(N)
    outlier[[1, 7, 12]] = 0.0
    tdt = dt.kp_mask.dtype
    for mask in (np.ones(N), outlier):
        for compensated in (False, True):
            live = dt.kp_mask * torch.as_tensor(mask, dtype=tdt)
            (r, J, cost, g, Hm, patch), (vs, loc) = composed_plain(
                kt, dt, degree, window, affine, live, compensated)
            ej = jres.assemble(rj, Jj, dj, HUBER_A, jnp.asarray(mask, dtype=rj.dtype),
                               compensated=compensated)
            label = f"{config} affine={affine} mask={int(mask.sum())} comp={compensated}"
            _close(r, rj, rows_bound, f"r, {label}")
            _close(J, Jj, rows_bound, f"J, {label}")
            for name, got, ref in (("cost", cost, ej.cost), ("g", g, ej.gradient),
                                   ("H", Hm, ej.hessian), ("patch", patch, ej.patch_costs)):
                _close(got, ref, sums_bound, f"{name}, {label}")
            # the cost-only mode of the candidate's assembly
            e0 = jres.assemble(rj, None, dj, HUBER_A, jnp.asarray(mask, dtype=rj.dtype))
            c0, _, g0, H0 = tres.normal_equations_plain(r, None, live, HUBER_A, compensated)
            assert g0 is None and H0 is None
            inv_n = 1.0 / torch.clamp(live.sum() * dt.cur_imgs.shape[0] * len(PATTERN),
                                      min=1.0)
            _close(c0 * inv_n, e0.cost, sums_bound, f"cost only, {label}")
    # the inputs reach every case the kernels must keep: samples outside the
    # image, samples outside their windows, padded and live keypoints
    vs_np, loc_np = npy(vs), npy(loc)
    assert 0 < vs_np.mean() < 1
    assert ((loc_np < -1) | (loc_np > window)).any()
    assert 0 < npy(dt.kp_mask).sum() < N
    assert np.abs(npy(J)).max() > 1.0


@pytest.mark.parametrize("affine", [False, True])
def test_windowed_path_through_the_dispatchers_equals_the_composition(affine):
    """compute_residuals_windowed and assemble (the dispatchers, which take
    the plain versions on CPU tensors) give the composition's numbers to the
    bit."""
    (kj, kt), (dj, dt), degree = _problem("F=4 6K=42", "float64")
    live = dt.kp_mask.clone()
    (r, J, cost, g, Hm, patch), _ = composed_plain(kt, dt, degree, 32, affine, live, True)
    r2, J2, _ = tres.compute_residuals_windowed(kt, dt, NUM_VIR, degree, True, 32,
                                                affine=affine)
    ev = tres.assemble(r2, J2, dt, HUBER_A, torch.ones_like(live), compensated=True)
    for a, b in ((r, r2), (J, J2), (cost, ev.cost), (g, ev.gradient), (Hm, ev.hessian),
                 (patch, ev.patch_costs)):
        assert torch.equal(a, b)
    # without the Jacobian the same path runs with no tangent seeds
    r3, J3, _ = tres.compute_residuals_windowed(kt, dt, NUM_VIR, degree, False, 32,
                                                affine=affine)
    assert J3 is None and torch.equal(r3, r)


def test_normal_equations_plain_matches_its_definition():
    """normal_equations_plain's sums written out with numpy in float64:
    Huber weights on both sides of the threshold, the
    unmasked patch costs, and the Kahan-chunked mode with M not a multiple
    of the 16 chunks."""
    rng = np.random.default_rng(2)
    F, N, P, D = 3, 7, 5, 12
    r = rng.normal(0, 12.0, (F, N, P))
    J = rng.normal(0, 3.0, (F, N, P, D))
    kp_w = (rng.uniform(size=N) > 0.3).astype(np.float64)
    x = 0.5 * r * r
    big = x > HUBER_A ** 2
    rho = np.where(big, 2 * HUBER_A * np.sqrt(x) - HUBER_A ** 2, x)
    w = np.where(big, np.sqrt(HUBER_A / (np.sqrt(x) + 1e-8)), 1.0)
    kw = kp_w[None, :, None]
    Jw = (J * (w * kw)[..., None]).reshape(-1, D)
    rw = (r * w * kw).reshape(-1)
    for compensated in (False, True):
        cost, patch, g, H = tres.normal_equations_plain(
            torch.as_tensor(r), torch.as_tensor(J), torch.as_tensor(kp_w), HUBER_A,
            compensated)
        np.testing.assert_allclose(npy(cost), (rho * kw).sum(), rtol=1e-13)
        np.testing.assert_allclose(npy(patch), rho.sum(-1), rtol=1e-13)
        np.testing.assert_allclose(npy(g), Jw.T @ rw, rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(npy(H), Jw.T @ Jw, rtol=1e-12, atol=1e-9)
    assert big.any() and (~big).any()
