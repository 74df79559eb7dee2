"""The port's ops/residual.py (windowed and direct paths, with and without
the affine-brightness elimination) against the JAX package on the CPU in
float64.

JAX builds J with ``jax.linearize`` through the custom JVP of
``sample_windows_lk``; the port writes that chain rule out (pose Jacobian,
warp JVP, one C = 3 sampler call). Both are the same derivative, so r and J
agree to rounding: 1e-9 absolute on intensities of order 100.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.ops import residual as jres
from mba_vo_tpu.tracker.patterns import PATTERNS
from mba_vo_tpu_torch.ops import residual as tres

from torch_port_common import knots_arrays, knots_pair, level_arrays, level_pair, npy, t64

TOL = 1e-9
PATTERN = PATTERNS["dso8"]()

# jitted once per static configuration; eager linearize compiles op by op
j_residuals = jax.jit(jres.compute_residuals_windowed, static_argnums=(2, 3, 4, 5))
j_pose_jacobians = jax.jit(jres.pose_jacobians, static_argnums=(3, 4))
j_layout = jax.jit(jres.prepare_frame_layout, static_argnums=(2, 3))
j_evaluate = jax.jit(jres.evaluate, static_argnums=(2, 3, 4, 6),
                     static_argnames=("sampling", "compensated"))


def close(a, b, tol=TOL):
    np.testing.assert_allclose(npy(b), npy(a), atol=tol, rtol=0)


@pytest.fixture(scope="module")
def one_frame():
    return knots_pair(knots_arrays(seed=1)), level_pair(level_arrays(seed=4), PATTERN)


@pytest.fixture(scope="module")
def two_frames():
    return (knots_pair(knots_arrays(seed=2, num_knots=3)),
            level_pair(level_arrays(seed=6, frames=2), PATTERN))


@pytest.mark.parametrize("frames", ["one_frame", "two_frames"])
@pytest.mark.parametrize("window", [32, 12])
def test_residuals_and_jacobian(frames, window, request):
    """window = 12 puts part of the blur footprint outside the windows."""
    (kj, kt), (dj, dt) = request.getfixturevalue(frames)
    rj, Jj, vj = j_residuals(kj, dj, 5, 2, True, window)
    rt, Jt, vt = tres.compute_residuals_windowed(kt, dt, 5, 2, True, window)
    np.testing.assert_array_equal(npy(vt), np.asarray(vj))
    assert tuple(Jt.shape) == Jj.shape
    close(rj, rt)
    close(Jj, Jt)
    assert np.abs(npy(Jt)).max() > 1.0   # a real Jacobian, not zeros


def test_cost_only_residuals_and_hoisted_layout(one_frame):
    (kj, kt), (dj, dt) = one_frame
    rj, _, _ = j_residuals(kj, dj, 5, 2, False, 32)
    rt, Jt, _ = tres.compute_residuals_windowed(kt, dt, 5, 2, False, 32)
    assert Jt is None
    close(rj, rt)
    # a frozen layout and a precomputed window cache give the same numbers
    lay_t = tres.prepare_frame_layout(kt, dt, 5, 2)
    cache_t = tres.prepare_window_cache(dt, 32)
    r2, J2, _ = tres.compute_residuals_windowed(kt, dt, 5, 2, True, 32, cache=cache_t,
                                                layout=lay_t)
    r1, J1, _ = tres.compute_residuals_windowed(kt, dt, 5, 2, True, 32)
    np.testing.assert_array_equal(npy(r2), npy(r1))
    np.testing.assert_array_equal(npy(J2), npy(J1))


@pytest.mark.parametrize("degree,num_knots", [(2, 2), (4, 4)])
def test_virtual_poses_and_pose_jacobians(degree, num_knots):
    kj, kt = knots_pair(knots_arrays(seed=7, num_knots=num_knots, t0=0.05, dt=0.04))
    caps, exps = np.array([0.1, 0.12]), np.array([0.03, 0.02])
    tj, qj = jres.sample_virtual_poses(kj, jnp.asarray(caps), jnp.asarray(exps), 5, degree)
    tt, qt = tres.sample_virtual_poses(kt, t64(caps), t64(exps), 5, degree)
    close(tj, tt, 1e-12)
    close(qj, qt, 1e-12)
    Jj = j_pose_jacobians(kj, jnp.asarray(caps), jnp.asarray(exps), 5, degree)
    Jt = tres.pose_jacobians(kt, t64(caps), t64(exps), 5, degree)
    assert tuple(Jt.shape) == (2, 5, 7, 6 * num_knots)
    close(Jj, Jt, 1e-12)


def test_frame_layout(two_frames):
    (kj, kt), (dj, dt) = two_frames
    pj, vj, oj = j_layout(kj, dj, 5, 2)
    pt, vt, ot = tres.prepare_frame_layout(kt, dt, 5, 2)
    np.testing.assert_array_equal(npy(pt), np.asarray(pj))
    np.testing.assert_array_equal(npy(vt), np.asarray(vj))
    np.testing.assert_array_equal(npy(ot), np.asarray(oj))
    assert not npy(vt).all()   # some patch pixels do leave the image


def test_current_intensity_clamps_out_of_image_pixels():
    """Pixels off the image read a clamped pixel, as JAX's gather does,
    instead of raising (CPU) or reading out of bounds (CUDA)."""
    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (2, 6, 7))
    pix = rng.integers(-9, 15, (2, 5, 8, 2)).astype(np.float64)
    pix[0, 0, 0] = [-1e6, 1e6]
    got = tres._current_intensity(t64(imgs), t64(pix))
    np.testing.assert_array_equal(npy(got), np.asarray(
        jres._current_intensity(jnp.asarray(imgs), jnp.asarray(pix))))


def test_huber_weights():
    r = np.array([0.0, 1.0, -5.0, 19.9, 20.0, 28.3, 28.29, -40.0, 1e3])
    for a in (10.0, 20.0):
        (rj, wj), (rt, wt) = jres.huber_weights(jnp.asarray(r), a), tres.huber_weights(t64(r), a)
        close(rj, rt, 1e-12)
        close(wj, wt, 1e-15)


@pytest.mark.parametrize("compensated", [False, True])
def test_assemble(one_frame, compensated):
    (kj, kt), (dj, dt) = one_frame
    rj, Jj, _ = j_residuals(kj, dj, 5, 2, True, 32)
    rt, Jt, _ = tres.compute_residuals_windowed(kt, dt, 5, 2, True)
    rng = np.random.default_rng(3)
    mask = (rng.uniform(size=rt.shape[1]) > 0.2).astype(np.float64)
    ej = jres.assemble(rj, Jj, dj, 10.0, jnp.asarray(mask), compensated=compensated)
    et = tres.assemble(rt, Jt, dt, 10.0, t64(mask), compensated=compensated)
    close(ej.cost, et.cost, 1e-10)
    close(ej.gradient, et.gradient, 1e-7)
    np.testing.assert_allclose(npy(et.hessian), np.asarray(ej.hessian), rtol=1e-11,
                               atol=1e-9)
    close(ej.patch_costs, et.patch_costs, 1e-10)


def test_kahan_chunks_pad_the_residual_axis():
    """M = 203 is not a multiple of the 16 chunks."""
    rng = np.random.default_rng(5)
    Jw, rw = rng.normal(0, 1, (203, 12)), rng.normal(0, 1, 203)
    gj, Hj = jres._kahan_chunked_normal_eq(jnp.asarray(Jw), jnp.asarray(rw), None)
    gt, Ht = tres._kahan_chunked_normal_eq(t64(Jw), t64(rw))
    close(gj, gt, 1e-12)
    close(Hj, Ht, 1e-12)
    close(Jw.T @ rw, gt, 1e-12)


def test_patch_costs_ignore_the_outlier_mask(one_frame):
    """The reference's quirk: outliers leave the cost and the normaliser, but
    their patch costs are still reported (divided by the inlier count)."""
    (kj, kt), (dj, dt) = one_frame
    rt, _, _ = tres.compute_residuals_windowed(kt, dt, 5, 2, False)
    N = rt.shape[1]
    full = tres.assemble(rt, None, dt, 10.0, torch.ones(N, dtype=torch.float64))
    out = torch.ones(N, dtype=torch.float64)
    out[:5] = 0.0
    masked = tres.assemble(rt, None, dt, 10.0, out)
    assert masked.gradient is None and masked.hessian is None
    n_full, n_masked = float(dt.kp_mask.sum()), float((dt.kp_mask * out).sum())
    close(full.patch_costs * n_full, masked.patch_costs * n_masked, 1e-9)
    assert float(masked.cost) != float(full.cost)
    ej = jres.assemble(jnp.asarray(npy(rt)), None, dj, 10.0, jnp.asarray(npy(out)))
    close(ej.patch_costs, masked.patch_costs, 1e-12)
    close(ej.cost, masked.cost, 1e-12)


@pytest.mark.parametrize("compensated", [False, True])
def test_evaluate(one_frame, compensated):
    (kj, kt), (dj, dt) = one_frame
    mask = np.ones(dt.kp_mask.shape[0])
    ej = j_evaluate(kj, dj, 5, 2, 10.0, jnp.asarray(mask), True, sampling="windowed",
                    compensated=compensated)
    et = tres.evaluate(kt, dt, 5, 2, 10.0, t64(mask), True, sampling="windowed",
                       compensated=compensated)
    close(ej.cost, et.cost, 1e-10)
    close(ej.gradient, et.gradient, 1e-7)
    np.testing.assert_allclose(npy(et.hessian), np.asarray(ej.hessian), rtol=1e-11,
                               atol=1e-9)


def test_unported_paths_raise(one_frame):
    """Both residual paths that used to raise are ported: compute_rjv takes
    sampling="direct" and affine=True on either path. An unknown sampling
    name falls to the direct path, as in the reference."""
    (kj, kt), (dj, dt) = one_frame
    for kw in (dict(sampling="direct"), dict(sampling="windowed", affine=True),
               dict(sampling="direct", affine=True)):
        r, J, valid = tres.compute_rjv(kt, dt, 5, 2, True, **kw)
        assert r.shape == valid.shape and J.shape == r.shape + (12,)
        assert torch.isfinite(r).all() and torch.isfinite(J).all()
    assert not hasattr(tres, "_not_ported")


j_direct = jax.jit(jres.compute_residuals, static_argnums=(2, 3, 4, 5))
j_windowed_affine = jax.jit(
    lambda k, d, wj: jres.compute_residuals_windowed(k, d, 5, 2, wj, 32, affine=True),
    static_argnums=(2,))


@pytest.mark.parametrize("frames", ["one_frame", "two_frames"])
@pytest.mark.parametrize("affine", [False, True])
def test_direct_residuals_and_jacobian(frames, affine, request):
    """sampling="direct": JAX differentiates warp_and_sample per sample and
    contracts with the pose Jacobian; the port writes G = gx dx/dpose7 +
    gy dy/dpose7 out. With affine, J is the frozen-(a, b) Jacobian on both
    sides: the same J as without."""
    (kj, kt), (dj, dt) = request.getfixturevalue(frames)
    rj, Jj, vj = j_direct(kj, dj, 5, 2, True, affine)
    rt, Jt, vt = tres.compute_residuals(kt, dt, 5, 2, True, affine)
    np.testing.assert_array_equal(npy(vt), np.asarray(vj))
    close(rj, rt)
    close(Jj, Jt)
    assert np.abs(npy(Jt)).max() > 1.0
    r0, J0, _ = tres.compute_residuals(kt, dt, 5, 2, True, False)
    np.testing.assert_array_equal(npy(Jt), npy(J0))
    assert affine == (np.abs(npy(rt) - npy(r0)).max() > 1e-3)
    # the cost-only branch samples the same values
    rc, Jc, _ = tres.compute_residuals(kt, dt, 5, 2, False, affine)
    assert Jc is None
    np.testing.assert_array_equal(npy(rc), npy(rt))
    close(j_direct(kj, dj, 5, 2, False, affine)[0], rc)


def test_direct_affine_jacobian_is_not_the_profile_likelihoods(two_frames):
    """The reference's known fault, reproduced: on the direct path the
    corrected residual is paired with a Jacobian that ignores how the fitted
    gain and bias move with the prediction. The windowed path carries J
    through the elimination, so the two paths' Jacobians differ under
    affine=True although they agree without it (away from the window edge)."""
    (_, kt), (_, dt) = two_frames
    _, Jd, _ = tres.compute_rjv(kt, dt, 5, 2, True, sampling="direct", affine=True)
    _, Jw, _ = tres.compute_rjv(kt, dt, 5, 2, True, sampling="windowed", affine=True)
    _, Jd0, _ = tres.compute_rjv(kt, dt, 5, 2, True, sampling="direct")
    _, Jw0, _ = tres.compute_rjv(kt, dt, 5, 2, True, sampling="windowed")
    close(Jd0, Jw0)
    assert np.abs(npy(Jd) - npy(Jw)).max() > 1e-2


@pytest.mark.parametrize("frames", ["one_frame", "two_frames"])
def test_windowed_affine_residuals_and_jacobian(frames, request):
    """JAX linearizes through affine_correct (the full profile likelihood);
    the port's affine_correct_jvp writes that derivative out."""
    (kj, kt), (dj, dt) = request.getfixturevalue(frames)
    rj, Jj, vj = j_windowed_affine(kj, dj, True)
    rt, Jt, vt = tres.compute_residuals_windowed(kt, dt, 5, 2, True, 32, affine=True)
    np.testing.assert_array_equal(npy(vt), np.asarray(vj))
    close(rj, rt)
    close(Jj, Jt)
    rc, Jc, _ = tres.compute_residuals_windowed(kt, dt, 5, 2, False, 32, affine=True)
    assert Jc is None
    close(j_windowed_affine(kj, dj, False)[0], rc)
    # the eliminated residual has zero mean and no component along obs
    _, _, obs = tres.prepare_frame_layout(kt, dt, 5, 2)
    v = npy(vt)
    for f in range(rt.shape[0]):
        assert abs(npy(rt)[f][v[f]].sum()) < 1e-8
        assert abs((npy(rt)[f] * npy(obs)[f])[v[f]].sum()) < 1e-6


def test_affine_correct_and_its_jvp():
    """affine_correct against JAX, its derivative against jax.jvp, and a
    textureless frame (variance of obs <= 1e-6), which keeps
    (a, b) = (1, 0): the plain residual, with a plain derivative."""
    rng = np.random.default_rng(8)
    F, N, P, D = 3, 10, 8, 5
    pred = rng.uniform(0, 255, (F, N, P))
    obs = 1.3 * pred + 11.0 + rng.normal(0, 2.0, (F, N, P))
    obs[2] = 77.0                                    # textureless
    valid = rng.uniform(size=(F, N, P)) > 0.2
    dpred = rng.normal(0, 1, (F, N, P, D))
    want = jres.affine_correct(jnp.asarray(pred), jnp.asarray(obs), jnp.asarray(valid))
    got = tres.affine_correct(t64(pred), t64(obs), torch.as_tensor(valid))
    close(want, got, 1e-10)
    r, dr = tres.affine_correct_jvp(t64(pred), t64(obs), torch.as_tensor(valid), t64(dpred))
    np.testing.assert_array_equal(npy(r), npy(got))
    for d in range(D):
        _, tan = jax.jvp(lambda p: jres.affine_correct(p, jnp.asarray(obs), jnp.asarray(valid)),
                         (jnp.asarray(pred),), (jnp.asarray(dpred[..., d]),))
        close(tan, dr[..., d], 1e-10)
    np.testing.assert_allclose(npy(got)[2], np.where(valid[2], pred[2] - obs[2], 0.0),
                               atol=1e-12)
    np.testing.assert_allclose(npy(dr)[2], np.where(valid[2][..., None], dpred[2], 0.0),
                               atol=1e-12)
    # the gain and bias are fitted out of the first two frames
    assert np.abs(npy(got)[:2]).max() < 12.0 < np.abs(pred - obs)[:2].max()


def test_layout_matches_jax_from_a_standing_start():
    """From identity knots the patch anchors are integers up to rounding,
    and floor() picks a neighbour pixel for the keypoints whose projection
    rounds below the integer. The port rounds as the JAX package run op by
    op does, in float32 and in float64, so both pick the same pixels in
    each dtype; float32 and float64 pick different pixels for some
    keypoints, and a float32 tracker from rest starts on another layout
    than a float64 one."""
    from mba_vo_tpu.core.spline import identity_knots as j_identity_knots
    from mba_vo_tpu_torch.core.spline import identity_knots

    rng = np.random.default_rng(0)
    w, h, fx = 640, 480, 480.0
    n = 512
    kp = rng.integers(4, [w - 4, h - 4], (n, 2)).astype(np.float64)
    fields = dict(img_ref=np.zeros((h, w)), grad_ref=np.zeros((h, w, 2)),
                  cur_imgs=np.zeros((1, h, w)), cap_times=np.array([0.1]),
                  exp_times=np.array([0.03]), kp_xy=kp, kp_z=np.full(n, 2.0),
                  kp_mask=np.ones(n), K=np.array([fx, fx, (w - 1) / 2, (h - 1) / 2]))
    port, ref = {}, {}
    for name in ("float32", "float64"):
        tdt, jdt = getattr(torch, name), getattr(jnp, name)
        dt = tres.TrackingLevelData(pattern=torch.as_tensor(PATTERN), **{
            k: torch.tensor(v, dtype=tdt) for k, v in fields.items()})
        dj = jres.TrackingLevelData(pattern=jnp.asarray(PATTERN), **{
            k: jnp.asarray(v, jdt) for k, v in fields.items()})
        port[name] = npy(tres.prepare_frame_layout(
            identity_knots(2, 0.085, 0.1, tdt), dt, 5, 2)[0]).astype(np.float64)
        ref[name] = np.asarray(jres.prepare_frame_layout(
            j_identity_knots(2, 0.085, 0.1, jdt), dj, 5, 2)[0]).astype(np.float64)
    for name in ("float32", "float64"):
        np.testing.assert_array_equal(port[name], ref[name], err_msg=name)
    flips = (port["float32"] != port["float64"]).any(-1).any(-1).sum()
    assert flips > 0
