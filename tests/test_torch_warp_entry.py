"""K2's first entry from the spline knots (``ops.residual.warp_tangents_plain``:
the virtual poses, their tangents at zero retraction and the warp) against
the stage of the JAX package it replaces, on the CPU.

The reference is a function of the knot step ``delta`` composed as
``mba_vo_tpu/ops/residual.py``'s ``residuals_of`` composes it up to the
sampler: ``spline_retract``, ``sample_virtual_poses``,
``frontoparallel_warp``, ``in_bounds`` and the window-local positions. Its
value at zero gives ``loc`` and ``vs``, ``jax.jacfwd`` gives ``dxy``. Both
run op by op (no ``jit``).

Cases: degree 2 (the per-frame path's 2 knots, F = 1) and degree 4 (a joint
chunk's 7 knots, F = 4) from a moving state, with the tangents (D = 6K) and
without (D = 0); a standing start, identity knots with integer keypoints on
the image's border, so that samples land within 1e-6 px of its edges; a capture
time past the spline's end, where the segment index clamps, with V = 1.
Inputs from a numpy seed. Tolerances, relative to each output's largest
entry: 1e-12 in float64 (1e-15 measured), 1e-5 in float32 (the two sum the
spline's taps in another order); ``vs`` equal entry for entry in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core import spline as jspline
from mba_vo_tpu.ops import image as jimage
from mba_vo_tpu.ops import residual as jres
from mba_vo_tpu.ops import warp as jwarp
from mba_vo_tpu_torch.core import spline as tspline
from mba_vo_tpu_torch.ops import residual as tres

from torch_port_common import H, KVEC, W, npy, random_quats

BOUNDS = {"float64": 1e-12, "float32": 1e-5}
P = 8


def _inputs(case, seed=0):
    """(knots (t, q, t0, dt), cap_times, exp_times, V, degree, kp_z, pix
    [F, N, P, 2], starts [N, 2]) as numpy, for one case."""
    rng = np.random.default_rng(seed)
    n = 24
    if case == "degree 2":
        K, degree, F, V = 2, 2, 1, 5
    elif case == "degree 4":
        K, degree, F, V = 7, 4, 4, 5
    else:
        K, degree, F, V = 3, 2, 2, (1 if case == "clamped, V = 1" else 5)
    t = np.cumsum(rng.normal(0, 0.02, (K, 3)), axis=0)
    q = random_quats(rng, K, 0.01)
    t0, dt = 0.05, 0.1
    # the capture times of the knot window's span (a joint chunk's frames)
    caps = t0 + dt * (degree - 1) / 2 + dt * np.arange(F) * (K - degree + 1) / max(F, 1)
    kp = rng.uniform([4, 4], [W - 5, H - 5], (n, 2))
    kp[:2] = [[1.5, 2.25], [W - 2.5, H - 1.75]]          # patches spill off the image
    if case == "standing start":
        t = np.zeros((K, 3))
        q = np.tile([0.0, 0.0, 0.0, 1.0], (K, 1))
        kp = rng.integers(4, [W - 4, H - 4], (n, 2)).astype(np.float64)
        kp[:6] = [[0, 10], [W - 1, 20], [30, 0], [40, H - 1], [0, 30], [W - 1, 40]]
    if case == "clamped, V = 1":
        caps = np.array([t0 + dt * (K - 1) + 0.02, t0 + dt * (K + 0.5)])   # past the end
    offsets = rng.integers(-2, 3, (F, n, P, 2))
    if case == "standing start":
        offsets[:, :4] = 0          # the border pixels themselves; 4 and 5 spill off
    pix = np.floor(kp)[None, :, None, :] + offsets
    starts = np.clip(np.floor(kp) - 6, 0, [W - 12, H - 12]).astype(np.int64)
    return ((t, q, t0, dt), caps, np.full(F, 0.03), V, degree,
            rng.uniform(1.5, 2.5, n), pix, starts)


def _jax_stage(knots, caps, exps, V, degree, kp_z, pix, starts, dtype):
    """(loc, vs, dxy) of the reference's composition, as functions of the
    knot step at zero."""
    jd = getattr(jnp, dtype)
    t, q, t0, dt = knots
    kj = jspline.make_knots(jnp.asarray(t, jd), jnp.asarray(q, jd), t0, dt)
    caps, exps = jnp.asarray(caps, jd), jnp.asarray(exps, jd)
    kp_z, K = jnp.asarray(kp_z, jd), jnp.asarray(KVEC, jd)
    pix_nf = jnp.asarray(pix, jd).transpose(1, 0, 2, 3)       # [N, F, P, 2]
    starts_f = jnp.asarray(starts).astype(jd)
    Kk = t.shape[0]
    N, F = pix_nf.shape[:2]
    S = F * P * V

    def positions(delta):
        k = jspline.spline_retract(kj, delta[: 3 * Kk].reshape(Kk, 3),
                                   delta[3 * Kk:].reshape(Kk, 3))
        pt, pq = jres.sample_virtual_poses(k, caps, exps, V, degree)
        ref_xy = jwarp.frontoparallel_warp(
            pt[None, :, None, :, :], pq[None, :, None, :, :], kp_z[:, None, None, None], K,
            pix_nf[:, :, :, None, :])                          # [N, F, P, V, 2]
        return ref_xy

    zero = jnp.zeros(6 * Kk, jd)
    ref_xy = positions(zero)
    vs = jimage.in_bounds(ref_xy, H, W).reshape(N, S)
    loc = (ref_xy - starts_f[:, None, None, None, :]).reshape(N, S, 2)
    jac = jax.jacfwd(positions)(zero)                          # [N, F, P, V, 2, 6K]
    dxy = jnp.moveaxis(jac.reshape(N, S, 2, 6 * Kk), (2, 3), (0, 1))
    return np.asarray(loc), np.asarray(vs).astype(np.float64), np.asarray(dxy)


def _port(knots, caps, exps, V, degree, kp_z, pix, starts, dtype, tangents):
    td = getattr(torch, dtype)
    t, q, t0, dt = knots
    kt = tspline.make_knots(torch.tensor(t, dtype=td), torch.tensor(q, dtype=td), t0, dt)
    f = lambda a: torch.tensor(a, dtype=td)                    # noqa: E731
    return tres.warp_tangents_plain(kt, f(caps), f(exps), V, degree, tangents, f(kp_z),
                                    f(KVEC), f(pix), torch.tensor(starts), H, W)


def _close(got, ref, bound, what):
    got = npy(got).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-300)
    err = np.abs(got - ref).max() / scale
    assert err <= bound, f"{what}: {err:.3e} of the largest entry > {bound}"


CASES = ["degree 2", "degree 4", "standing start", "clamped, V = 1"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", CASES)
def test_entry_from_the_knots_matches_jax(case, dtype):
    args = _inputs(case)
    loc_j, vs_j, dxy_j = _jax_stage(*args, dtype)
    bound = BOUNDS[dtype]
    for tangents in (True, False):
        loc, vs, dxy = _port(*args, dtype, tangents)
        label = f"{case}, {dtype}, tangents={tangents}"
        np.testing.assert_array_equal(npy(vs), vs_j, err_msg=f"vs, {label}")
        _close(loc, loc_j, bound, f"loc, {label}")
        if tangents:
            _close(dxy, dxy_j, bound, f"dxy, {label}")
        else:
            assert tuple(dxy.shape) == (2, 0) + tuple(vs.shape)
    # the case reaches what it is for: samples off the image, and on its edges
    assert 0 < vs_j.mean() < 1
    if case == "standing start":
        # the border pixels warp to within 1e-6 px of the edges (the warp's
        # 1e-8 guard on the depth keeps them off by less than float32's
        # unit in the last place there)
        pos = loc_j + args[7][:, None, :]
        edge = np.minimum(np.abs(pos), np.abs(pos - [W - 1, H - 1])).min(-1)
        assert (edge < 1e-6).sum() >= 4 * 2 * 5
    if case == "clamped, V = 1":
        tn = (args[1] - args[0][2]) / args[0][3]
        assert tn.max() > args[0][0].shape[0] - args[4] + 1   # past the last segment


@pytest.mark.parametrize("degree", [2, 4])
def test_entry_is_the_chain_then_the_thread_design(degree):
    """warp_tangents_plain is virtual_poses_and_tangents (sample_virtual_poses
    without the tangents) then warp_tangents_threads_plain, to the bit: the
    sweep row's plain version takes the chain's outputs."""
    knots, caps, exps, V, _, kp_z, pix, starts = _inputs(f"degree {degree}", seed=3)
    t, q, t0, dt = knots
    kt = tspline.make_knots(torch.tensor(t), torch.tensor(q), t0, dt)
    f = lambda a: torch.tensor(a, dtype=torch.float64)         # noqa: E731
    rest = (f(kp_z), f(KVEC), f(pix), torch.tensor(starts), H, W)
    pt, pq, dpose = tres.virtual_poses_and_tangents(kt, f(caps), f(exps), V, degree)
    for tangents in (True, False):
        got = tres.warp_tangents_plain(kt, f(caps), f(exps), V, degree, tangents, *rest)
        ref = tres.warp_tangents_threads_plain(
            pt, pq, dpose if tangents else dpose[:0], *rest)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        # the dispatcher takes the plain version on CPU tensors
        again = tres.warp_tangents(kt, f(caps), f(exps), V, degree, tangents, *rest)
        for a, b in zip(got, again):
            assert torch.equal(a, b)
