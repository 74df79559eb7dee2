"""The port's closed-form pose Jacobian (``ops.residual.pose_jacobians``:
forward mode written out through the retraction and the spline,
``core.lie``'s and ``core.spline``'s ``*_jvp`` helpers) against the JAX
package's ``jax.jacfwd`` (``mba_vo_tpu/ops/residual.py:121``).

Cases: degree 2 and 4; from rest (identical knots: every relative rotation
is the identity, so ``quat_log`` takes its Taylor branch, as the
retraction's ``quat_exp(0)`` always does); a moving spline; and virtual
pose times at the clamped ends of the knot array, where the segment index
is clamped and the tangents must land on the clamped taps only.

Tolerances: 1e-12 absolute in float64 (the two differ only in rounding;
entries reach 58 where a time lies 5 knot intervals past the clamped end).
In float32 1e-6 of the largest entry (8 units of float32's epsilon): a
chain of ~40 float32 operations rounded in another order (XLA fuses, torch
runs op by op); each package is as far from the float64 result as from the
other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core.spline import make_knots as jmake
from mba_vo_tpu.ops import residual as jres
from mba_vo_tpu_torch.core import lie as tlie
from mba_vo_tpu_torch.core.spline import make_knots as tmake
from mba_vo_tpu_torch.ops import residual as tres

from torch_port_common import npy, random_quats

j_pose_jacobians = jax.jit(jres.pose_jacobians, static_argnums=(3, 4))
BOUND = {np.float64: 1e-12, np.float32: 1e-6}


def _knots(kind, num_knots, rng):
    if kind == "rest":
        t = np.zeros((num_knots, 3))
        q = np.tile([0.0, 0.0, 0.0, 1.0], (num_knots, 1))
    else:   # a moving spline: rotations of a few degrees between knots
        t = np.cumsum(rng.normal(0, 0.05, (num_knots, 3)), axis=0)
        q = random_quats(rng, num_knots, 0.08)
    return t, q


def _pair(t, q, t0, dt, dtype):
    jk = jmake(jnp.asarray(t, dtype), jnp.asarray(q, dtype), dtype(t0), dtype(dt))
    tk = tmake(torch.as_tensor(t, dtype=_torch(dtype)), torch.as_tensor(q, dtype=_torch(dtype)),
               t0, dt)
    return jk, tk


def _torch(dtype):
    return torch.float64 if dtype == np.float64 else torch.float32


# capture and exposure times: inside the knot window; and reaching past both
# clamped ends (times before t0 and past the last full segment)
TIMES = {
    "inside": (np.array([0.12, 0.19, 0.26]), np.array([0.03, 0.02, 0.04])),
    "clamped ends": (np.array([0.05, 0.0, 0.52, 0.6]), np.array([0.04, 0.03, 0.05, 0.03])),
}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("times", sorted(TIMES))
@pytest.mark.parametrize("kind", ["rest", "moving"])
@pytest.mark.parametrize("degree,num_knots", [(2, 2), (2, 5), (4, 4), (4, 6)])
def test_closed_form_pose_jacobian_matches_jacfwd(degree, num_knots, kind, times, dtype):
    rng = np.random.default_rng(degree * 10 + num_knots)
    t, q = _knots(kind, num_knots, rng)
    jk, tk = _pair(t, q, 0.085, 0.1, dtype)
    caps, exps = TIMES[times]
    Jj = j_pose_jacobians(jk, jnp.asarray(caps, dtype), jnp.asarray(exps, dtype), 5, degree)
    Jt = tres.pose_jacobians(tk, torch.as_tensor(caps, dtype=_torch(dtype)),
                             torch.as_tensor(exps, dtype=_torch(dtype)), 5, degree)
    assert tuple(Jt.shape) == Jj.shape == (len(caps), 5, 7, 6 * num_knots)
    assert Jt.dtype == _torch(dtype)
    scale = np.abs(np.asarray(Jj)).max() if dtype == np.float32 else 1.0
    np.testing.assert_allclose(npy(Jt), np.asarray(Jj), atol=BOUND[dtype] * scale, rtol=0)
    if times == "clamped ends":
        # times past the last segment take the last `degree` knots as taps,
        # times before t0 the first: no tangent of another knot reaches them
        K, d = num_knots, degree
        J = npy(Jt)
        for rows, dead in ((J[2:], list(range(K - d))), (J[:2], list(range(d, K)))):
            cols = [3 * k + i for k in dead for i in range(3)]
            cols += [3 * K + c for c in cols]
            assert not rows[..., cols].any()
        assert np.abs(J).max() > 0.1


def test_pose_tangents_are_the_poses_forward_mode():
    """virtual_poses_and_tangents' primal is sample_virtual_poses to the bit,
    and its tangents are pose_jacobians' seed-major layout."""
    rng = np.random.default_rng(3)
    t, q = _knots("moving", 4, rng)
    _, tk = _pair(t, q, 0.085, 0.1, np.float64)
    caps, exps = (torch.as_tensor(a, dtype=torch.float64) for a in TIMES["inside"])
    pt, pq, dpose = tres.virtual_poses_and_tangents(tk, caps, exps, 5, 4)
    st, sq = tres.sample_virtual_poses(tk, caps, exps, 5, 4)
    assert torch.equal(pt, st) and torch.equal(pq, sq)
    assert torch.equal(dpose.permute(1, 2, 3, 0), tres.pose_jacobians(tk, caps, exps, 5, 4))


@pytest.mark.parametrize("small", [True, False])
def test_quaternion_jvps_match_torch_forward_ad(small):
    """quat_log_jvp, quat_exp_jvp and quat_multiply_jvp against
    torch.func.jvp of the plain functions, in each branch (rotations below
    and above the Taylor threshold)."""
    rng = np.random.default_rng(11)
    scale = 1e-12 if small else 0.4
    omega = torch.as_tensor(rng.normal(0, scale, (6, 3)))
    domega = torch.as_tensor(rng.normal(0, 1, (4, 6, 3)))
    q = tlie.quat_exp(omega)
    dq = torch.as_tensor(rng.normal(0, 1, (4, 6, 4)))
    p = torch.as_tensor(random_quats(rng, 6))
    dp = torch.as_tensor(rng.normal(0, 1, (4, 6, 4)))
    for i in range(4):
        for fn, jvp, args, tangents in (
                (tlie.quat_exp, tlie.quat_exp_jvp, (omega,), (domega[i],)),
                (tlie.quat_log, tlie.quat_log_jvp, (q,), (dq[i],)),
                (tlie.quat_multiply, tlie.quat_multiply_jvp, (q, p), (dq[i], dp[i]))):
            ref, dref = torch.func.jvp(fn, args, tangents)
            out, dout = jvp(*args, *(d[None] for d in tangents))
            assert torch.equal(out, ref)
            torch.testing.assert_close(dout[0], dref, atol=1e-12, rtol=0)
