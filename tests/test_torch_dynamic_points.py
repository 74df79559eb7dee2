"""The port's backend/dynamic_points.py against the JAX package, float64 on
the CPU: residuals, the batched Gauss-Newton scene-flow fit (curved camera
path: unique recovery; linear path: the degenerate regime that only
explains the observations), masked slots, a singular system (its NaN step
is rejected as the reference's is) and the motion classification."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.backend import dynamic_points as jdp
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.backend import dynamic_points as tdp

import test_dynamic_points as jtest
from torch_port_common import npy, t64

TOL = 1e-10
JK = jtest.K
_scene = jtest._scene


def close(a, b, tol=TOL):
    np.testing.assert_allclose(npy(b), npy(a), atol=tol, rtol=0)


def both(scene):
    """(JAX arrays, port tensors) of a scene's cam_t, cam_q, times, obs, mask, K."""
    X0, flow, *obs = scene
    j = [*obs, JK]
    return X0, flow, j, [t64(np.asarray(a)) for a in j]


def points_pair(X0, flow, mask=None, seed=3, noise=0.05):
    rng = np.random.default_rng(seed)
    p0, f0 = X0 + rng.normal(0, noise, X0.shape), flow + rng.normal(0, noise, flow.shape)
    j = jdp.make_dynamic_points(jnp.asarray(p0), 0.0, flow=jnp.asarray(f0),
                                mask=None if mask is None else jnp.asarray(mask))
    t = tdp.make_dynamic_points(t64(p0), 0.0, flow=t64(f0),
                                mask=None if mask is None else t64(mask))
    return j, t


def assert_points(j, t, tol=TOL):
    for f in jdp.DynamicPoints._fields:
        close(getattr(j, f), getattr(t, f), tol)
    assert t.status.dtype == torch.int32


def test_make_points_and_interop():
    X0, flow, *_ = _scene()
    j = jdp.make_dynamic_points(jnp.asarray(X0), 0.5, flow=jnp.asarray(flow))
    t = tdp.make_dynamic_points(t64(X0), 0.5, flow=t64(flow))
    assert_points(j, t, 0.0)
    assert_points(j, interop.dynamic_points_from_fields(j), 0.0)
    times = np.array([0.5, 1.5, 2.0])
    close(jdp.position_at(j, jnp.asarray(times)), tdp.position_at(t, t64(times)))


def test_residuals():
    X0, flow, jo, to = both(_scene())
    j = jdp.make_dynamic_points(jnp.asarray(X0), 0.0, flow=jnp.asarray(flow * 0.7))
    t = tdp.make_dynamic_points(t64(X0), 0.0, flow=t64(flow * 0.7))
    close(jdp.dynamic_reprojection_residuals(j, *jo), tdp.dynamic_reprojection_residuals(t, *to))


@pytest.mark.parametrize("path", ["curved", "linear"])
def test_fit_scene_flow(path):
    """Curved path: both recover the truth to 1e-6 (the JAX test's bound)
    and agree to 1e-8. Linear path (degenerate: a family of lines meets
    every observation ray): both explain the observations to 1e-6, and
    their residuals agree to 1e-8; the fitted (X0, v) wander along the
    family from the last bits on (~2e-6 apart), so they are not compared."""
    scene = jtest.TestDynamicPoints()._curved_scene() if path == "curved" else _scene()
    X0, flow, jo, to = both(scene)
    j0, t0 = points_pair(X0, flow)
    iters = 25 if path == "curved" else 15
    j, t = jdp.fit_scene_flow(j0, *jo, iterations=iters), tdp.fit_scene_flow(t0, *to,
                                                                             iterations=iters)
    if path == "curved":
        assert_points(j, t, 1e-8)
        np.testing.assert_allclose(npy(t.points), X0, atol=1e-6)
        np.testing.assert_allclose(npy(t.flow), flow, atol=1e-6)
    else:
        rj = jdp.dynamic_reprojection_residuals(j, *jo)
        rt = tdp.dynamic_reprojection_residuals(t, *to)
        assert float(rt.abs().max()) < 1e-6 and float(jnp.abs(rj).max()) < 1e-6
        close(rj, rt, 1e-8)
        assert float((t.flow - t64(flow)).abs().max()) > 1e-3   # not recovered


def test_fit_leaves_masked_slots():
    """tests/test_dynamic_points.py's recipe: every point starts 7 m off and
    slot 5 is dead; after 3 steps slot 5 holds its values exactly in both
    packages (the live points, on that degenerate path, are not compared)."""
    X0, flow, jo, to = both(_scene())
    pmask = np.ones(X0.shape[0])
    pmask[5] = 0.0
    j0, t0 = points_pair(X0 + 7.0, flow, mask=pmask, noise=0.0)
    j = jdp.fit_scene_flow(j0, *jo, iterations=3)
    t = tdp.fit_scene_flow(t0, *to, iterations=3)
    for a, b in ((j0, j), (t0, t)):
        np.testing.assert_array_equal(npy(b.points[5]), npy(a.points[5]))
        np.testing.assert_array_equal(npy(b.flow[5]), npy(a.flow[5]))
    assert torch.isfinite(t.points).all()


def test_fit_rejects_the_nan_step_of_a_singular_system():
    """On the curved path with damping 0, a point with no observation (its
    mask column 0) has J = 0 and a singular H: the reference's solve gives a
    NaN step, the port writes NaN where solve_ex fails, and both reject it;
    every other point agrees to 1e-8."""
    X0, flow, jo, to = both(jtest.TestDynamicPoints()._curved_scene())
    omask = np.ones(np.shape(jo[4]))
    omask[:, 9] = 0.0
    jo[4], to[4] = jnp.asarray(omask), t64(omask)
    j0, t0 = points_pair(X0, flow)
    j = jdp.fit_scene_flow(j0, *jo, iterations=3, damping=0.0)
    t = tdp.fit_scene_flow(t0, *to, iterations=3, damping=0.0)
    assert_points(j, t, 1e-8)
    np.testing.assert_array_equal(npy(t.points[9]), npy(t0.points[9]))
    assert torch.isfinite(t.points).all() and torch.isfinite(t.flow).all()


def test_classify_motion():
    X0, flow, jo, to = both(_scene())
    pmask = np.ones(X0.shape[0])
    pmask[2] = 0.0
    j = jdp.make_dynamic_points(jnp.asarray(X0), 0.0, flow=jnp.asarray(flow),
                                mask=jnp.asarray(pmask))
    t = tdp.make_dynamic_points(t64(X0), 0.0, flow=t64(flow), mask=t64(pmask))
    # a large flow that does not explain the data: UNCERTAIN
    bad = np.array(flow)
    bad[0] = [0.3, 0.0, 0.0]
    j, t = j._replace(flow=jnp.asarray(bad)), t._replace(flow=t64(bad))
    a, b = jdp.classify_motion(j, *jo), tdp.classify_motion(t, *to)
    np.testing.assert_array_equal(npy(b.status), np.asarray(a.status))
    status = npy(b.status)
    assert status[0] == tdp.MOTION_UNCERTAIN and status[2] == tdp.MOTION_UNCERTAIN
    assert (status[3:24] == tdp.MOTION_STATIC).all()
    assert (status[24:] == tdp.MOTION_DYNAMIC).all()
