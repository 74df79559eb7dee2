"""The port's track_frames_joint against the JAX tracker's at degree 4 (a
7-knot cubic window) and in float32, and the multi-frame residual of
tests/test_multiframe.py through both packages. The helpers and the scene
are those of tests/test_torch_joint.py.
"""

import jax
import numpy as np
import pytest

from mba_vo_tpu.ops import residual as jres
from mba_vo_tpu_torch.ops import residual as tres

from torch_port_common import npy, scene_ate

from test_torch_joint import (  # noqa: F401  (scene is a fixture)
    check_sliding_window, jax_config, joint, scene, start_pair,
)


def test_sliding_window_at_degree_four(scene):
    """The same run as at degree 2: a 7-knot window, 42 tangent seeds."""
    check_sliding_window(scene, 4)


def test_float32_window_state_survives_batches(scene):
    """In float32 the stored knots.dt is rounded by about 1e-8 relative; the
    recreation gate compares the host float dt, so a second batch keeps the
    live window instead of resetting it to identity, and the host slides it
    by the same knot counts as the JAX tracker. float32 arithmetic in two
    frameworks agrees to about 1e-4 m here, not to 1e-8."""
    cfg = jax_config(dtype="float32")
    j, t = start_pair(cfg, scene)
    pj = joint(j, scene, sl=slice(0, 4))
    pt = joint(t, scene, sl=slice(0, 4))
    dt_b1, k_b1 = t._joint_dt, npy(t._joint_knots.t).copy()
    assert np.abs(k_b1).max() > 1e-3          # the window has moved
    pj = np.concatenate([pj, joint(j, scene, sl=slice(4, 6))])
    pt = np.concatenate([pt, joint(t, scene, sl=slice(4, 6))])
    assert t._joint_dt == dt_b1 == j._joint_dt           # the gate did not rebuild
    assert float(t._joint_knots.t0) == float(j._joint_knots.t0)   # the same slides
    assert t._joint_knots.t.dtype.is_floating_point and t._joint_knots.t.element_size() == 4
    np.testing.assert_allclose(pt, pj, atol=5e-4, rtol=0)
    assert scene_ate(pt.astype(np.float64), scene) < 5e-3


# ------------------------------------------------- the multi-frame residual


@pytest.fixture(scope="module")
def two_segment_level():
    """tests/test_multiframe.py's problem: two frames whose exposures lie in
    different segments of a 3-knot spline, rendered from the true knots."""
    import test_multiframe as tm
    from mba_vo_tpu_torch.core.spline import make_knots as tmake
    from torch_port_common import t64
    import torch

    truth = tm.true_knots()
    data = tm.make_data(truth)
    kt = tmake(t64(truth.t), t64(truth.q), tm.T0, tm.DT)
    dt = tres.TrackingLevelData(
        pattern=torch.as_tensor(np.array(data.pattern)).to(torch.int64),
        **{k: t64(getattr(data, k)) for k in data._fields if k != "pattern"})
    return truth, data, kt, dt, tm


@pytest.mark.parametrize("sampling", ["direct", "windowed"])
def test_zero_residual_at_truth(two_segment_level, sampling):
    truth, data, kt, dt, tm = two_segment_level
    r, _, valid = tres.compute_rjv(kt, dt, tm.NUM_VIR, tm.DEGREE, False, sampling=sampling)
    rj, _, vj = jax.jit(lambda k, d: jres.compute_rjv(
        k, d, tm.NUM_VIR, tm.DEGREE, False, sampling=sampling))(truth, data)
    np.testing.assert_array_equal(npy(valid), np.asarray(vj))
    np.testing.assert_allclose(npy(r), np.asarray(rj), atol=1e-9, rtol=0)
    assert np.abs(npy(r)[npy(valid)]).max() < 1e-8


@pytest.mark.parametrize("sampling", ["direct", "windowed"])
def test_jacobian_spans_both_segments(two_segment_level, sampling):
    """Frame 0 (exposure in segment 0) touches knots 0-1 only, frame 1
    knots 1-2 only: the Jacobian lands in global knot columns."""
    truth, data, kt, dt, tm = two_segment_level
    _, J, _ = tres.compute_rjv(kt, dt, tm.NUM_VIR, tm.DEGREE, True, sampling=sampling)
    _, Jj, _ = jax.jit(lambda k, d: jres.compute_rjv(
        k, d, tm.NUM_VIR, tm.DEGREE, True, sampling=sampling))(truth, data)
    J = npy(J)
    np.testing.assert_allclose(J, np.asarray(Jj), atol=1e-9, rtol=0)
    K = 3

    def knot_energy(frame, knot):
        return (np.abs(J[frame, ..., 3 * knot:3 * knot + 3]).max()
                + np.abs(J[frame, ..., 3 * K + 3 * knot:3 * K + 3 * knot + 3]).max())

    assert knot_energy(0, 0) > 1e-6 and knot_energy(0, 1) > 1e-6
    assert knot_energy(0, 2) < 1e-12
    assert knot_energy(1, 1) > 1e-6 and knot_energy(1, 2) > 1e-6
    assert knot_energy(1, 0) < 1e-12
