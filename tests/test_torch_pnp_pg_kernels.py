"""The plain versions of the loop closure's kernels K13-K15 against the JAX
package's functions they stand for, on the CPU in float64, from inputs made
with numpy from a seed.

K13 (csrc/pnp.cu) stands for ``solve_pnp`` and ``pnp_residual_norms``: the
batched plain version (backend/geometry.py's ``solve_pnp_plain``) and the
row the loop stage reads (``pnp_rounds_row``) against ``solve_pnp_jit`` and
``pnp_residual_norms`` problem by problem, at B = 1 and 5 (mixed mask
counts, one all zero), N = 48 and 256, 0, 1 and 30 iterations (pose 1e-9,
cost rtol 1e-9, norms 1e-8 beside what the poses' own difference moves them
by); a NaN point in one problem of a batch (that
problem keeps its init, the others are unaffected), a point behind the
camera (the depth clamp) and Huber outliers.

K14-K15 (csrc/pose_graph.cu) stand for the pose graph's LM iteration: K14's
block-built H and g written in torch (experiments/backend_kernels.py's
``pg_blocks``) against ``pg_build_plain``'s dense product (1e-12 of each
output's magnitude); the stage loop (``pg_build_plain``, ``pg_step_plain``)
against ``optimize_pose_graph_jit`` at N = 2, 8 (a loop edge) and 64
(chip_smoke.py's chain) with equal iteration counts, a NaN edge, one
iteration, a done state; K15's Cholesky order in torch
(``pg_cholesky_solve_ordered``) against ``torch.linalg.solve_ex`` within
the solve's roundoff bound. Then what the CPU can check of the bindings
(ops/cuda_backend.py): the refusal of CPU tensors, and that the CPU path
launches nothing. The kernels themselves are held to these plain versions
on the card (tests/test_torch_cuda_backend_solvers.py, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.backend import geometry as jgeo
from mba_vo_tpu.backend import pose_graph as jpg
from mba_vo_tpu.core.transform import Pose as JPose
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.backend import geometry as tgeo
from mba_vo_tpu_torch.backend import pose_graph as tpg
from mba_vo_tpu_torch.core.transform import Pose as TPose
from mba_vo_tpu_torch.experiments import backend_kernels as bk
from mba_vo_tpu_torch.ops import cuda_backend as cb

POSE = 1e-9
COST = 1e-9
NORMS = 1e-8


def _jax_pnp(a, b, iterations):
    """JAX's solve and norms of problem b of pnp_arrays' ``a``: (t, q, cost,
    norms)."""
    f = lambda x: jnp.asarray(x[b])  # noqa: E731
    pose, cost = jgeo.solve_pnp_jit(f(a["points"]), f(a["obs_xy"]), f(a["mask"]),
                                    jnp.asarray(a["K"]), JPose(f(a["init_t"]), f(a["init_q"])),
                                    2.0, iterations)
    norms = jgeo.pnp_residual_norms(f(a["points"]), f(a["obs_xy"]), jnp.asarray(a["K"]), pose)
    return np.asarray(pose.t), np.asarray(pose.q), float(cost), np.asarray(norms)


def _check_problem(a, b, t, q, cost, norms, iterations):
    """Problem b's pose, cost and norms against JAX's. A norm moves with the
    pose by its point's sensitivity, fx / z (1 + (|x| + |y|) / z) (1 + |Pc|)
    px a unit of the pose (z clamped at 1e-6, as the projection clamps it):
    each is held within 1e-8 + 1e-9 of its size + 4 times that times the
    poses' own difference."""
    jt, jq, jc, jn = _jax_pnp(a, b, iterations)
    np.testing.assert_allclose(t, jt, rtol=0, atol=POSE)
    np.testing.assert_allclose(q, jq, rtol=0, atol=POSE)
    np.testing.assert_allclose(cost, jc, rtol=COST, atol=0)
    moved = max(np.abs(t - jt).max(), np.abs(q - jq).max())
    Pc = bk._qrot(bk._qconj(jq), a["points"][b] - jt)
    z = np.maximum(Pc[:, 2], 1e-6)
    sens = a["K"][0] / z * (1 + (np.abs(Pc[:, 0]) + np.abs(Pc[:, 1])) / z) * (
        1 + np.linalg.norm(Pc, axis=1))
    tol = NORMS + 1e-9 * np.abs(jn) + 4 * sens * moved
    bad = ~(np.abs(norms - jn) <= tol) & ~(np.isnan(norms) & np.isnan(jn))
    assert not bad.any(), (np.flatnonzero(bad), norms[bad], jn[bad], tol[bad])


@pytest.mark.parametrize("iterations", [0, 1, 30])
@pytest.mark.parametrize("N", [48, 256])
@pytest.mark.parametrize("B", [1, 5])
def test_pnp_batch_and_row_match_jax(B, N, iterations):
    live = [N] if B == 1 else [N, 30, 0, 20, N]
    a = bk.pnp_arrays(B, N, seed=B + N, live=live)
    args = bk.pnp_tensors(a)
    pose, cost = tgeo.solve_pnp_plain(*args, 2.0, iterations)
    row = tgeo.pnp_rounds_row(*args, 2.0, iterations).numpy()
    for b in range(B):
        _check_problem(a, b, pose.t[b].numpy(), pose.q[b].numpy(), float(cost[b]),
                       row[b, :N], iterations)
        # the row carries the same pose and cost, bit for bit
        np.testing.assert_array_equal(row[b, N:], np.concatenate(
            [[float(cost[b])], pose.t[b].numpy(), pose.q[b].numpy()]))
    # the all-zero mask: n clamps to 1, the cost is 0 and the pose stays at init
    if B == 5:
        assert float(cost[2]) == 0.0
        np.testing.assert_array_equal(pose.t[2].numpy(), a["init_t"][2])


def test_pnp_nan_point_in_one_problem_keeps_its_init_only():
    a = bk.pnp_arrays(3, 48, seed=11, nan_problem=1)
    pose, cost = tgeo.solve_pnp(*bk.pnp_tensors(a), 2.0, 30)
    np.testing.assert_array_equal(pose.t[1].numpy(), a["init_t"][1])
    np.testing.assert_array_equal(pose.q[1].numpy(), a["init_q"][1])
    assert np.isnan(float(cost[1]))
    for b in (0, 2):
        alone = {k: (v[b:b + 1] if k != "K" else v) for k, v in a.items()}
        pa, ca = tgeo.solve_pnp(*bk.pnp_tensors(alone), 2.0, 30)
        np.testing.assert_allclose(pose.t[b].numpy(), pa.t[0].numpy(), rtol=0, atol=1e-12)
        np.testing.assert_allclose(float(cost[b]), float(ca[0]), rtol=1e-12)
        jt, jq, jc, _ = _jax_pnp(a, b, 30)
        np.testing.assert_allclose(pose.t[b].numpy(), jt, rtol=0, atol=POSE)
    jt, jq, jc, _ = _jax_pnp(a, 1, 30)
    np.testing.assert_array_equal(jt, a["init_t"][1])
    assert np.isnan(jc)


@pytest.mark.parametrize("case", ["behind", "outliers"])
def test_pnp_depth_clamp_and_huber_outliers_match_jax(case):
    kw = dict(behind=True) if case == "behind" else dict(outliers=12)
    a = bk.pnp_arrays(1, 96, seed=5, **kw)
    args = bk.pnp_tensors(a)
    row = tgeo.pnp_rounds_row(*args, 2.0, 30).numpy()
    pose, cost = tgeo.solve_pnp_plain(*args, 2.0, 30)
    _check_problem(a, 0, pose.t[0].numpy(), pose.q[0].numpy(), float(cost[0]), row[0, :96], 30)
    if case == "behind":
        # the point behind the camera projects through the clamped depth: at
        # the start its residual is millions of pixels
        start = tgeo.pnp_rounds_row(*args, 2.0, 0).numpy()
        assert start[0, 7] > 1e6


def _pg(n, loop=True, dtype=torch.float64):
    (t, q), e = bk.pose_graph_arrays(n, loop=loop)
    f = lambda x: torch.tensor(x, dtype=dtype)  # noqa: E731
    return (t, q), e, TPose(f(t), f(q)), interop.pose_graph_edges_from_arrays(*e, dtype=dtype)


def _jax_edges(e):
    i, j, t_ij, q_ij, w = e
    return jpg.PoseGraphEdge(i=jnp.asarray(i, jnp.int32), j=jnp.asarray(j, jnp.int32),
                             t_ij=jnp.asarray(t_ij), q_ij=jnp.asarray(q_ij),
                             weight=jnp.asarray(w))


@pytest.mark.parametrize("n", [8, 64])
def test_pg_blocks_equal_the_dense_product(n):
    _, _, poses, edges = _pg(n)
    # away from the start, so that every block and g are non-zero
    poses = TPose(poses.t + 0.01 * torch.arange(3 * n, dtype=torch.float64).reshape(n, 3).sin(),
                  poses.q)
    H, g = bk.pg_blocks(poses, edges)
    Hd, gd, scalars = tpg.pg_build_plain(poses, edges, cb.new_scalars(poses.t,
                                                                       tpg.PoseGraphOptions()))
    assert float((H - Hd).abs().max()) <= 1e-12 * float(Hd.abs().max())
    assert float((g - gd).abs().max()) <= 1e-12 * float(gd.abs().max())
    assert float(scalars[cb.G_COST]) == float(tpg._cost(poses, edges))
    assert float(scalars[cb.G_BUILD_COST]) == float(scalars[cb.G_COST])
    # node 0's rows and columns are zero
    assert float(Hd[:6].abs().max()) == 0.0 and float(Hd[:, :6].abs().max()) == 0.0


@pytest.mark.parametrize("n, loop, max_iterations", [(2, False, 30), (8, True, 30),
                                                     (64, True, 30), (8, True, 1)])
def test_pg_stage_loop_matches_jax(n, loop, max_iterations):
    (t, q), e, poses, edges = _pg(n, loop)
    opts = tpg.PoseGraphOptions(max_iterations=max_iterations)
    jopts = jpg.PoseGraphOptions(max_iterations=max_iterations)
    pt, ct, it = tpg.run_plain_stages(poses, edges, opts)
    pj, cj = jpg.optimize_pose_graph_jit(JPose(jnp.asarray(t), jnp.asarray(q)), _jax_edges(e),
                                         jopts)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), rtol=0, atol=POSE)
    np.testing.assert_allclose(pt.q.numpy(), np.asarray(pj.q), rtol=0, atol=POSE)
    np.testing.assert_allclose(float(ct), float(cj), rtol=COST, atol=1e-20)
    np.testing.assert_array_equal(pt.t[0].numpy(), t[0])
    # the dispatcher on CPU tensors is the stage loop
    pd, cd, itd = tpg.optimize_pose_graph_counted(poses, edges, opts)
    assert torch.equal(pd.t, pt.t) and float(cd) == float(ct) and itd == it
    # the JAX loop ran exactly `it` iterations: capped there it gives the same
    # cost; capped one earlier, before its last accepted step, another
    if it < max_iterations:
        _, c_it = jpg.optimize_pose_graph_jit(JPose(jnp.asarray(t), jnp.asarray(q)),
                                              _jax_edges(e), jpg.PoseGraphOptions(max_iterations=it))
        _, c_before = jpg.optimize_pose_graph_jit(
            JPose(jnp.asarray(t), jnp.asarray(q)), _jax_edges(e),
            jpg.PoseGraphOptions(max_iterations=it - 1))
        assert float(c_it) == float(cj) and float(c_before) != float(cj)
    else:
        assert it == max_iterations


def test_pg_nan_edge_runs_to_the_cap_and_keeps_the_poses_like_jax():
    (t, q), e, _, _ = _pg(8)
    e = list(e)
    e[2] = e[2].copy()
    e[2][3, 1] = np.nan
    poses = TPose(torch.tensor(t), torch.tensor(q))
    edges = interop.pose_graph_edges_from_arrays(*e)
    pt, ct, it = tpg.optimize_pose_graph_counted(poses, edges)
    pj, cj = jpg.optimize_pose_graph_jit(JPose(jnp.asarray(t), jnp.asarray(q)), _jax_edges(e),
                                         jpg.PoseGraphOptions())
    np.testing.assert_array_equal(pt.t.numpy(), t)
    np.testing.assert_array_equal(np.asarray(pj.t), t)
    assert np.isnan(float(ct)) and np.isnan(float(cj))
    assert it == tpg.PoseGraphOptions().max_iterations


def test_pg_step_on_a_done_state_changes_nothing():
    _, _, poses, edges = _pg(8)
    opts = tpg.PoseGraphOptions()
    H, g, scalars = tpg.pg_build_plain(poses, edges, cb.new_scalars(poses.t, opts))
    scalars[cb.G_DONE] = 1.0
    p2, s2 = tpg.pg_step_plain(poses, edges, H, g, scalars, opts)
    assert torch.equal(p2.t, poses.t) and torch.equal(p2.q, poses.q)
    assert torch.equal(s2, scalars)


@pytest.mark.parametrize("n", [8, 64])
def test_pg_cholesky_order_within_the_solves_roundoff(n):
    _, _, poses, edges = _pg(n)
    H, g, scalars = tpg.pg_build_plain(poses, edges, cb.new_scalars(poses.t,
                                                                     tpg.PoseGraphOptions()))
    Hd = bk.damped_system(H, scalars[cb.G_LAM])
    x, ok = bk.pg_cholesky_solve_ordered(Hd, g)
    ref, info = torch.linalg.solve_ex(Hd, g)
    assert ok and int(info) == 0
    d = float((x - ref).abs().max())
    assert d <= bk.step_bound(Hd, ref), (d, bk.step_bound(Hd, ref))
    # an indefinite system: the ordered solve reports it and returns NaN
    bad = Hd.clone()
    bad[7, 7] = -1.0
    xb, okb = bk.pg_cholesky_solve_ordered(bad, g)
    assert not okb and bool(torch.isnan(xb).all())


def test_bindings_refuse_cpu_tensors_and_the_cpu_path_launches_nothing():
    a = bk.pnp_arrays(2, 48, seed=3)
    pts, obs, mask, K, init = bk.pnp_tensors(a)
    with pytest.raises(ValueError, match="not CUDA"):
        cb.pnp_solve_cuda(pts, obs, mask, K, init.t, init.q)
    _, _, poses, edges = _pg(8)
    opts = tpg.PoseGraphOptions()
    with pytest.raises(ValueError, match="not CUDA"):
        cb.PGBinding(poses, edges, opts)
    with pytest.raises(ValueError, match="not CUDA"):
        cb.pg_build_cuda(poses, edges, cb.new_scalars(poses.t, opts), opts)
    cb.zero_launch_counts()
    tgeo.solve_pnp(pts, obs, mask, K, init)
    tgeo.pnp_rounds_row(pts, obs, mask, K, init)
    tpg.optimize_pose_graph_counted(poses, edges, opts)
    assert cb.launch_counts() == {"pnp_solve": 0, "pg_build": 0, "pg_step": 0}
    assert cb._loaded == {}
    # K15's shared memory at the loop benchmark's chain, and its limit
    assert cb.step_smem_bytes(64, 8) == (18 * 64 + 1 + 7 * 64) * 8 <= cb.SMEM_LIMIT
    assert cb.step_smem_bytes(1200, 8) > cb.SMEM_LIMIT
