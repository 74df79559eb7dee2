"""The port's backend solvers (backend/geometry.py, backend/map.py,
backend/ba.py, backend/pose_graph.py) against the JAX package in float64 on
the CPU, from numpy inputs made from a seed: triangulation, PnP, the
bundle adjustment's normal equations and LM loop (iteration counts exact),
the pose graph, and the NaN branches of a failed factorisation."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.backend import ba as jba
from mba_vo_tpu.backend import geometry as jgeo
from mba_vo_tpu.backend import map as jmap
from mba_vo_tpu.backend import pose_graph as jpg
from mba_vo_tpu.core.transform import Pose as JPose
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.backend import ba as tba
from mba_vo_tpu_torch.backend import geometry as tgeo
from mba_vo_tpu_torch.backend import map as tmap
from mba_vo_tpu_torch.backend import pose_graph as tpg
from mba_vo_tpu_torch.core.transform import Pose as TPose

from torch_port_common import npy, random_quats, t64

KVEC = np.array([400.0, 400.0, 319.5, 239.5])


def _qrot_np(q, v):
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _project_np(t, q, X):
    qi = q * np.array([-1.0, -1.0, -1.0, 1.0])
    Pc = _qrot_np(qi, X - t)
    return np.stack([Pc[..., 0] / Pc[..., 2] * KVEC[0] + KVEC[2],
                     Pc[..., 1] / Pc[..., 2] * KVEC[1] + KVEC[3]], axis=-1)


def _qmul_np(q, p):
    return np.asarray(jnp.asarray(np.asarray(
        __import__("mba_vo_tpu.core.lie", fromlist=["x"]).quat_multiply(
            jnp.asarray(q), jnp.asarray(p)))))


def _rel(ta, qa, tb, qb):
    qai = qa * np.array([-1.0, -1.0, -1.0, 1.0])
    return _qrot_np(qai, tb - ta), _qmul_np(qai, qb)


def ba_arrays(W=4, M=64, dead=8, seed=0, outliers=2, pose_pad=0):
    """A window of W cameras on an arc over a landmark cloud: noisy,
    partly missing observations with gross outliers, perturbed poses and
    points, odometry priors from slightly noisy true relative poses, `dead`
    padded landmark slots and `pose_pad` padded poses at the end."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1.0, 1.0, M),
                  rng.uniform(3.0, 6.0, M)], axis=-1)
    ts = np.stack([np.array([0.15 * w, 0.02 * w, 0.05 * w]) for w in range(W)])
    qs = random_quats(rng, W, 0.03)
    obs = np.stack([_project_np(ts[w], qs[w], X) for w in range(W)])
    obs = obs + rng.normal(0, 0.5, obs.shape)
    obs_mask = (rng.random((W, M)) > 0.2).astype(np.float64)
    obs[1, :outliers] += 40.0
    point_mask = np.ones(M)
    point_mask[M - dead:] = 0.0
    pose_mask = np.ones(W)
    if pose_pad:
        pose_mask[W - pose_pad:] = 0.0
        obs_mask[W - pose_pad:] = 0.0
    odom_t, odom_q = [], []
    for w in range(W - 1):
        dt, dq = _rel(ts[w], qs[w], ts[w + 1], qs[w + 1])
        odom_t.append(dt + rng.normal(0, 1e-3, 3))
        odom_q.append(dq)
    odom_w = np.full(W - 1, 1e3)
    if pose_pad:
        odom_w[W - 1 - pose_pad:] = 0.0
    init_t = ts + rng.normal(0, 0.02, ts.shape) * (np.arange(W) > 0)[:, None]
    init_q = np.stack([_qmul_np(qs[w], random_quats(rng, 1, 0.01)[0]) if w else qs[w]
                       for w in range(W)])
    init_X = X + rng.normal(0, 0.05, X.shape)
    return dict(pose_t=init_t, pose_q=init_q, points=init_X, obs_xy=obs,
                obs_mask=obs_mask, K=KVEC, point_mask=point_mask,
                odom=(np.asarray(odom_t), np.asarray(odom_q), odom_w),
                pose_mask=pose_mask)


def jax_problem(a):
    return jba.BAProblem(
        poses=JPose(t=jnp.asarray(a["pose_t"]), q=jnp.asarray(a["pose_q"])),
        map=jmap.make_map(a["points"], a["obs_xy"], a["obs_mask"], a["point_mask"]),
        K=jnp.asarray(a["K"]),
        odom=jba.OdomPrior(*(jnp.asarray(x) for x in a["odom"])),
        pose_mask=jnp.asarray(a["pose_mask"]),
    )


@pytest.fixture(scope="module")
def ba_case():
    a = ba_arrays()
    return a, jax_problem(a), interop.ba_problem_from_arrays(**a)


def test_map_helpers_match():
    rng = np.random.default_rng(3)
    pts, obs, om = rng.normal(size=(5, 3)), rng.normal(size=(2, 5, 2)), np.ones((2, 5))
    jm = jmap.pad_map(jmap.make_map(jnp.asarray(pts), obs, om), 9)
    tm = tmap.pad_map(tmap.make_map(t64(pts), t64(obs), t64(om)), 9)
    for f in jm._fields:
        np.testing.assert_array_equal(npy(getattr(tm, f)), np.asarray(getattr(jm, f)))
    assert tm.num_points == 9 and tm.window_size == 2


def test_two_view_matrices_match():
    rng = np.random.default_rng(4)
    q = random_quats(rng, 1, 0.2)[0]
    R = np.asarray(__import__("mba_vo_tpu.core.lie", fromlist=["x"]).quat_rotate(
        jnp.asarray(q)[None], jnp.eye(3))).T
    t = rng.normal(size=3)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    Kinv = np.linalg.inv(np.array([[400.0, 0, 320], [0, 410.0, 240], [0, 0, 1]]))
    np.testing.assert_allclose(npy(tgeo.essential_matrix(t64(R), t64(t))),
                               np.asarray(jgeo.essential_matrix(jnp.asarray(R), jnp.asarray(t))),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        npy(tgeo.fundamental_matrix(t64(Kinv), t64(T), t64(Kinv))),
        np.asarray(jgeo.fundamental_matrix(jnp.asarray(Kinv), jnp.asarray(T),
                                           jnp.asarray(Kinv))), rtol=0, atol=1e-15)
    np.testing.assert_allclose(
        npy(tgeo.projection_matrix(t64(KVEC), t64(R), t64(t))),
        np.asarray(jgeo.projection_matrix(jnp.asarray(KVEC), jnp.asarray(R), jnp.asarray(t))),
        rtol=0, atol=1e-12)


def test_triangulate_points_match():
    rng = np.random.default_rng(5)
    X = np.stack([rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40), rng.uniform(2, 5, 40)], -1)
    qs = random_quats(rng, 2, 0.05)
    ts = np.array([[0.0, 0.0, 0.0], [0.3, -0.05, 0.02]])
    x1 = _project_np(ts[0], qs[0], X) + rng.normal(0, 0.3, (40, 2))
    x2 = _project_np(ts[1], qs[1], X) + rng.normal(0, 0.3, (40, 2))
    Ps = []
    for w in range(2):
        qi = qs[w] * np.array([-1.0, -1.0, -1.0, 1.0])
        R = np.stack([_qrot_np(qi, e) for e in np.eye(3)], axis=1)
        Ps.append((R, -_qrot_np(qi, ts[w])))
    jP = [jgeo.projection_matrix(jnp.asarray(KVEC), jnp.asarray(R), jnp.asarray(t))
          for R, t in Ps]
    tP = [tgeo.projection_matrix(t64(KVEC), t64(R), t64(t)) for R, t in Ps]
    xj = np.asarray(jgeo.triangulate_points(*jP, jnp.asarray(x1), jnp.asarray(x2)))
    xt = npy(tgeo.triangulate_points(*tP, t64(x1), t64(x2)))
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
    assert np.abs(xt - X).max() < 0.2


def pnp_arrays(seed=6, n=48, live=40, nan_row=False):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), rng.uniform(2, 5, n)], -1)
    t_true, q_true = np.array([0.1, -0.05, 0.2]), random_quats(rng, 1, 0.05)[0]
    obs = _project_np(t_true, q_true, X) + rng.normal(0, 0.5, (n, 2))
    obs[:3] += 30.0                      # outliers the Huber loss down-weights
    obs[live:] += 500.0                  # garbage, masked out
    mask = (np.arange(n) < live).astype(np.float64)
    if nan_row:
        X[5, 0] = np.nan
    init = (t_true + rng.normal(0, 0.05, 3), q_true * 0 + random_quats(rng, 1, 0.05)[0])
    return X, obs, mask, init


@pytest.mark.parametrize("iterations", [3, 30])
def test_solve_pnp_matches(iterations):
    X, obs, mask, (t0, q0) = pnp_arrays()
    pj, cj = jgeo.solve_pnp_jit(jnp.asarray(X), jnp.asarray(obs), jnp.asarray(mask),
                            jnp.asarray(KVEC), JPose(jnp.asarray(t0), jnp.asarray(q0)),
                            2.0, iterations)
    pt, ct = tgeo.solve_pnp(t64(X), t64(obs), t64(mask), t64(KVEC),
                            TPose(t64(t0), t64(q0)), 2.0, iterations)
    np.testing.assert_allclose(npy(pt.t), np.asarray(pj.t), rtol=0, atol=1e-9)
    np.testing.assert_allclose(npy(pt.q), np.asarray(pj.q), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-9)
    nj = jgeo.pnp_residual_norms(jnp.asarray(X), jnp.asarray(obs), jnp.asarray(KVEC), pj)
    nt = tgeo.pnp_residual_norms(t64(X), t64(obs), t64(KVEC), pt)
    np.testing.assert_allclose(npy(nt), np.asarray(nj), rtol=1e-9, atol=1e-8)


def test_normal_equations_match(ba_case):
    _, pj, pt = ba_case
    outj = jax.jit(jba.build_normal_equations, static_argnums=1)(pj, 2.0)
    outt = tba.build_normal_equations(pt, 2.0)
    for name, a, b in zip(("cost", "U", "V", "W", "g_p", "g_x", "H_odom", "mask"),
                          outj, outt):
        a = np.asarray(a)
        np.testing.assert_allclose(npy(b), a, rtol=1e-9, atol=1e-9 * max(1.0, np.abs(a).max()),
                                   err_msg=name)
    np.testing.assert_allclose(float(tba.evaluate_cost(pt, 2.0)),
                               float(jax.jit(jba.evaluate_cost, static_argnums=1)(pj, 2.0)), rtol=1e-12)


@pytest.mark.parametrize("pose_pad", [0, 1])
def test_run_bundle_adjustment_matches(pose_pad):
    a = ba_arrays(pose_pad=pose_pad, seed=pose_pad)
    opts = jba.BAOptions(max_iterations=12)
    rj, sj = jba.run_bundle_adjustment_jit(jax_problem(a), opts)
    rt, st = tba.run_bundle_adjustment(interop.ba_problem_from_arrays(**a),
                                       tba.BAOptions(max_iterations=12))
    assert st.num_iterations == int(sj.num_iterations)
    assert 2 <= st.num_iterations
    np.testing.assert_allclose(float(st.initial_cost), float(sj.initial_cost), rtol=1e-12)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost), rtol=1e-9)
    assert float(st.final_cost) < 0.5 * float(st.initial_cost)
    np.testing.assert_allclose(npy(rt.poses.t), np.asarray(rj.poses.t), rtol=0, atol=1e-9)
    np.testing.assert_allclose(npy(rt.poses.q), np.asarray(rj.poses.q), rtol=0, atol=1e-9)
    np.testing.assert_allclose(npy(rt.map.points), np.asarray(rj.map.points), rtol=0, atol=1e-9)
    # padded landmark slots and padded poses do not move
    assert np.array_equal(npy(rt.map.points)[-8:], a["points"][-8:])
    if pose_pad:
        assert np.array_equal(npy(rt.poses.t)[-1], a["pose_t"][-1])


def test_run_bundle_adjustment_stops_like_jax_at_every_depth(ba_case):
    """The iteration count is exact for every cap of the loop, including
    caps the convergence test ends before."""
    _, pj, pt = ba_case
    for cap in (1, 3):
        _, sj = jba.run_bundle_adjustment_jit(pj, jba.BAOptions(max_iterations=cap))
        _, st = tba.run_bundle_adjustment(pt, tba.BAOptions(max_iterations=cap))
        assert st.num_iterations == int(sj.num_iterations) == cap
        np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost), rtol=1e-9)


def pg_arrays(N=8, noise=0.05, seed=4):
    """A drifted chain of N poses with noisy odometry edges and one loop
    edge 0 -> N-1 of weight 5 (an inconsistent graph: its optimum has a
    positive cost, so the stop test reads a real relative decrease)."""
    rng = np.random.default_rng(seed)
    ts, qs = [np.zeros(3)], [np.array([0.0, 0.0, 0.0, 1.0])]
    step_q = random_quats(rng, 1, 0.06)[0]
    for i in range(1, N):
        ts.append(ts[-1] + np.array([0.5, 0.05 * np.sin(i), 0.0]))
        qs.append(_qmul_np(qs[-1], step_q))
    ii, jj, t_ij, q_ij = [], [], [], []
    for i, j in [(i, i + 1) for i in range(N - 1)] + [(0, N - 1)]:
        dt, dq = _rel(ts[i], qs[i], ts[j], qs[j])
        dq = _qmul_np(dq, random_quats(rng, 1, 0.01)[0])
        ii.append(i), jj.append(j), t_ij.append(dt + rng.normal(0, 0.02, 3)), q_ij.append(dq)
    w = np.ones(len(ii))
    w[-1] = 5.0
    tn = np.stack([ts[i] + rng.normal(0, noise, 3) * (i > 0) for i in range(N)])
    qn = np.stack([_qmul_np(qs[i], random_quats(rng, 1, noise)[0]) if i else qs[0]
                   for i in range(N)])
    return (tn, qn), (np.asarray(ii), np.asarray(jj), np.stack(t_ij), np.stack(q_ij), w)


def jax_edges(e):
    i, j, t_ij, q_ij, w = e
    return jpg.PoseGraphEdge(i=jnp.asarray(i, jnp.int32), j=jnp.asarray(j, jnp.int32),
                             t_ij=jnp.asarray(t_ij), q_ij=jnp.asarray(q_ij),
                             weight=jnp.asarray(w))


def test_optimize_pose_graph_matches():
    (tn, qn), e = pg_arrays()
    pj, cj = jpg.optimize_pose_graph_jit(JPose(jnp.asarray(tn), jnp.asarray(qn)), jax_edges(e),
                                       jpg.PoseGraphOptions())
    pt, ct, it = tpg.optimize_pose_graph_counted(
        TPose(t64(tn), t64(qn)), interop.pose_graph_edges_from_arrays(*e))
    np.testing.assert_allclose(npy(pt.t), np.asarray(pj.t), rtol=0, atol=1e-9)
    np.testing.assert_allclose(npy(pt.q), np.asarray(pj.q), rtol=0, atol=1e-9)
    np.testing.assert_allclose(float(ct), float(cj), rtol=1e-9, atol=1e-20)
    np.testing.assert_array_equal(npy(pt.t)[0], tn[0])
    # the JAX loop ran exactly `it` iterations: capped there it gives the
    # same result, capped one earlier it stops before its last accepted step
    assert 1 < it < jpg.PoseGraphOptions().max_iterations
    at_it, c_it = jpg.optimize_pose_graph_jit(JPose(jnp.asarray(tn), jnp.asarray(qn)),
                                          jax_edges(e), jpg.PoseGraphOptions(max_iterations=it))
    _, c_before = jpg.optimize_pose_graph_jit(JPose(jnp.asarray(tn), jnp.asarray(qn)),
                                          jax_edges(e),
                                          jpg.PoseGraphOptions(max_iterations=it - 1))
    assert float(c_it) == float(cj) and float(c_before) != float(cj)
    pw, cw = tpg.optimize_pose_graph(TPose(t64(tn), t64(qn)),
                                     interop.pose_graph_edges_from_arrays(*e))
    assert torch.equal(pw.t, pt.t) and float(cw) == float(ct)
    rj = jpg.edge_residuals(pj, jax_edges(e))
    rt = tpg.edge_residuals(pt, interop.pose_graph_edges_from_arrays(*e))
    np.testing.assert_allclose(npy(rt), np.asarray(rj), rtol=0, atol=1e-9)


# ----------------------------------------------- failed factorisations (NaN)


def test_schur_solve_non_positive_definite_gives_nan_like_jax(ba_case):
    """A reduced camera system that is not positive definite: JAX's
    Cholesky returns NaN, torch's cholesky_ex reports it and the port
    writes NaN, so the LM loop rejects the step in both."""
    _, pj, pt = ba_case
    _, U, V, Wb, g_p, g_x, H_o, _ = jax.jit(jba.build_normal_equations, static_argnums=1)(pj, 2.0)
    U = -U * 10.0                                    # negative-definite pose blocks
    lam = 1e-4
    dj, xj = jba.schur_solve(U, V, Wb, g_p, g_x, jnp.asarray(lam), jba.BAOptions(),
                             H_pose=H_o, pose_mask=pj.pose_mask)
    dt, xt = tba.schur_solve(t64(U), t64(V), t64(Wb), t64(g_p), t64(g_x),
                             t64(lam), tba.BAOptions(), H_pose=t64(H_o),
                             pose_mask=pt.pose_mask)
    gauge = np.asarray(pj.pose_mask) * (np.arange(4) > 0)
    assert np.isnan(np.asarray(dj)[gauge > 0]).all()
    np.testing.assert_array_equal(np.isnan(npy(dt)), np.isnan(np.asarray(dj)))
    np.testing.assert_array_equal(np.isnan(npy(xt)), np.isnan(np.asarray(xj)))


def test_schur_solve_positive_definite_matches(ba_case):
    _, pj, pt = ba_case
    _, U, V, Wb, g_p, g_x, H_o, _ = jax.jit(jba.build_normal_equations, static_argnums=1)(pj, 2.0)
    dj, xj = jba.schur_solve(U, V, Wb, g_p, g_x, jnp.asarray(1e-3), jba.BAOptions(),
                             H_pose=H_o, pose_mask=pj.pose_mask)
    dt, xt = tba.schur_solve(t64(U), t64(V), t64(Wb), t64(g_p), t64(g_x), t64(1e-3),
                             tba.BAOptions(), H_pose=t64(H_o), pose_mask=pt.pose_mask)
    np.testing.assert_allclose(npy(dt), np.asarray(dj), rtol=0, atol=1e-9)
    np.testing.assert_allclose(npy(xt), np.asarray(xj), rtol=0, atol=1e-9)


def test_pose_graph_singular_system_keeps_the_poses_like_jax():
    """A NaN edge measurement: the damped system is NaN, jnp.linalg.solve
    returns NaN and torch's solve_ex result is NaN too; every step is
    rejected and both return the initial poses."""
    (tn, qn), e = pg_arrays(N=5)
    e = list(e)
    e[2] = e[2].copy()
    e[2][1, 0] = np.nan
    pj, cj = jpg.optimize_pose_graph_jit(JPose(jnp.asarray(tn), jnp.asarray(qn)), jax_edges(e),
                                       jpg.PoseGraphOptions())
    pt, ct, it = tpg.optimize_pose_graph_counted(
        TPose(t64(tn), t64(qn)), interop.pose_graph_edges_from_arrays(*e))
    np.testing.assert_array_equal(np.asarray(pj.t), tn)
    np.testing.assert_array_equal(npy(pt.t), tn)
    assert np.isnan(float(cj)) and np.isnan(float(ct))
    assert it == tpg.PoseGraphOptions().max_iterations


def test_pnp_with_a_nan_point_keeps_the_init_like_jax():
    X, obs, mask, (t0, q0) = pnp_arrays(nan_row=True)
    pj, cj = jgeo.solve_pnp_jit(jnp.asarray(X), jnp.asarray(obs), jnp.asarray(mask),
                            jnp.asarray(KVEC), JPose(jnp.asarray(t0), jnp.asarray(q0)), 2.0, 5)
    pt, ct = tgeo.solve_pnp(t64(X), t64(obs), t64(mask), t64(KVEC),
                            TPose(t64(t0), t64(q0)), 2.0, 5)
    np.testing.assert_array_equal(np.asarray(pj.t), t0)
    np.testing.assert_array_equal(npy(pt.t), t0)
    assert np.isnan(float(cj)) and np.isnan(float(ct))


@pytest.mark.parametrize("angle", [0.0, 1e-12, 1e-3, 0.3, 2.0])
def test_relative_pose_jacobians_match_forward_ad(angle):
    """The written-out Jacobians of log(T_m^-1 (T_i^-1 T_j)) (the odometry
    prior's and the pose graph's) against forward-mode AD through the
    port's own residual, from an error rotation of exactly zero (the small
    branch) to 2 rad."""
    rng = np.random.default_rng(int(angle * 1e3) + 7)
    n = 5
    ti, tj = rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, 3))
    qi, qj = random_quats(rng, n, 0.4), random_quats(rng, n, 0.4)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    rel_t, rel_q = _rel(ti, qi, tj, qj)
    err_q = np.asarray(jnp.asarray(np.asarray(__import__(
        "mba_vo_tpu.core.lie", fromlist=["x"]).quat_exp(jnp.asarray(axis * angle)))))
    tm = rel_t + rng.normal(0, 0.05, (n, 3))
    qm = _qmul_np(rel_q, err_q * np.array([-1.0, -1.0, -1.0, 1.0]))
    args = [t64(x) for x in (ti, qi, tj, qj, tm, qm)]
    r, J_i, J_j = tba.relative_pose_jacobians(*args)
    edges = tpg.PoseGraphEdge(i=torch.arange(n), j=torch.arange(n) + n, t_ij=args[4],
                              q_ij=args[5], weight=torch.ones(n, dtype=torch.float64))
    poses = TPose(torch.cat([args[0], args[2]]), torch.cat([args[1], args[3]]))
    J = torch.func.jacfwd(lambda d: tpg.edge_residuals(tba.retract(poses, d), edges))(
        torch.zeros(2 * n, 6, dtype=torch.float64))
    np.testing.assert_allclose(npy(r), npy(tpg.edge_residuals(poses, edges)), rtol=0,
                               atol=1e-14)
    e = np.arange(n)
    np.testing.assert_allclose(npy(J_i), npy(J)[e, :, e], rtol=0, atol=1e-9)
    np.testing.assert_allclose(npy(J_j), npy(J)[e, :, e + n], rtol=0, atol=1e-9)
