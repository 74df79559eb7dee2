"""The plain versions of the bundle adjustment's kernels K10-K12
(backend/ba.py's ba_build_plain, ba_step_plain and ba_commit_plain) against
the JAX package's functions they stand for, on the CPU in float64, from
windows made with numpy from a seed (W = 4 poses, M <= 48 landmark slots):
the normal equations (1e-9 of each block's magnitude, costs 1e-12), the
Schur step and its candidate (1e-9), the decision and commit, the composed
stage loop against ``run_bundle_adjustment_jit`` (equal iteration counts,
final cost 1e-9), on a padded pose, dead landmark slots, outliers past the
Huber knee, a landmark behind the cameras (the depth clamp), no odometry
prior, and a non-positive-definite reduced system whose NaN step the
commit rejects. Then what the CPU can check of the kernels' binding
(ops/cuda_ba.py): its layout (K12's cluster and shared memory among it)
and its refusal of CPU tensors. The kernels
themselves are held to these plain versions on the card
(tests/test_torch_cuda_ba.py, chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.backend import ba as jba
from mba_vo_tpu.backend import map as jmap
from mba_vo_tpu.core.transform import Pose as JPose
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.backend import ba as tba
from mba_vo_tpu_torch.ops import cuda_ba

from torch_port_common import npy, random_quats, t64

KVEC = np.array([400.0, 400.0, 319.5, 239.5])
BLOCKS = 1e-9
COSTS = 1e-12


def _qrot(q, v):
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _qmul(a, b):
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack([aw * bx + ax * bw + ay * bz - az * by, aw * by + ay * bw + az * bx - ax * bz,
                     aw * bz + az * bw + ax * by - ay * bx, aw * bw - ax * bx - ay * by - az * bz],
                    -1)


def window(seed=0, W=4, M=48, dead=8, pose_pad=1, odom=True, pose_mask=True, behind=True):
    """W cameras on an arc over M landmark slots (the last ``dead`` padding),
    noisy and partly missing observations, two outliers 40 px off, with
    ``behind`` a landmark behind the cameras, ``pose_pad`` padded poses at
    the end, odometry priors from slightly noisy true relative poses (or
    none), perturbed starts."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1.0, 1.0, M),
                  rng.uniform(3.0, 6.0, M)], axis=-1)
    ts = np.stack([[0.15 * w, 0.02 * w, 0.05 * w] for w in range(W)])
    qs = random_quats(rng, W, 0.03)
    qi = qs * np.array([-1.0, -1.0, -1.0, 1.0])
    Pc = np.stack([_qrot(qi[w][None], X - ts[w]) for w in range(W)])
    obs = np.stack([Pc[..., 0] / Pc[..., 2] * KVEC[0] + KVEC[2],
                    Pc[..., 1] / Pc[..., 2] * KVEC[1] + KVEC[3]], -1)
    obs = obs + rng.normal(0, 0.5, obs.shape)
    obs[1, :2] += 40.0
    if behind:
        X[3] = [0.1, 0.0, -1.0]
    obs_mask = (rng.random((W, M)) > 0.2).astype(np.float64)
    point_mask = np.ones(M)
    point_mask[M - dead:] = 0.0
    pm = np.ones(W)
    w_o = np.full(W - 1, 1e3)
    if pose_pad:
        pm[W - pose_pad:] = 0.0
        obs_mask[W - pose_pad:] = 0.0
        w_o[W - 1 - pose_pad:] = 0.0
    rel_t = np.stack([_qrot(qi[w], ts[w + 1] - ts[w]) for w in range(W - 1)])
    rel_q = np.stack([_qmul(qi[w], qs[w + 1]) for w in range(W - 1)])
    init_q = np.concatenate([qs[:1], _qmul(qs[1:], random_quats(rng, W - 1, 0.01))])
    return dict(pose_t=ts + rng.normal(0, 0.02, ts.shape) * (np.arange(W) > 0)[:, None],
                pose_q=init_q, points=X + rng.normal(0, 0.05, X.shape), obs_xy=obs,
                obs_mask=obs_mask, K=KVEC, point_mask=point_mask,
                odom=(rel_t + rng.normal(0, 1e-3, rel_t.shape), rel_q, w_o) if odom else None,
                pose_mask=pm if pose_mask else None)


CASES = {"padded pose, dead slots, outliers, behind": {},
         "no odometry, no pose mask": dict(odom=False, pose_mask=False, pose_pad=0, seed=1),
         "converging": dict(behind=False, seed=2)}


def jax_problem(a):
    return jba.BAProblem(
        poses=JPose(t=jnp.asarray(a["pose_t"]), q=jnp.asarray(a["pose_q"])),
        map=jmap.make_map(a["points"], a["obs_xy"], a["obs_mask"], a["point_mask"]),
        K=jnp.asarray(a["K"]),
        odom=None if a["odom"] is None else jba.OdomPrior(*(jnp.asarray(x) for x in a["odom"])),
        pose_mask=None if a["pose_mask"] is None else jnp.asarray(a["pose_mask"]))


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    a = window(**CASES[request.param])
    return a, jax_problem(a), interop.ba_problem_from_arrays(**a)


_jbuild = jax.jit(jba.build_normal_equations, static_argnums=1)
_jcost = jax.jit(jba.evaluate_cost, static_argnums=1)


def _close(got, want, bound, name):
    want = np.asarray(want)
    np.testing.assert_allclose(npy(got), want, rtol=0,
                               atol=bound * max(1.0, np.abs(want).max()), err_msg=name)


def test_build_matches_jax(case):
    """K10's plain version: the cost, U, V, W_blk, g_p, g_x and the prior's
    H; and the loop's initial scalars (the initial cost, evaluate_cost's)."""
    a, pj, pt = case
    outj = _jbuild(pj, 2.0)
    outt = tba.ba_build_plain(pt, 2.0)
    assert len(outt) == 7
    for name, got, want in zip(("cost", "U", "V", "W_blk", "g_p", "g_x", "H_odom"), outt, outj):
        _close(got, want, COSTS if name == "cost" else BLOCKS, name)
    sc = tba.ba_initial_scalars(pt, tba.BAOptions())
    c0 = float(_jcost(pj, 2.0))
    np.testing.assert_allclose(float(sc[cuda_ba.B_COST0]), c0, rtol=COSTS)
    assert float(sc[cuda_ba.B_COST]) == float(sc[cuda_ba.B_COST0])
    assert float(sc[cuda_ba.B_LAM]) == tba.BAOptions().initial_lambda
    assert sc.shape == (cuda_ba.B_SIZE,) and float(sc[cuda_ba.B_IT]) == 0.0


@jax.jit
def _jax_step_jit(pj, outj, lam):
    _, U, V, Wb, g_p, g_x, H_o, _ = outj
    dp, dx = jba.schur_solve(U, V, Wb, g_p, g_x, lam, jba.BAOptions(), H_pose=H_o,
                             pose_mask=pj.pose_mask)
    return dp, dx, jba._apply_step(pj, dp, dx)


def _jax_step(pj, outj, lam):
    return _jax_step_jit(pj, tuple(outj), jnp.asarray(lam, jnp.float64))


def test_step_matches_jax(case):
    """K11's plain version on the same normal equations: dp, dx and the
    candidate poses and points; padded poses and dead slots do not move."""
    a, pj, pt = case
    outj = _jbuild(pj, 2.0)
    lam = 1e-3
    dj, xj, cj = _jax_step(pj, outj, lam)
    sc = tba.ba_initial_scalars(pt, tba.BAOptions())
    sc[cuda_ba.B_LAM] = lam
    built = tuple(t64(x) for x in outj[:7])
    dp, dx, ct, cq, cX = tba.ba_step_plain(pt, sc, built, tba.BAOptions())
    for name, got, want in (("dp", dp, dj), ("dx", dx, xj), ("cand t", ct, cj.poses.t),
                            ("cand q", cq, cj.poses.q), ("cand X", cX, cj.map.points)):
        _close(got, want, BLOCKS, name)
    assert np.array_equal(npy(cX)[-8:], a["points"][-8:])
    assert np.all(npy(dp)[0] == 0.0)
    if a["pose_mask"] is not None and a["pose_mask"][-1] == 0.0:
        assert np.array_equal(npy(ct)[-1], a["pose_t"][-1])


def _jax_commit(pj, cand, dp, dx, cost, lam, opts=jba.BAOptions()):
    """The reference loop body's decision and commit, written out as
    mba_vo_tpu/backend/ba.py's ``body`` takes it."""
    cand_cost = _jcost(cand, opts.huber_a)
    ok = (cand_cost < cost) & jnp.all(jnp.isfinite(dp)) & jnp.all(jnp.isfinite(dx))
    rel = (cost - cand_cost) / jnp.maximum(cost, 1e-24)
    new = jax.tree.map(lambda x, y: jnp.where(ok, x, y), cand, pj)
    new_lam = jnp.where(ok, jnp.maximum(lam * opts.lambda_down, opts.min_lambda),
                        jnp.minimum(lam * opts.lambda_up, opts.max_lambda))
    done = ok & (rel < opts.min_rel_decrease)
    return new, jnp.where(ok, cand_cost, cost), new_lam, ok, done, cand_cost, rel


@pytest.mark.parametrize("lam", [1e-3, 1e6])
def test_commit_matches_jax(case, lam):
    """K12's plain version on the candidate of a small and of a large
    damping: the candidate's cost, ok, the relative decrease, the selected
    poses and points, lambda, the cost, the iteration count and done."""
    a, pj, pt = case
    outj = _jbuild(pj, 2.0)
    dj, xj, cj = _jax_step(pj, outj, lam)
    cost = _jcost(pj, 2.0)
    sc = tba.ba_initial_scalars(pt, tba.BAOptions())
    sc[cuda_ba.B_LAM] = lam
    cand = (t64(dj), t64(xj), t64(cj.poses.t), t64(cj.poses.q), t64(cj.map.points))
    new_t, sc2 = tba.ba_commit_plain(pt, sc, cand, tba.BAOptions())
    nj, cost_j, lam_j, ok_j, done_j, cand_j, rel_j = _jax_commit(pj, cj, dj, xj, cost,
                                                                 jnp.asarray(lam))
    assert float(sc2[cuda_ba.B_OK]) == float(ok_j) and float(sc2[cuda_ba.B_DONE]) == float(done_j)
    np.testing.assert_allclose(float(sc2[cuda_ba.B_CAND_COST]), float(cand_j), rtol=COSTS)
    np.testing.assert_allclose(float(sc2[cuda_ba.B_COST]), float(cost_j), rtol=COSTS)
    np.testing.assert_allclose(float(sc2[cuda_ba.B_REL]), float(rel_j), rtol=0, atol=COSTS)
    assert float(sc2[cuda_ba.B_LAM]) == float(lam_j) and float(sc2[cuda_ba.B_IT]) == 1.0
    assert float(sc2[cuda_ba.B_COST0]) == float(sc[cuda_ba.B_COST0])
    for name, got, want in (("t", new_t.poses.t, nj.poses.t), ("q", new_t.poses.q, nj.poses.q),
                            ("X", new_t.map.points, nj.map.points)):
        _close(got, want, BLOCKS, name)


def test_a_non_positive_definite_system_gives_a_nan_step_the_commit_rejects(case):
    """Negative-definite pose blocks: the Cholesky fails, the step is NaN in
    both packages (the same entries), and the commit rejects it: the state
    stays, lambda grows, the iteration counts."""
    a, pj, pt = case
    outj = list(_jbuild(pj, 2.0))
    outj[1] = -10.0 * outj[1]
    dj, xj, cj = _jax_step(pj, outj, 1e-4)
    sc = tba.ba_initial_scalars(pt, tba.BAOptions())
    built = tuple(t64(x) for x in outj[:7])
    cand = tba.ba_step_plain(pt, sc, built, tba.BAOptions())
    assert np.isnan(npy(cand[0])).all()
    np.testing.assert_array_equal(np.isnan(npy(cand[0])), np.isnan(np.asarray(dj)))
    np.testing.assert_array_equal(np.isnan(npy(cand[1])), np.isnan(np.asarray(xj)))
    new, sc2 = tba.ba_commit_plain(pt, sc, cand, tba.BAOptions())
    assert float(sc2[cuda_ba.B_OK]) == 0.0 and float(sc2[cuda_ba.B_DONE]) == 0.0
    assert float(sc2[cuda_ba.B_COST]) == float(sc[cuda_ba.B_COST])
    assert float(sc2[cuda_ba.B_LAM]) == float(sc[cuda_ba.B_LAM]) * tba.BAOptions().lambda_up
    assert float(sc2[cuda_ba.B_IT]) == 1.0
    for got, want in ((new.poses.t, pt.poses.t), (new.poses.q, pt.poses.q),
                      (new.map.points, pt.map.points)):
        assert torch.equal(got, want)


def test_a_done_state_does_not_change(case):
    """After the loop's stop nothing changes (the reference's while_loop
    runs no more bodies): a commit on scalars already done returns them
    and the problem as they are."""
    a, pj, pt = case
    sc = tba.ba_initial_scalars(pt, tba.BAOptions())
    built = tba.ba_build_plain(pt, 2.0)
    cand = tba.ba_step_plain(pt, sc, built, tba.BAOptions())
    sc[cuda_ba.B_DONE] = 1.0
    new, sc2 = tba.ba_commit_plain(pt, sc, cand, tba.BAOptions())
    assert torch.equal(sc2, sc)
    assert new.poses.t is pt.poses.t or torch.equal(new.poses.t, pt.poses.t)
    assert torch.equal(new.map.points, pt.map.points)


@pytest.mark.parametrize("cap", [20])
def test_stage_loop_matches_jax(case, cap):
    """The composed stage loop (run_bundle_adjustment on the CPU) against
    run_bundle_adjustment_jit: equal iteration counts at every cap, the
    initial cost to 1e-12, the final cost to 1e-9, poses and points to
    1e-9 where the window converges."""
    a, pj, pt = case
    rj, sj = jba.run_bundle_adjustment_jit(pj, jba.BAOptions(max_iterations=cap))
    rt, st = tba.run_bundle_adjustment(pt, tba.BAOptions(max_iterations=cap))
    assert st.num_iterations == int(sj.num_iterations)
    np.testing.assert_allclose(float(st.initial_cost), float(sj.initial_cost), rtol=COSTS)
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost), rtol=BLOCKS)
    if st.num_iterations < 20:
        for name, got, want in (("t", rt.poses.t, rj.poses.t), ("X", rt.map.points,
                                                                 rj.map.points)):
            _close(got, want, BLOCKS, name)


def test_the_stage_loop_stops_like_jax_at_a_cap():
    """A cap the loop reaches before it converges: both stop there."""
    a = window()
    _, sj = jba.run_bundle_adjustment_jit(jax_problem(a), jba.BAOptions(max_iterations=2))
    _, st = tba.run_bundle_adjustment(interop.ba_problem_from_arrays(**a),
                                      tba.BAOptions(max_iterations=2))
    assert st.num_iterations == int(sj.num_iterations) == 2
    np.testing.assert_allclose(float(st.final_cost), float(sj.final_cost), rtol=BLOCKS)


def test_the_cpu_path_runs_the_plain_stages(monkeypatch):
    """On CPU tensors the loop never binds the kernels."""
    def refuse(*args, **kw):
        raise AssertionError("the kernels' binding on CPU tensors")

    monkeypatch.setattr(cuda_ba, "BABinding", refuse)
    a = window(**CASES["converging"])
    out, s = tba.run_bundle_adjustment(interop.ba_problem_from_arrays(**a), tba.BAOptions())
    assert 1 <= s.num_iterations < 20 and float(s.final_cost) < float(s.initial_cost)


def test_the_binding_refuses_cpu_tensors():
    """The kernels take CUDA tensors only: the binding raises on a CPU
    problem before anything is built or launched, as every wrapper of the
    port does."""
    p = interop.ba_problem_from_arrays(**window())
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_ba.BABinding(p, tba.BAOptions())
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_ba.ba_build_cuda(p, p.poses.t.new_zeros(cuda_ba.B_SIZE), tba.BAOptions())


@pytest.mark.parametrize("W,itemsize,MB,shared", [(7, 8, 32, True), (7, 4, 32, True),
                                                   (30, 8, 11, False), (30, 4, 22, True),
                                                   (60, 8, 5, False)])
def test_the_layout(W, itemsize, MB, shared):
    """The kernels' split of the landmarks: 32 a CTA at the default window,
    fewer where K11's slice of W_blk and W V^-1 would pass its budget; S in
    shared memory while K11's last phase fits a CTA's 227 KiB."""
    lay = cuda_ba.ba_layout(W, 512, itemsize)
    assert lay == cuda_ba.BALayout(MB, -(-512 // MB), shared)
    first = (36 * W * MB + 12 * MB) * itemsize
    assert first <= cuda_ba.SLICE_SMEM_BUDGET
    assert cuda_ba.step_smem_bytes(W, MB, itemsize, shared) <= cuda_ba.SMEM_LIMIT


@pytest.mark.parametrize("W,itemsize", [(7, 8), (7, 4), (30, 8), (30, 4), (60, 8)])
def test_the_cooperative_step_fits_and_its_grid_is_checked(W, itemsize):
    """K11's cooperative design keeps the slice's gauged W_blk, V^-1 and g_x
    beside the room W V^-1 and then the solve share (S with its right-hand
    side where it lives in shared memory); at 512 slots the grid is
    resident at once by shared memory alone on 132 SMs, and the binding's
    check raises on a grid past what the SMs hold."""
    lay = cuda_ba.ba_layout(W, 512, itemsize)
    MB, D = lay.landmarks_per_cta, 6 * W
    keep = (18 * W * MB + 12 * MB) * itemsize
    smem = cuda_ba.step_smem_bytes(W, MB, itemsize, lay.s_shared)
    assert smem == keep + max(18 * W * MB * itemsize,
                              (((D + 1) * D if lay.s_shared else 0) + 2 * D + W) * itemsize)
    assert smem <= cuda_ba.SMEM_LIMIT
    assert cuda_ba.step_smem_bytes(W, MB, itemsize, True) > cuda_ba.SMEM_LIMIT or lay.s_shared
    # the ticket design's S is in shared memory wherever the cooperative one's is
    assert cuda_ba.ticket_s_shared(W, MB, itemsize) or not lay.s_shared
    per_sm = cuda_ba.smem_blocks_per_sm(smem)
    assert 1 <= per_sm <= cuda_ba.SM_THREADS // cuda_ba.BA_THREADS
    assert cuda_ba.check_co_resident(lay.ctas, per_sm, 132) == per_sm * 132 >= lay.ctas
    with pytest.raises(ValueError, match="resident at once"):
        cuda_ba.check_co_resident(per_sm * 132 + 1, per_sm, 132)
    with pytest.raises(ValueError, match="resident at once"):
        cuda_ba.check_co_resident(1, 0, 132)


def test_the_default_window_keeps_the_ticket_designs_shared_memory():
    """At the default window (W = 7, MB = 32) the cooperative K11 takes the
    ticket design's 67,584 bytes: the slice's data kept plus W V^-1, whose
    room then holds S [43, 42], the pivots, the solution and the gauge;
    three CTAs an SM by shared memory, 396 on 132 SMs for 16."""
    assert cuda_ba.step_smem_bytes(7, 32, 8, True) == 67584
    assert cuda_ba.ticket_step_smem_bytes(7, 32, 8, True) == 67584
    assert 43 * 42 + 2 * 42 + 7 <= 18 * 7 * 32
    assert cuda_ba.smem_blocks_per_sm(67584) == 3


@pytest.mark.parametrize("C,G,per_rank", [(1, 1, 1), (16, 16, 1), (19, 16, 2), (74, 16, 5)])
def test_the_commit_cluster_takes_every_slice_once(C, G, per_rank):
    """K12's cluster design: one cluster of G = min(C, 16) CTAs; rank k
    takes the slices k, k + G, ... in order, every slice exactly once, at
    most ceil(C / G) a rank (the room its shared memory keeps for their
    sums), and the slice c sits at rank c mod G, place c // G."""
    assert cuda_ba.commit_cluster(C) == G
    taken = [list(cuda_ba.commit_slices(k, C)) for k in range(G)]
    assert sorted(c for s in taken for c in s) == list(range(C))
    assert max(len(s) for s in taken) == per_rank == -(-C // G)
    for k, s in enumerate(taken):
        assert s == sorted(s) and all(c % G == k and i == c // G for i, c in enumerate(s))


@pytest.mark.parametrize("W,itemsize,nbytes", [(2, 8, 2336), (2, 4, 1168), (7, 8, 5416),
                                               (7, 4, 2708), (30, 8, 10272), (30, 4, 7632),
                                               (45, 8, 12288), (45, 4, 8676)])
def test_the_commit_clusters_shared_memory(W, itemsize, nbytes):
    """K12's cluster design at 512 slots: a slice's rho mask and mask [W MB]
    each, the prior's terms [W - 1, 6], the candidate points of the rank's
    slices [ceil(C / G), 3 MB], the candidate poses [7W] and every slice's
    sums [C, 3]; a few KiB, far under the 48 KiB a CTA takes without opting
    in."""
    lay = cuda_ba.ba_layout(W, 512, itemsize)
    MB, C = lay.landmarks_per_cta, lay.ctas
    G = cuda_ba.commit_cluster(C)
    assert G == 16
    want = (2 * W * MB + 6 * (W - 1) + 3 * MB * -(-C // G) + 7 * W + 3 * C) * itemsize
    assert cuda_ba.commit_smem_bytes(W, MB, C, itemsize) == want == nbytes < 48 * 1024


def test_the_commit_refuses_cpu_tensors():
    """K12 alone (ba_commit_cuda) raises on a CPU problem and candidate
    before anything is built or launched: no fallback to the plain stage."""
    p = interop.ba_problem_from_arrays(**window())
    W, M = p.poses.t.shape[0], p.map.points.shape[0]
    cand = (torch.zeros(W, 6, dtype=torch.float64), torch.zeros(M, 3, dtype=torch.float64),
            p.poses.t.clone(), p.poses.q.clone(), p.map.points.clone())
    before = cuda_ba.LAUNCHES_BA_COMMIT, cuda_ba.LAUNCHES_BA_COMMIT_TICKET
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_ba.ba_commit_cuda(p, p.poses.t.new_zeros(cuda_ba.B_SIZE), cand, tba.BAOptions())
    assert (cuda_ba.LAUNCHES_BA_COMMIT, cuda_ba.LAUNCHES_BA_COMMIT_TICKET) == before


def _reduced_system(pt, lam=1e-3, negate=False):
    built = list(tba.ba_build_plain(pt, 2.0))
    if negate:
        built[1] = -10.0 * built[1]
    S, rhs, _, _, gauge = tba.reduced_camera_system(
        *built[1:6], torch.tensor(lam, dtype=torch.float64), tba.BAOptions(), H_pose=built[6],
        pose_mask=pt.pose_mask)
    return built, S, rhs, gauge


def test_the_ordered_solve_matches_the_library(case):
    """experiments/ba_kernels.py's cholesky_solve_ordered (K11's order of
    operations) against torch.linalg.cholesky and cholesky_solve on the same
    reduced camera system, float64: within 1e-9 of the solution's magnitude."""
    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    _, _, pt = case
    _, S, rhs, _ = _reduced_system(pt)
    x, ok = bk.cholesky_solve_ordered(S, rhs)
    want = torch.cholesky_solve(rhs[:, None], torch.linalg.cholesky(S))[:, 0]
    assert ok
    _close(x, npy(want), BLOCKS, "x")


def test_the_ordered_solve_gives_jaxs_schur_step(case):
    """The step that K11's order gives, dp = -x * gauge, against the JAX
    package's schur_solve on the same normal equations (1e-9)."""
    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    a, pj, pt = case
    outj = _jbuild(pj, 2.0)
    dj, _, _ = _jax_step(pj, outj, 1e-3)
    _, S, rhs, gauge = _reduced_system(pt)
    x, ok = bk.cholesky_solve_ordered(S, rhs)
    dp = -x.reshape(-1, 6) * gauge[:, None]
    _close(dp, dj, BLOCKS, "dp")


def test_the_ordered_solve_fails_where_cholesky_ex_does(case):
    """Negative-definite pose blocks: a pivot not > 0, a NaN solution, as
    torch.linalg.cholesky_ex reports info != 0."""
    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    _, _, pt = case
    _, S, rhs, _ = _reduced_system(pt, lam=1e-4, negate=True)
    x, ok = bk.cholesky_solve_ordered(S, rhs)
    assert not ok and torch.isnan(x).all()
    assert int(torch.linalg.cholesky_ex(S)[1]) != 0
