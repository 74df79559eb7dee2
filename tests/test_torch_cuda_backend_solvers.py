"""The loop closure's kernels K13 (csrc/pnp.cu) and K14-K15
(csrc/pose_graph.cu) against their plain versions on the card, on inputs
made with numpy from a seed (experiments/backend_kernels.py's pnp_arrays and
pose_graph_arrays).

K13 against ``solve_pnp_plain`` and ``pnp_residual_norms`` on the card, in
float64 and float32, at B = 1 and 5 (mixed mask counts, one all zero), N =
48 and 256, 0, 1 and 30 iterations, a NaN point in one problem, a point
behind the camera and Huber outliers (backend_kernels.hold_pnp: the pose
within 1e-9 in float64 and 1e-5 in float32, or within what roundoff in the
sums can move it by where that is larger; the cost within rtol 1e-9 / 1e-5
and the norms within 1e-8 / 1e-3 px of the plain version's at the kernel's
pose; the two final costs within rtol 1e-9 / 1e-5 but on the problem with a
point behind the camera, whose cost moves with the pose by 480 / 1e-6 px a
metre; the loop stage's keep gates on the norms equal; decision flips counted
and printed). K14 and K15 against ``pg_build_plain`` and ``pg_step_plain`` on
every iteration of pose-graph runs (backend_kernels.hold_pg: K14 1e-12 of
each output's magnitude, K15 within the solve's roundoff bound, the
decisions equal in float64), the run on the card against the CPU's, the
launches (one K13 a ``solve_pnp`` call, one K14 and one K15 an iteration,
no plain stage reached), K15 inside a CUDA graph replayed bit for bit, a
NaN step rejected, a done state unchanged, and the wrappers' refusals.
Every test carries the ``cuda`` marker and skips where no CUDA device is
visible.

The module imports only torch and numpy. Run it on a machine with the card,
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_backend_solvers.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

DTYPES = [torch.float64, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


PNP_CASES = {
    "single": dict(B=1, N=256),
    "mixed masks": dict(B=5, N=48, live=[48, 30, 0, 20, 48]),
    "nan point": dict(B=3, N=48, nan_problem=1),
    "behind": dict(B=1, N=96, behind=True),
    "outliers": dict(B=1, N=96, outliers=12),
}


@pytest.mark.parametrize("iterations", [0, 1, 30])
@pytest.mark.parametrize("case", list(PNP_CASES))
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_pnp_kernel_matches_plain(cuda, dtype, case, iterations):
    from mba_vo_tpu_torch.backend import geometry
    from mba_vo_tpu_torch.experiments import backend_kernels as bk

    kw = dict(PNP_CASES[case])
    B, N = kw.pop("B"), kw.pop("N")
    a = bk.pnp_arrays(B, N, seed=B + N, **kw)
    with bk.record_pnp_calls() as calls:
        row = geometry.pnp_rounds_row(*bk.pnp_tensors(a, dtype, cuda), 2.0, iterations)
    assert len(calls) == 1 and row.shape == (B, N + 8)
    got = bk.hold_pnp(calls[0])
    assert got["replayed"], "a second launch on the same inputs differs"
    assert got["gates_equal"] + got["knife_edges"] == B
    assert got["clamped"] == (1 if case == "behind" else 0)
    flips = bk.pnp_decision_flips(calls[0]) if iterations else 0
    print(f"{case} {dtype} {iterations} iterations: pose {got['pose']:.3e}, cost "
          f"{got['cost']:.3e}, norms {got['norms']:.3e}; decision flips {flips}")
    if case == "nan point":
        np.testing.assert_array_equal(row[1, N + 1:N + 4].cpu().numpy(),
                                      a["init_t"][1].astype(np.dtype(str(dtype)[6:])))
        assert bool(torch.isnan(row[1, N]))
    if case == "mixed masks":
        assert float(row[2, N]) == 0.0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_solve_pnp_on_the_card_unbatched_and_batched(cuda, dtype):
    """solve_pnp's leading axes: one problem without a batch axis, and a
    batch, each one launch, equal to the batch's rows."""
    from mba_vo_tpu_torch.backend import geometry
    from mba_vo_tpu_torch.core.transform import Pose
    from mba_vo_tpu_torch.experiments import backend_kernels as bk
    from mba_vo_tpu_torch.ops import cuda_backend as cb

    a = bk.pnp_arrays(4, 64, seed=2)
    pts, obs, m, K, init = bk.pnp_tensors(a, dtype, cuda)
    cb.zero_launch_counts()
    pose, cost = geometry.solve_pnp(pts, obs, m, K, init)
    one, c1 = geometry.solve_pnp(pts[2], obs[2], m[2], K, Pose(init.t[2], init.q[2]))
    assert cb.launch_counts()["pnp_solve"] == 2
    assert torch.equal(one.t, pose.t[2]) and torch.equal(one.q, pose.q[2])
    assert torch.equal(c1, cost[2])
    # no batch: nothing launches
    empty = geometry.pnp_rounds_row(pts[:0], obs[:0], m[:0], K, Pose(init.t[:0], init.q[:0]))
    assert empty.shape == (0, 72) and cb.launch_counts()["pnp_solve"] == 2


def _graph(n, dtype, device, loop=True):
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.core.transform import Pose
    from mba_vo_tpu_torch.experiments import backend_kernels as bk

    (t, q), e = bk.pose_graph_arrays(n, loop=loop)
    f = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
    return Pose(f(t), f(q)), interop.pose_graph_edges_from_arrays(*e, dtype=dtype, device=device)


@pytest.mark.parametrize("n, loop", [(2, False), (8, True), (64, True)])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
def test_pose_graph_kernels_match_plain_on_every_iteration(cuda, dtype, n, loop):
    from mba_vo_tpu_torch.backend import pose_graph as pg
    from mba_vo_tpu_torch.experiments import backend_kernels as bk
    from mba_vo_tpu_torch.ops import cuda_backend as cb

    poses, edges = _graph(n, dtype, cuda, loop)
    cb.zero_launch_counts()
    with bk.record_pg_calls() as calls:
        out, cost, it = pg.optimize_pose_graph_counted(poses, edges)
    assert cb.launch_counts() == {"pnp_solve": 0, "pg_build": it, "pg_step": it}
    assert len(calls) == it
    got = bk.hold_pg_calls(calls)
    print(f"N {n} {dtype}: {it} iterations, K14 within {got['pg_build']:.3e}, K15 "
          f"{got['pg_step']:.3e} of its bound; flips {got['flips']}")
    assert got["replayed_equal"] == got["transitions"]
    if dtype == torch.float64:
        assert not got["flips"]
    # against the CPU's stage loop
    cpu_poses, cpu_edges = _graph(n, dtype, "cpu", loop)
    ref, ref_cost, ref_it = pg.optimize_pose_graph_counted(cpu_poses, cpu_edges)
    tol = 1e-8 if dtype == torch.float64 else 1e-4
    assert float((out.t.cpu() - ref.t).abs().max()) <= tol
    if dtype == torch.float64:
        assert it == ref_it
        np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-9, atol=1e-20)


def test_cuda_paths_never_reach_a_plain_stage(cuda, monkeypatch):
    from mba_vo_tpu_torch.backend import geometry, pose_graph as pg
    from mba_vo_tpu_torch.experiments import backend_kernels as bk
    from mba_vo_tpu_torch.ops import cuda_backend as cb

    def refuse(*args, **kwargs):
        raise AssertionError("a plain stage ran on CUDA tensors")
    for mod, name in ((geometry, "solve_pnp_plain"), (geometry, "pnp_residual_norms"),
                      (pg, "pg_build_plain"), (pg, "pg_step_plain"), (pg, "run_plain_stages")):
        monkeypatch.setattr(mod, name, refuse)
    cb.zero_launch_counts()
    for B in (1, 3):
        geometry.solve_pnp(*bk.pnp_tensors(bk.pnp_arrays(B, 48, seed=B), device=cuda))
    poses, edges = _graph(8, torch.float64, cuda)
    _, _, it = pg.optimize_pose_graph_counted(poses, edges)
    assert cb.launch_counts() == {"pnp_solve": 2, "pg_build": it, "pg_step": it}


def test_pg_step_in_a_cuda_graph_replays_bit_for_bit(cuda):
    from mba_vo_tpu_torch.backend import pose_graph as pg
    from mba_vo_tpu_torch.ops import cuda_backend as cb

    poses, edges = _graph(16, torch.float64, cuda)
    opts = pg.PoseGraphOptions()
    direct = cb.PGBinding(poses, edges, opts)
    direct.build()
    direct.step()
    graphed = cb.PGBinding(poses, edges, opts)
    graphed.build()
    torch.cuda.synchronize()
    before = cb.launch_counts()["pg_step"]
    g = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        with torch.cuda.graph(g):
            graphed.step()
    torch.cuda.current_stream().wait_stream(side)
    assert cb.launch_counts()["pg_step"] == before   # recorded, not launched
    g.replay()
    torch.cuda.synchronize()
    for a, b in ((direct.t, graphed.t), (direct.q, graphed.q), (direct.scalars, graphed.scalars)):
        assert torch.equal(a.view(torch.int64), b.view(torch.int64))


def test_nan_step_is_rejected_and_a_done_state_is_unchanged(cuda):
    from mba_vo_tpu_torch.backend import pose_graph as pg
    from mba_vo_tpu_torch.ops import cuda_backend as cb

    poses, edges = _graph(8, torch.float64, cuda)
    opts = pg.PoseGraphOptions()
    b = cb.PGBinding(poses, edges, opts)
    b.build()
    H = b.H.clone()
    H[10, 10] = -1e6                   # not positive definite: a NaN step
    b.use_built(H, b.g)
    t0, q0, lam0 = b.t.clone(), b.q.clone(), float(b.scalars[cb.G_LAM])
    b.step()
    torch.cuda.synchronize()
    assert float(b.scalars[cb.G_OK]) == 0.0 and bool(torch.isnan(b.scalars[cb.G_CAND_COST]))
    assert torch.equal(b.t, t0) and torch.equal(b.q, q0)
    assert float(b.scalars[cb.G_LAM]) == lam0 * opts.lambda_up
    # a done state: K15 changes nothing
    b.scalars[cb.G_DONE] = 1.0
    s0 = b.scalars.clone()
    b.use_built(b.H, b.g)
    b.step()
    torch.cuda.synchronize()
    assert torch.equal(b.scalars.view(torch.int64), s0.view(torch.int64))
    assert torch.equal(b.t, t0)


def test_wrappers_refuse_wrong_inputs(cuda):
    from mba_vo_tpu_torch.backend import pose_graph as pg
    from mba_vo_tpu_torch.core.transform import Pose
    from mba_vo_tpu_torch.experiments import backend_kernels as bk
    from mba_vo_tpu_torch.ops import cuda_backend as cb

    pts, obs, m, K, init = bk.pnp_tensors(bk.pnp_arrays(2, 48, seed=1), device=cuda)
    with pytest.raises(ValueError, match="must be"):
        cb.pnp_solve_cuda(pts, obs[:, :40].contiguous(), m, K, init.t, init.q)
    with pytest.raises(ValueError, match="float32"):
        cb.pnp_solve_cuda(pts, obs.float(), m, K, init.t, init.q)
    with pytest.raises(ValueError, match="contiguous"):
        cb.pnp_solve_cuda(pts, obs, m, K, init.t.t().contiguous().t(), init.q)
    with pytest.raises(ValueError, match="not CUDA"):
        cb.pnp_solve_cuda(pts, obs, m, K.cpu(), init.t, init.q)
    poses, edges = _graph(8, torch.float64, cuda)
    opts = pg.PoseGraphOptions()
    with pytest.raises(ValueError, match="int64"):
        cb.PGBinding(poses, edges._replace(i=edges.i.int()), opts)
    with pytest.raises(ValueError, match="must be"):
        cb.PGBinding(poses, edges._replace(weight=edges.weight[:-1]), opts)
    b = cb.PGBinding(poses, edges, opts)
    with pytest.raises(ValueError, match="must be"):
        b.use_built(b.H[:-1], b.g)
    t = torch.zeros((1300, 3), dtype=torch.float64, device=cuda)
    q = torch.zeros((1300, 4), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cb.PGBinding(Pose(t, q), edges, opts)
