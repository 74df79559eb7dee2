"""The bundle adjustment's kernels K10-K12 (csrc/bundle_adjust.cu) against
their plain versions (backend/ba.py's ba_build_plain, ba_step_plain,
ba_commit_plain) on the card, on windows made with numpy from a seed: every
iteration of a run replayed through both (float64 1e-12 and float32 1e-5 of
each output's magnitude, the decisions equal), the kernels' run against the
plain stages' run on the CPU, the launches of the unsharded CUDA path (one
of each kernel an iteration, no plain stage, the earlier ticket designs
never), the earlier ticket designs of K10-K12 against the launched band,
cooperative and cluster designs (K10's and K12's bit for bit; K12's on every
iteration of whole runs), K12's cluster against the layout's arithmetic, the
wrapper's refusals (a K11 grid
too large to be resident at once among them), a non-positive-definite
reduced system (a NaN step that K12 rejects) and a state already done, on
windows from W = 2 to W = 45 (S in K11's global scratch) and a landmark
count with a short last slice over 19 CTAs; K11 and K12 recorded into CUDA
graphs and replayed bit for bit. Every test carries the
``cuda`` marker and skips where no CUDA device is visible.

The module imports only torch and numpy. Run it on a machine with the card,
without the JAX test configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_ba.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

KVEC = np.array([480.0, 480.0, 319.5, 239.5])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qmul(a, b):
    ax, ay, az, aw = np.moveaxis(a, -1, 0)
    bx, by, bz, bw = np.moveaxis(b, -1, 0)
    return np.stack([aw * bx + ax * bw + ay * bz - az * by, aw * by + ay * bw + az * bx - ax * bz,
                     aw * bz + az * bw + ax * by - ay * bx, aw * bw - ax * bx - ay * by - az * bz],
                    -1)


def _qrot(q, v):
    xyz, w = q[..., :3], q[..., 3:4]
    t = 2.0 * np.cross(xyz, v)
    return v + w * t + np.cross(xyz, t)


def _quats(rng, n, scale):
    q = np.concatenate([rng.normal(0, scale, (n, 3)), np.ones((n, 1))], axis=1)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def window(W=7, M=96, live=80, seed=0, pose_pad=1, odom=True, pose_mask=True,
           odom_weight=1e3, outliers=2, behind=True):
    """A window of W cameras over M landmark slots (``live`` observed, the
    rest padding), noisy and partly missing observations, ``outliers``
    gross outliers, with ``behind`` one landmark behind the cameras (the
    depth clamp),
    ``pose_pad`` padded poses at the end, odometry priors from slightly
    noisy true relative poses, perturbed starts."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M), rng.uniform(3, 6, M)], -1)
    ts = np.stack([[0.15 * w, 0.02 * w, 0.05 * w] for w in range(W)])
    qs = _quats(rng, W, 0.03)
    qi = qs * np.array([-1.0, -1.0, -1.0, 1.0])
    Pc = np.stack([_qrot(qi[w][None], X - ts[w]) for w in range(W)])
    obs = np.stack([Pc[..., 0] / Pc[..., 2] * KVEC[0] + KVEC[2],
                    Pc[..., 1] / Pc[..., 2] * KVEC[1] + KVEC[3]], -1)
    obs = obs + rng.normal(0, 0.5, obs.shape)
    obs[1, :outliers] += 40.0
    if behind:
        X[5] = [0.1, 0.0, -1.0]               # behind every camera
    point_mask = (np.arange(M) < live).astype(np.float64)
    obs_mask = (rng.random((W, M)) > 0.2) * point_mask[None]
    pm = np.ones(W)
    if pose_pad:
        pm[W - pose_pad:] = 0.0
        obs_mask[W - pose_pad:] = 0.0
    rel_t = np.stack([_qrot(qi[w], ts[w + 1] - ts[w]) for w in range(W - 1)])
    rel_q = np.stack([_qmul(qi[w], qs[w + 1]) for w in range(W - 1)])
    w_o = np.full(W - 1, odom_weight)
    if pose_pad:
        w_o[W - 1 - pose_pad:] = 0.0
    init_q = np.concatenate([qs[:1], _qmul(qs[1:], _quats(rng, W - 1, 0.01))])
    return dict(pose_t=ts + rng.normal(0, 0.02, ts.shape) * (np.arange(W) > 0)[:, None],
                pose_q=init_q, points=X + rng.normal(0, 0.05, X.shape), obs_xy=obs,
                obs_mask=obs_mask, K=KVEC, point_mask=point_mask,
                odom=(rel_t + rng.normal(0, 1e-3, rel_t.shape), rel_q, w_o) if odom else None,
                pose_mask=pm if pose_mask else None)


CASES = {
    "padded": {},
    "no odometry, no pose mask": dict(odom=False, pose_mask=False, pose_pad=0),
    "8a's size": dict(M=512, live=300, pose_pad=0, odom_weight=1e6),
    "wide window": dict(W=30, M=40, live=40, pose_pad=2),
    "converging": dict(M=512, live=300, odom_weight=1e6, outliers=0, behind=False),
    "converging, no odometry": dict(M=512, live=300, odom=False, pose_mask=False, pose_pad=0,
                                    outliers=0, behind=False),
    # 19 CTAs of 32 landmarks, the last holding 24
    "short last slice": dict(M=600, live=560, odom_weight=1e6),
    "two poses": dict(W=2, M=64, live=60, pose_pad=0),
    # K11's S in its global scratch in both dtypes (W = 30 only in float64)
    "widest window": dict(W=45, M=40, live=40, pose_pad=3),
}


def problem(case, dtype, device="cuda"):
    from mba_vo_tpu_torch import interop

    return interop.ba_problem_from_arrays(**window(**CASES[case]), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_every_iteration_matches_the_plain_stages(cuda, case, dtype):
    """Each iteration of a run on the kernels replayed through K10-K12 and
    the plain stages on the same inputs (experiments/ba_kernels.py's
    hold_ba: within 1e-12 / 1e-5 of each output's magnitude, K11's within
    what roundoff in its sums can move them by where that is larger, NaN
    where the other is, ok, done, lambda and the iteration count equal or
    flipped at a knife edge), and the replay reproducing the run bit for
    bit."""
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    with bk.record_ba_calls() as calls:
        _, summary = ba.run_bundle_adjustment(problem(case, dtype),
                                              ba.BAOptions(max_iterations=8))
    assert len(calls) == summary.num_iterations >= 2
    got = bk.hold_ba_calls(calls)
    assert got["iterations"] == len(calls) and got["accepted"] >= 1
    assert got["replayed_equal"] == got["transitions"] == len(calls) - 1
    if dtype == torch.float64:
        assert got["step_checked"] >= 1


@pytest.mark.parametrize("case", ["converging", "converging, no odometry"])
def test_run_matches_the_cpu(cuda, case):
    """float64, on windows that converge: the kernels' run against the plain
    stages' run on the CPU, iterations equal, poses and points to 1e-8
    (chip_smoke.py 8a's bound), the initial cost to 1e-12 and the final one
    to 1e-9. (Where a landmark sits behind the cameras the loop stops
    unconverged at 20 iterations on that landmark's flight, and any two
    orders of the solves' sums part there: every iteration of those runs is
    held to the plain stages above instead.)"""
    from mba_vo_tpu_torch.backend import ba

    rc, sc = ba.run_bundle_adjustment(problem(case, torch.float64), ba.BAOptions())
    rh, sh = ba.run_bundle_adjustment(problem(case, torch.float64, "cpu"), ba.BAOptions())
    assert sc.num_iterations == sh.num_iterations
    if case == "converging":
        assert sc.num_iterations < ba.BAOptions().max_iterations
    for a, b in ((rc.poses.t, rh.poses.t), (rc.poses.q, rh.poses.q),
                 (rc.map.points, rh.map.points)):
        assert float((a.cpu() - b).abs().max()) <= 1e-8
    assert abs(float(sc.initial_cost) - float(sh.initial_cost)) <= 1e-12 * float(sh.initial_cost)
    assert abs(float(sc.final_cost) - float(sh.final_cost)) <= 1e-9 * float(sh.final_cost)
    assert float(sc.final_cost) < float(sc.initial_cost)


def test_the_cuda_path_launches_each_kernel_an_iteration_and_no_plain_stage(cuda, monkeypatch):
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.ops import cuda_ba

    def refuse(*args, **kw):
        raise AssertionError("a plain stage ran on the unsharded CUDA path")

    for name in ("ba_build_plain", "ba_step_plain", "ba_commit_plain", "ba_initial_scalars",
                 "build_normal_equations", "schur_solve", "evaluate_cost", "_apply_step"):
        monkeypatch.setattr(ba, name, refuse)
    p = problem("padded", torch.float64)
    cuda_ba.zero_launch_counts()
    out, summary = ba.run_bundle_adjustment(p, ba.BAOptions())
    torch.cuda.synchronize()
    n = summary.num_iterations
    assert cuda_ba.launch_counts() == {"ba_build": n, "ba_step": n, "ba_commit": n}
    assert cuda_ba.earlier_launch_counts() == {"ba_build": 0, "ba_step": 0, "ba_commit": 0}
    assert n >= 2 and float(summary.final_cost) < float(summary.initial_cost)
    # the caller's problem is left as given; padded slots and poses stay
    assert not torch.equal(out.poses.t, p.poses.t) and out.poses.t is not p.poses.t
    assert torch.equal(out.map.points[80:], p.map.points[80:])
    assert torch.equal(out.poses.t[-1], p.poses.t[-1])
    # the initial cost without an iteration: K10 once
    cuda_ba.zero_launch_counts()
    _, s0 = ba.run_bundle_adjustment(p, ba.BAOptions(max_iterations=0))
    assert s0.num_iterations == 0 and cuda_ba.launch_counts()["ba_build"] == 1
    assert float(s0.initial_cost) == float(s0.final_cost) == float(summary.initial_cost)


def test_runs_repeat_bit_for_bit(cuda):
    from mba_vo_tpu_torch.backend import ba

    p = problem("8a's size", torch.float64)
    (a, sa), (b, sb) = (ba.run_bundle_adjustment(p, ba.BAOptions()) for _ in range(2))
    assert sa.num_iterations == sb.num_iterations
    assert torch.equal(a.poses.t, b.poses.t) and torch.equal(a.map.points, b.map.points)
    assert torch.equal(sa.final_cost, sb.final_cost)


def test_the_wrapper_refuses_what_the_kernels_do_not_take(cuda):
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.ops import cuda_ba

    opts = ba.BAOptions()
    p = problem("padded", torch.float64)
    m = p.map
    bad = {
        "a CPU tensor": p._replace(K=p.K.cpu()),
        "a float32 tensor": p._replace(map=m._replace(obs_xy=m.obs_xy.float())),
        "a wrong shape": p._replace(map=m._replace(obs_mask=m.obs_mask[:, :-1].contiguous())),
        "a strided tensor": p._replace(map=m._replace(points=m.points.t().contiguous().t())),
        "an integer dtype": p._replace(K=p.K.long()),
    }
    for what, q in bad.items():
        with pytest.raises(ValueError):
            cuda_ba.BABinding(q, opts)
        with pytest.raises(ValueError):
            ba.run_bundle_adjustment(q, opts)
    b = cuda_ba.BABinding(p, opts)
    built = list(b.built)
    built[1] = built[1][:-1]
    with pytest.raises(ValueError):
        b.use_built(built)
    with pytest.raises(ValueError):
        b.use_candidate(tuple(x.cpu() for x in b.candidate))
    with pytest.raises(ValueError):
        cuda_ba.BABinding(p, opts, scalars=torch.zeros(cuda_ba.B_SIZE + 1, dtype=torch.float64,
                                                       device="cuda"))


def test_a_non_positive_definite_system_gives_a_nan_step_that_k12_rejects(cuda):
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.ops import cuda_ba

    opts = ba.BAOptions()
    p = problem("padded", torch.float64)
    sc = p.poses.t.new_zeros(cuda_ba.B_SIZE)
    sc[cuda_ba.B_LAM] = opts.initial_lambda
    built = list(cuda_ba.ba_build_cuda(p, sc, opts))
    built[1] = -10.0 * built[1]                      # negative-definite pose blocks
    cand = cuda_ba.ba_step_cuda(p, sc, built, opts)
    ref = ba.ba_step_plain(p, sc, built, opts)
    for a, b in zip(cand, ref):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
    assert torch.isnan(cand[0]).all() and torch.isnan(cand[1][:80]).all()
    before = (p.poses.t.clone(), p.poses.q.clone(), p.map.points.clone(), sc.clone())
    cuda_ba.ba_commit_cuda(p, sc, cand, opts)
    assert sc[cuda_ba.B_OK] == 0 and sc[cuda_ba.B_DONE] == 0 and sc[cuda_ba.B_IT] == 1
    assert sc[cuda_ba.B_COST] == before[3][cuda_ba.B_COST]
    assert sc[cuda_ba.B_LAM] == before[3][cuda_ba.B_LAM] * opts.lambda_up
    for a, b in zip((p.poses.t, p.poses.q, p.map.points), before):
        assert torch.equal(a, b)


def test_a_done_state_does_not_change(cuda):
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.ops import cuda_ba

    opts = ba.BAOptions()
    p = problem("padded", torch.float64)
    sc = p.poses.t.new_zeros(cuda_ba.B_SIZE)
    sc[cuda_ba.B_LAM] = opts.initial_lambda
    built = cuda_ba.ba_build_cuda(p, sc, opts)
    cand = cuda_ba.ba_step_cuda(p, sc, built, opts)
    sc[cuda_ba.B_DONE] = 1.0
    before = (p.poses.t.clone(), p.poses.q.clone(), p.map.points.clone(), sc.clone())
    cuda_ba.ba_commit_cuda(p, sc, cand, opts)
    pp, scp = ba.ba_commit_plain(p._replace(poses=p.poses._replace(t=before[0], q=before[1]),
                                            map=p.map._replace(points=before[2])),
                                 before[3], cand, opts)
    for a, b in zip((p.poses.t, p.poses.q, p.map.points, sc), before):
        assert torch.equal(a, b)
    assert torch.equal(scp, before[3]) and torch.equal(pp.poses.t, before[0])
    # the ticket design leaves it too
    b = cuda_ba.BABinding(p, opts, sc, own=False)
    b.use_candidate(cand)
    b.commit_ticket()
    for a, c in zip((p.poses.t, p.poses.q, p.map.points, sc), before):
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_the_ticket_designs_match_the_launched_ones(cuda, case, dtype):
    """The earlier ticket designs of K10-K12 against the launched band,
    cooperative and cluster designs on every iteration of a run, on the same
    inputs (experiments/ba_kernels.py's hold_designs): K10's and K12's bit
    for bit (each pair takes every sum in one order); K11's, whose
    factorisations scale the pivots otherwise, within 1e-12 / 1e-5 of each
    output's magnitude or else within what roundoff can move them by
    (ba_kernels.step_bounds), as the plain version is held."""
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    with bk.record_ba_calls() as calls:
        ba.run_bundle_adjustment(problem(case, dtype), ba.BAOptions(max_iterations=4))
    got = bk.hold_designs_calls(calls)
    assert got["iterations"] == len(calls) >= 2
    assert got["ba_build_equal"] == got["ba_commit_equal"] == len(calls), got
    if dtype == torch.float64:
        assert got["step_checked"] >= 1, got


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", list(CASES))
def test_the_commit_matches_its_ticket_design_on_every_iteration(cuda, case, dtype):
    """K12's cluster design against its earlier ticket design on every
    iteration of a whole run (experiments/ba_kernels.py's
    hold_commit_designs_calls): t, q, X and every scalar bit for bit, on a
    cluster of 16 CTAs over 19 slices ("short last slice": ranks 0-2 take
    two), of 2 ("two poses") and of 16 over 74 slices of 7 ("widest
    window", float64)."""
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.experiments import ba_kernels as bk

    with bk.record_ba_calls() as calls:
        ba.run_bundle_adjustment(problem(case, dtype), ba.BAOptions())
    got = bk.hold_commit_designs_calls(calls)
    assert got["iterations"] == len(calls) >= 2
    assert got["ba_commit_equal"] == len(calls), got


@pytest.mark.parametrize("W", [2, 7, 30, 45])
@pytest.mark.parametrize("itemsize", [8, 4])
def test_the_commit_cluster_is_the_layouts(cuda, W, itemsize):
    """The library's K12 cluster (its CTAs and shared memory) equals
    ops/cuda_ba.py's layout arithmetic at 512 slots, and the occupancy API
    schedules it."""
    from mba_vo_tpu_torch.ops import cuda_ba

    lay = cuda_ba.ba_layout(W, 512, itemsize)
    MB, C = lay.landmarks_per_cta, lay.ctas
    lib = cuda_ba.library()
    assert lib.ba_commit_cluster(W, 512, MB) == cuda_ba.commit_cluster(C)
    assert lib.ba_commit_smem_bytes(W, 512, MB, itemsize) == cuda_ba.commit_smem_bytes(
        W, MB, C, itemsize)
    dev = torch.device("cuda", torch.cuda.current_device())
    assert cuda_ba.commit_clusters(W, 512, MB, itemsize, dev) >= 1


def test_a_grid_too_large_to_be_resident_raises(cuda):
    """K11's cooperative launch needs every CTA resident: 20,000 landmark
    slots at the default window make 625 CTAs of 67,584 bytes of shared
    memory, more than the card's SMs hold at once; the binding raises
    before any launch, and the occupancy API's count is at most what
    shared memory alone allows."""
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.ops import cuda_ba

    big = interop.ba_problem_from_arrays(**window(M=20000, live=300), dtype=torch.float64,
                                         device="cuda")
    lay = cuda_ba.ba_layout(7, 20000, 8)
    per_sm = cuda_ba.step_blocks_per_sm(7, lay.landmarks_per_cta, 8, lay.s_shared,
                                        torch.device("cuda", torch.cuda.current_device()))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert 1 <= per_sm <= cuda_ba.smem_blocks_per_sm(cuda_ba.step_smem_bytes(
        7, lay.landmarks_per_cta, 8, lay.s_shared))
    assert lay.ctas == 625 > per_sm * sms
    cuda_ba.zero_launch_counts()
    with pytest.raises(ValueError, match="resident at once"):
        cuda_ba.BABinding(big, ba.BAOptions())
    with pytest.raises(ValueError, match="resident at once"):
        ba.run_bundle_adjustment(big, ba.BAOptions())
    assert cuda_ba.launch_counts() == {"ba_build": 0, "ba_step": 0, "ba_commit": 0}


def test_the_step_records_into_a_cuda_graph(cuda):
    """K11's cooperative launch inside a CUDA graph capture: recorded, not
    counted as a launch; the graph's replay gives the direct launch's
    outputs bit for bit."""
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.ops import cuda_ba

    opts = ba.BAOptions()
    p = problem("8a's size", torch.float64)
    sc = p.poses.t.new_zeros(cuda_ba.B_SIZE)
    sc[cuda_ba.B_LAM] = opts.initial_lambda
    b = cuda_ba.BABinding(p, opts, sc, own=False)
    b.build()
    b.step()
    torch.cuda.synchronize()
    want = tuple(x.clone() for x in b.candidate)
    for x in b.candidate:
        x.fill_(float("nan"))
    cuda_ba.zero_launch_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            b.step()
    torch.cuda.current_stream().wait_stream(side)
    assert cuda_ba.launch_counts()["ba_step"] == 0
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(b.candidate, want):
        assert torch.equal(x, y)


def test_the_commit_records_into_a_cuda_graph(cuda):
    """K12's cluster launch inside a CUDA graph capture: recorded, not
    counted as a launch; the graph's replay on the same starting state
    gives the direct launch's next state (t, q, X, scalars) bit for bit."""
    from mba_vo_tpu_torch.backend import ba
    from mba_vo_tpu_torch.ops import cuda_ba

    opts = ba.BAOptions()
    p = problem("short last slice", torch.float64)
    sc = p.poses.t.new_zeros(cuda_ba.B_SIZE)
    sc[cuda_ba.B_LAM] = opts.initial_lambda
    b = cuda_ba.BABinding(p, opts, sc, own=False)
    b.build()
    b.step()
    state = (b.t, b.q, b.X, b.scalars)
    start = tuple(x.clone() for x in state)
    b.commit()
    torch.cuda.synchronize()
    want = tuple(x.clone() for x in state)
    assert want[3][cuda_ba.B_OK] == 1 and not torch.equal(want[2], start[2])
    for x, y in zip(state, start):
        x.copy_(y)
    cuda_ba.zero_launch_counts()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(side):
        with torch.cuda.graph(graph, stream=side):
            b.commit()
    torch.cuda.current_stream().wait_stream(side)
    assert cuda_ba.launch_counts()["ba_commit"] == 0
    for x, y in zip(state, start):
        assert torch.equal(x, y)
    graph.replay()
    torch.cuda.synchronize()
    for x, y in zip(state, want):
        assert torch.equal(x, y)
