"""The port's sharded paths (mba_vo_tpu_torch/parallel/) on four gloo CPU
ranks, held against the JAX package's sharded paths on the virtual CPU
mesh of tests/conftest.py and against the port's own single-process run,
in float64 at tests/test_parallel.py's shapes and tolerances.

The ranks are spawned once for the file (a module-scoped fixture; see
tests/torch_parallel_common.py): each runs every case of the port on its
shards and writes its results, while this process runs the JAX side and
the port's single-process cases. The cases: the objective (``evaluate``,
direct and windowed) on 2 and 4 ranks, and with Kahan-compensated normal
equations (each rank's compensated sums all-reduced, as the reference
psums them) on 4; the LM of a level (direct,
windowed, a corrupted keypoint masked across shards) on 4 ranks and on a
(2, 2) pod mesh; track_frames, its affine path and track_frames_joint with
shard_devices = 4; bundle adjustment with landmarks sharded (and padded
slots inert); VOBackend(shard_devices = 4); and ``cli track
--shard-devices 4``. Every rank must end with the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mba_vo_tpu.backend import ba as jba
from mba_vo_tpu.backend import vo_backend as jvb
from mba_vo_tpu.core import lie as jlie
from mba_vo_tpu.core.spline import (
    SplineKnots, identity_knots, make_knots as jmake, spline_pose_at, spline_pose_at_times,
    spline_retract,
)
from mba_vo_tpu.core.transform import Pose as JPose
from mba_vo_tpu.ops import residual as jres
from mba_vo_tpu.parallel import mesh as jmesh
from mba_vo_tpu.parallel.distributed import make_pod_mesh as jpod
from mba_vo_tpu.parallel.sharded import optimize_level_sharded as jsharded
from mba_vo_tpu.parallel.sharded import optimize_level_sharded_pod as jsharded_pod
from mba_vo_tpu.parallel.sharded_ba import (
    make_ba_mesh as jba_mesh, run_bundle_adjustment_sharded as jba_sharded,
    shard_ba_problem as jshard_ba,
)
from mba_vo_tpu.solver import lm as jlm
from mba_vo_tpu.tracker import blur_tracker as jbt
from mba_vo_tpu.tracker.detector import DetectorOptions
from mba_vo_tpu_torch.parallel import distributed as tdist
from mba_vo_tpu_torch.parallel import mesh as tmesh

import torch_parallel_common as tpc
from test_backend import synthetic_ba_problem
from test_parallel import make_data, true_knots
from torch_cli_common import make_eth3d, track_args
from torch_port_common import VEL, moving_scene

TRACK_TOL = 1e-9
# one level's LM from identity knots stops on a cost decrease under 1e-7:
# the pose at the capture time is determined to ~1e-9, while the spline's
# motion inside the exposure (the blur direction, weakly observed by one
# frame) ends ~1e-6 apart between any two orders of the same sums (the
# JAX and the port's single-process runs part by as much as the sharded
# run does)
LEVEL_POSE_TOL = 1e-8
LEVEL_KNOT_TOL = 1e-5
BA_TOL = 1e-8
TUM_TOL = 1e-8     # TUM files print 9 decimals
CHUNK = 4
CAP = 0.05         # tests/test_parallel.py's capture time

TRACKER_FIELDS = dict(
    num_pyramid_levels=2, num_virtual_poses=(3, 3), huber_a=10.0,
    min_abs_cost_decrease=1e-6, max_num_iterations=8,
    keyframe_max_flow_mag0=1e9, keyframe_max_flow_mag1=1e9,
    detector=dict(score_threshold=5.0, cell_h=8, cell_w=8, max_keypoints=64),
    dtype="float64")
BACKEND_FIELDS = dict(window_size=3, loop_min_matches=15, loop_skip_recent=1,
                      run_pose_graph=False)


def level_arrays(data) -> dict:
    return {k: np.asarray(getattr(data, k)) for k in (
        "img_ref", "cur_imgs", "cap_times", "exp_times", "kp_xy", "kp_z", "kp_mask",
        "pattern", "K")}


def knots_arrays(k) -> dict:
    return dict(t=np.asarray(k.t), q=np.asarray(k.q), t0=float(k.t0), dt=float(k.dt))


def ba_arrays(problem) -> dict:
    m = problem.map
    return dict(pose_t=np.asarray(problem.poses.t), pose_q=np.asarray(problem.poses.q),
                points=np.asarray(m.points), obs_xy=np.asarray(m.obs_xy),
                obs_mask=np.asarray(m.obs_mask), K=np.asarray(problem.K),
                point_mask=np.asarray(m.point_mask))


def noisy_ba_problem():
    """tests/test_parallel.py's perturbed BA problem (4 cameras, 60 landmarks)."""
    problem, X_true, *_ = synthetic_ba_problem(W=4, M=60, seed=7)
    rng = np.random.default_rng(8)
    dp = rng.normal(0, 0.02, (4, 6))
    dp[0] = 0
    return problem._replace(
        poses=JPose(t=problem.poses.t + jnp.asarray(dp[:, :3]),
                    q=jlie.quat_multiply(problem.poses.q, jlie.quat_exp(jnp.asarray(dp[:, 3:])))),
        map=problem.map._replace(
            points=problem.map.points + jnp.asarray(rng.normal(0, 0.05, X_true.shape))))


def make_inputs(root) -> dict:
    """Every case's inputs as numpy arrays, made with the JAX package."""
    from test_torch_vo_backend import KVEC as BKVEC, QID, H as BH, W as BW, drift_sequence

    truth = true_knots()
    data = make_data(truth)
    bad = data._replace(kp_z=data.kp_z.at[33].set(0.4))   # in the last of 4 shards
    scene = moving_scene(CHUNK)
    gained = [b * (1.0 + 0.03 * i) + 2.0 * i for i, b in enumerate(scene["blurred"])]
    # the joint path's moving window: the generating spline at the knot times
    # plus millimetre noise (tests/test_torch_joint.py's start_pair)
    K = CHUNK + 2 - 1
    dt = float(max(np.median(np.diff(scene["caps"])), max(scene["exps"]), 1e-3))
    t0 = scene["caps"][0] - 0.5 * max(scene["exps"])
    p = spline_pose_at_times(scene["traj"], jnp.asarray(t0 + dt * np.arange(K)), 2)
    rng = np.random.default_rng(3)
    q = np.asarray(p.q) + rng.normal(0, 1e-3, (K, 4))
    window = dict(t=np.asarray(p.t) + rng.normal(0, 1e-3, (K, 3)),
                  q=q / np.linalg.norm(q, axis=1, keepdims=True), t0=t0, dt=dt)
    sharp, fed = drift_sequence()
    cli_root = make_eth3d(root / "cli")
    return dict(
        level=level_arrays(data), level_bad=level_arrays(bad), truth=knots_arrays(truth),
        at=knots_arrays(spline_retract(truth, jnp.full((2, 3), 3e-3), jnp.zeros((2, 3)))),
        init=knots_arrays(identity_knots(2, t0=float(truth.t0), dt=float(truth.dt),
                                         dtype=jnp.float64)),
        scene=dict(img=scene["img"], kvec=scene["kvec"], hw=scene["hw"],
                   exposure=max(scene["exps"]), depth0=np.full(scene["hw"], 2.0),
                   blurred=scene["blurred"], gained=gained, caps=scene["caps"],
                   exps=scene["exps"]),
        velocity=VEL, tracker_cfg=TRACKER_FIELDS, joint_window=window,
        ba=ba_arrays(noisy_ba_problem()),
        ba_padded=ba_arrays(synthetic_ba_problem(W=4, M=58, seed=7)[0]),
        backend=dict(config=BACKEND_FIELDS, kvec=BKVEC, sharp=sharp, fed=fed, q=QID,
                     depth=np.full((BH, BW), 2.0, np.float32)),
        cli=dict(root=str(cli_root), argv=track_args(cli_root, "unused.txt",
                                                     ["--backend", "ba", "--chunk", "2"])),
    )


# ------------------------------------------------------------------ JAX side


def jax_evaluate(inp, data, sampling, n):
    mesh = jmesh.make_mesh(n)
    sdata = jmesh.shard_level_data(data, mesh)
    compensated = sampling == "compensated"
    fn = shard_map(
        lambda k, d, m: jres.evaluate(k, d, tpc.NUM_VIR, tpc.DEGREE, 10.0, m, True,
                                      axis_name=jmesh.KP_AXIS, window=32,
                                      sampling="windowed" if compensated else sampling,
                                      compensated=compensated),
        mesh=mesh,
        in_specs=(SplineKnots(t=P(), q=P(), t0=P(), dt=P()), jmesh.level_data_specs(),
                  P(jmesh.KP_AXIS)),
        out_specs=jres.Evaluation(cost=P(), gradient=P(), hessian=P(),
                                  patch_costs=P(None, jmesh.KP_AXIS)),
        check_vma=False)
    a = inp["at"]
    ev = jax.jit(fn)(jmake(jnp.asarray(a["t"]), jnp.asarray(a["q"]), a["t0"], a["dt"]),
                     sdata, jnp.ones((sdata.kp_mask.shape[0],)))
    return dict(cost=float(ev.cost), g=np.asarray(ev.gradient), H=np.asarray(ev.hessian),
                patch_costs=np.asarray(ev.patch_costs))


def jax_lm(inp, data, opts_kw, pod=False):
    i = inp["init"]
    init = jmake(jnp.asarray(i["t"]), jnp.asarray(i["q"]), i["t0"], i["dt"])
    opts = jlm.LMOptions(**opts_kw)
    mesh = jpod(n_hosts=2, devices_per_host=2) if pod else jmesh.make_mesh(tpc.WORLD)
    fn = jsharded_pod if pod else jsharded
    k, s = fn(init, jmesh.shard_level_data(data, mesh), tpc.NUM_VIR, tpc.DEGREE, opts, mesh)
    return dict(knots=knots_arrays(k), final_cost=float(s.final_cost),
                num_iterations=int(s.num_iterations), outlier_mask=np.asarray(s.outlier_mask))


def jax_tracker(inp, case):
    sc = inp["scene"]
    f = dict(TRACKER_FIELDS, detector=DetectorOptions(**TRACKER_FIELDS["detector"]))
    cfg = jbt.TrackerConfig(**f, shard_devices=tpc.WORLD, affine_brightness=case == "affine")
    tr = jbt.BlurAwareTracker(cfg, sc["kvec"], tuple(sc["hw"]))
    tr.track_frame(sc["img"], sc["img"], 0.0, sc["exposure"], sc["depth0"])
    tr.neigh_velocity = jnp.asarray(inp["velocity"])
    frames = sc["gained"] if case == "affine" else sc["blurred"]
    if case == "joint":
        w = inp["joint_window"]
        tr._joint_knots = jmake(jnp.asarray(w["t"]), jnp.asarray(w["q"]), w["t0"], w["dt"])
        tr._joint_dt = w["dt"]
        poses = tr.track_frames_joint(frames, sc["caps"], sc["exps"], chunk=CHUNK)
        final = tr._joint_knots
    else:
        poses = tr.track_frames(frames, sc["caps"], sc["exps"], chunk=2)
        final = tr.knots
    assert tr.mesh is not None
    return dict(poses=np.stack([np.concatenate([np.asarray(p.t), np.asarray(p.q)])
                                for p in poses]), knots=knots_arrays(final))


def jax_ba(inp, key, opts_kw):
    a = inp[key]
    from mba_vo_tpu.backend.map import make_map

    problem = jba.BAProblem(
        poses=JPose(t=jnp.asarray(a["pose_t"]), q=jnp.asarray(a["pose_q"])),
        map=make_map(a["points"], a["obs_xy"], a["obs_mask"], a["point_mask"]),
        K=jnp.asarray(a["K"]))
    mesh = jba_mesh(tpc.WORLD)
    out, s = jba_sharded(jshard_ba(problem, mesh), jba.BAOptions(**opts_kw), mesh)
    return dict(pose_t=np.asarray(out.poses.t), points=np.asarray(out.map.points),
                final_cost=float(s.final_cost), num_iterations=int(s.num_iterations))


def jax_backend(inp):
    b = inp["backend"]
    be = jvb.VOBackend(jvb.BackendConfig(**b["config"], shard_devices=tpc.WORLD), b["kvec"])
    assert be.mesh is not None
    for k, (img, t) in enumerate(zip(b["sharp"], b["fed"])):
        be.on_keyframe(img, b["depth"], JPose(t=jnp.asarray(t), q=jnp.asarray(b["q"])), float(k))
    return np.stack([np.concatenate([np.asarray(kf.pose.t), np.asarray(kf.pose.q)])
                     for kf in be.keyframes])


def jax_side(inp) -> dict:
    data, bad = make_data(true_knots()), None
    bad = data._replace(kp_z=data.kp_z.at[33].set(0.4))
    out = {}
    for sampling, n in tpc.EVALUATE:
        out[("evaluate", sampling, n)] = jax_evaluate(inp, data, sampling, n)
    for name, (level, opts) in tpc.LM_CASES.items():
        out[("lm", name)] = jax_lm(inp, bad if level == "level_bad" else data, opts)
    out[("pod",)] = jax_lm(inp, data, tpc.LM_OPTS, pod=True)
    for case in tpc.TRACKER_CASES:
        out[("tracker", case)] = jax_tracker(inp, case)
    for key, opts in tpc.BA_CASES.items():
        out[("ba", key)] = jax_ba(inp, key, opts)
    out[("backend",)] = jax_backend(inp)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(rank results, the port in one process, the JAX side, inputs)."""
    assert jax.device_count() >= tpc.WORLD, "conftest must provide virtual devices"
    root = tmp_path_factory.mktemp("torch_parallel")
    inp = make_inputs(root)
    ctx = tpc.spawn_ranks(inp, str(root))
    try:
        single = tpc.run_cases(inp)
        jx = jax_side(inp)
    finally:
        ranks = tpc.join_ranks(ctx, str(root), deadline_s=600)
    return ranks, single, jx, inp


# ------------------------------------------------------------------- tests


def test_pad_keypoints_matches_jax():
    from mba_vo_tpu_torch.ops.residual import TrackingLevelData

    data = make_data(true_knots(), n_kp=38)
    a = level_arrays(data)
    tdata = tpc.level_data(a)
    for multiple in (1, 4, 8):
        jp = jmesh.pad_keypoints(data, multiple)
        tp = tmesh.pad_keypoints(tdata, multiple)
        assert isinstance(tp, TrackingLevelData)
        for f in tmesh.level_data_specs():
            np.testing.assert_array_equal(tpc.npy(getattr(tp, f)), np.asarray(getattr(jp, f)))
    # shard_level_data without a process group: one rank holds every keypoint
    one = tmesh.make_mesh(1)
    assert one.group is None and (one.size, one.rank) == (1, 0)
    np.testing.assert_array_equal(tpc.npy(tmesh.shard_level_data(tdata, one).kp_xy), a["kp_xy"])
    with pytest.raises(ValueError, match="shard_devices=4 but only 1 devices are visible"):
        tmesh.make_mesh(4)


def test_initialize_from_env_noop(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize_from_env() is False
    assert not torch.distributed.is_initialized()
    assert tdist.local_device().type == ("cuda" if torch.cuda.is_available() else "cpu")


@pytest.mark.parametrize("sampling,n", tpc.EVALUATE)
def test_sharded_evaluate(runs, sampling, n):
    ranks, single, jx, _ = runs
    got = ranks[0][("evaluate", sampling, n)]
    for ref in (jx[("evaluate", sampling, n)], single[("evaluate", sampling, 0)]):
        np.testing.assert_allclose(got["cost"], ref["cost"], rtol=1e-12)
        np.testing.assert_allclose(got["g"], ref["g"], rtol=1e-9)
        np.testing.assert_allclose(got["H"], ref["H"], rtol=1e-9)
        np.testing.assert_allclose(got["patch_costs"][:, :40], ref["patch_costs"][:, :40],
                                   rtol=1e-9)


def jknots(k):
    return jmake(jnp.asarray(k["t"]), jnp.asarray(k["q"]), k["t0"], k["dt"])


def pose_error(k):
    """Translation and rotation error of knots at the capture time, as
    tests/test_lm.py measures them."""
    from test_lm import pose_error as jpose_error

    return jpose_error(jknots(k), true_knots(), CAP)


def assert_same_level(got, ref):
    """The same LM run of a level: iterations, the pose at the capture time
    (LEVEL_POSE_TOL) and the knots (LEVEL_KNOT_TOL)."""
    assert got["num_iterations"] == ref["num_iterations"]
    assert got["patch_costs"].shape == (1, 40) and got["outlier_mask"].shape == (40,)
    pg, pr = (spline_pose_at(jknots(k), CAP, 2) for k in (got["knots"], ref["knots"]))
    np.testing.assert_allclose(np.asarray(pg.t), np.asarray(pr.t), atol=LEVEL_POSE_TOL, rtol=0)
    np.testing.assert_allclose(np.asarray(pg.q), np.asarray(pr.q), atol=LEVEL_POSE_TOL, rtol=0)
    for k in ("t", "q"):
        np.testing.assert_allclose(got["knots"][k], ref["knots"][k], atol=LEVEL_KNOT_TOL, rtol=0)


@pytest.mark.parametrize("name", ["direct", "windowed"])
def test_sharded_lm_recovers(runs, name):
    ranks, single, jx, _ = runs
    got = ranks[0][("lm", name)]
    for ref in (jx[("lm", name)], single[("lm", name)]):
        assert_same_level(got, ref)
    dt, dr = pose_error(got["knots"])
    assert dt < 5e-4 and dr < 3e-4
    assert got["final_cost"] < 1e-2 and got["num_iterations"] >= 2


def test_sharded_outlier_masking(runs):
    """Outlier statistics are global: the corrupted keypoint 33 (in the last
    of 4 shards) is masked, and the gathered mask covers all keypoints."""
    ranks, single, jx, _ = runs
    got = ranks[0][("lm", "outliers")]
    assert got["outlier_mask"].shape == (40,) and got["outlier_mask"][33] == 0.0
    for ref in (jx[("lm", "outliers")], single[("lm", "outliers")]):
        np.testing.assert_array_equal(got["outlier_mask"], ref["outlier_mask"])
        assert_same_level(got, ref)
    dt, dr = pose_error(got["knots"])
    assert dt < 1e-3 and dr < 1e-3


def test_pod_mesh_matches_flat(runs):
    """A (2, 2) pod mesh reduces over all four ranks: the flat 4-rank run's
    bits, and the JAX pod run's result."""
    ranks, _, jx, _ = runs
    pod, flat = ranks[0][("pod",)], ranks[0][("lm", "direct")]
    for k in ("t", "q"):
        np.testing.assert_array_equal(pod["knots"][k], flat["knots"][k])
    assert_same_level(pod, jx[("pod",)])


@pytest.mark.parametrize("case", tpc.TRACKER_CASES)
def test_sharded_tracker(runs, case):
    """shard_devices = 4 routes every level of track_frames (direct path and
    affine) and track_frames_joint through the sharded LM: the same poses,
    knots and keyframe statistics as the single-process tracker and as the
    JAX tracker with shard_devices = 4."""
    ranks, single, jx, _ = runs
    got = ranks[0][("tracker", case)]
    assert got["mesh"] == (tpc.WORLD, 0) and single[("tracker", case)]["mesh"] is None
    for ref in (jx[("tracker", case)], single[("tracker", case)]):
        np.testing.assert_allclose(got["poses"], ref["poses"], atol=TRACK_TOL, rtol=0)
        for k in ("t", "q"):
            np.testing.assert_allclose(got["knots"][k], ref["knots"][k], atol=TRACK_TOL, rtol=0)
    np.testing.assert_allclose(got["stats"], single[("tracker", case)]["stats"], atol=1e-9,
                               rtol=0)
    # what each level hands back to the tracker covers every keypoint: the
    # gathered outlier mask and patch costs (the joint health check sums
    # the latter) equal the single-process ones
    want = single[("tracker", case)]["levels"]
    assert len(got["levels"]) == len(want) > 0
    for (mask, costs), (mask1, costs1) in zip(got["levels"], want):
        np.testing.assert_array_equal(mask, mask1)
        assert costs.shape == costs1.shape
        np.testing.assert_allclose(costs, costs1, rtol=1e-9, atol=1e-15)


@pytest.mark.parametrize("key", sorted(tpc.BA_CASES))
def test_sharded_ba(runs, key):
    """Landmark-sharded BA against the dense solve and the JAX sharded solve;
    padded landmark slots (58 landmarks on 4 ranks) stay where they were."""
    ranks, single, jx, inp = runs
    got, dense = ranks[0][("ba", key)], single[("ba", key)]
    n = inp[key]["points"].shape[0]
    assert got["points"].shape[0] % tpc.WORLD == 0
    for ref in (dense, jx[("ba", key)]):
        np.testing.assert_allclose(got["pose_t"], ref["pose_t"], atol=BA_TOL, rtol=0)
        np.testing.assert_allclose(got["points"][:n], ref["points"][:n], atol=BA_TOL, rtol=0)
        assert got["num_iterations"] == ref["num_iterations"]
    np.testing.assert_array_equal(got["points"][n:], np.ones((got["points"].shape[0] - n, 3)))
    assert np.isfinite(got["final_cost"])
    if key == "ba":
        assert got["final_cost"] < 1e-8
    else:
        assert got["points"].shape[0] > n


def test_vo_backend_sharded(runs):
    """VOBackend(shard_devices = 4) builds its mesh and refines every
    keyframe as the dense backend does, and as the JAX sharded backend."""
    ranks, single, jx, _ = runs
    got, dense = ranks[0][("backend",)], single[("backend",)]
    assert got["mesh"] == (tpc.WORLD, 0) and dense["mesh"] is None
    assert got["ba_iterations"] == dense["ba_iterations"] and got["landmarks"] == dense[
        "landmarks"]
    assert sum(i or 0 for i in got["ba_iterations"]) > 0
    for ref in (dense["poses"], jx[("backend",)]):
        np.testing.assert_allclose(got["poses"], ref, atol=BA_TOL, rtol=0)


def test_cli_shard_devices(runs):
    """``track --shard-devices 4 --backend ba --chunk 2`` inside the ranks'
    process group: rank 0 alone writes the trajectory, which is the
    single-process command line's (tests/test_torch_cli.py holds that one
    against the JAX command line)."""
    ranks, single, _, _ = runs
    assert all(r[("cli",)] is None for r in ranks[1:])
    got = ranks[0][("cli",)]
    assert got is not None and got.shape == single[("cli",)].shape
    np.testing.assert_allclose(got, single[("cli",)], atol=TUM_TOL, rtol=0)


def _same_bits(a, b, where=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            if k != "mesh":
                _same_bits(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same_bits(x, y, f"{where}[{i}]")
    elif a is None or isinstance(a, (int, str)):
        assert a == b, where
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True), where


def test_every_rank_ends_with_the_same_bits(runs):
    """All-reduced normal equations are byte-identical on every rank, so
    every rank takes the same branches and ends with the same knots, poses,
    masks and maps (the 2-rank evaluations on ranks 0 and 1 only; the
    command line's file on rank 0 only)."""
    ranks = runs[0]
    for key in ranks[0]:
        if key in (("seconds",), ("cli",)):
            continue
        holders = [r for r in ranks if key in r]
        assert len(holders) == (2 if key[0] == "evaluate" and key[2] == 2 else tpc.WORLD), key
        for r in holders[1:]:
            _same_bits(holders[0][key], r[key], str(key))
