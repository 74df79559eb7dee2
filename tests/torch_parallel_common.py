"""The port's sharded cases, run in gloo CPU ranks by tests/test_torch_parallel.py.

``run_cases(inputs, rank)`` runs every case of the port on this rank's
shards (every rank of a group of WORLD ranks makes the same calls in the
same order) and, with ``rank=None``, the same cases in one process without
a mesh: the single-process results the sharded ones are held against.
``spawn_ranks`` starts WORLD ranks (``spawn`` context, one intra-op thread
each, a FileStore rendezvous, a process-group timeout of TIMEOUT) and
``join_ranks`` collects their results, failing as soon as a rank fails or
the deadline passes.

This module imports no JAX: the ranks import only torch, numpy and the
port. The inputs are numpy arrays made by the test with the JAX package.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import os
import time

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4
TIMEOUT = datetime.timedelta(seconds=60)
NUM_VIR, DEGREE = 3, 2
F64 = torch.float64


def t64(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=F64)


def npy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------ port inputs


def level_data(a: dict):
    from mba_vo_tpu_torch.ops.image import image_gradients
    from mba_vo_tpu_torch.ops.residual import TrackingLevelData

    img = t64(a["img_ref"])
    return TrackingLevelData(
        img_ref=img, grad_ref=image_gradients(img), cur_imgs=t64(a["cur_imgs"]),
        cap_times=t64(a["cap_times"]), exp_times=t64(a["exp_times"]),
        kp_xy=t64(a["kp_xy"]), kp_z=t64(a["kp_z"]), kp_mask=t64(a["kp_mask"]),
        pattern=torch.as_tensor(np.asarray(a["pattern"])), K=t64(a["K"]))


def knots(a: dict):
    from mba_vo_tpu_torch.core.spline import make_knots

    return make_knots(t64(a["t"]), t64(a["q"]), a["t0"], a["dt"])


def knots_result(k) -> dict:
    return dict(t=npy(k.t), q=npy(k.q), t0=float(k.t0), dt=float(k.dt))


# ------------------------------------------------------------------ cases


def case_evaluate(inp, sampling, mesh):
    """The objective at ``inp["at"]`` with every keypoint an inlier; the
    patch costs are gathered back to all keypoints. ``"compensated"`` is the
    windowed path with Kahan-combined normal equations on each rank."""
    from mba_vo_tpu_torch.ops.residual import evaluate
    from mba_vo_tpu_torch.parallel.mesh import shard_level_data
    from mba_vo_tpu_torch.utils.collectives import allgather

    data = level_data(inp["level"])
    group = None
    if mesh is not None:
        data, group = shard_level_data(data, mesh), mesh.group
    mask = torch.ones(data.kp_mask.shape[0], dtype=F64)
    compensated = sampling == "compensated"
    ev = evaluate(knots(inp["at"]), data, NUM_VIR, DEGREE, 10.0, mask, True,
                  sampling="windowed" if compensated else sampling, window=32,
                  compensated=compensated, group=group)
    return dict(cost=float(ev.cost), g=npy(ev.gradient), H=npy(ev.hessian),
                patch_costs=npy(allgather(ev.patch_costs, group, dim=1)))


def case_lm(inp, level, opts_kw, mesh, pod=False):
    """optimize_level from identity knots; sharded through
    optimize_level_sharded, or optimize_level_sharded_pod on a pod mesh."""
    from mba_vo_tpu_torch.parallel.mesh import shard_level_data
    from mba_vo_tpu_torch.parallel.sharded import (
        optimize_level_sharded, optimize_level_sharded_pod,
    )
    from mba_vo_tpu_torch.solver.lm import LMOptions, optimize_level

    data, init, opts = level_data(inp[level]), knots(inp["init"]), LMOptions(**opts_kw)
    if mesh is None:
        k, s = optimize_level(init, data, NUM_VIR, DEGREE, opts)
    else:
        fn = optimize_level_sharded_pod if pod else optimize_level_sharded
        k, s = fn(init, shard_level_data(data, mesh), NUM_VIR, DEGREE, opts, mesh)
    return dict(knots=knots_result(k), final_cost=float(s.final_cost),
                num_iterations=int(s.num_iterations), outlier_mask=npy(s.outlier_mask),
                patch_costs=npy(s.patch_costs))


def tracker_config(fields: dict, shard: int, **kw):
    from mba_vo_tpu_torch.tracker.blur_tracker import TrackerConfig
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    f = dict(fields, **kw)
    f["detector"] = DetectorOptions(**f["detector"])
    f["num_virtual_poses"] = tuple(f["num_virtual_poses"])
    return TrackerConfig(**f, shard_devices=shard)


def case_tracker(inp, case, shard):
    """The port's tracker from the scene's keyframe and a moving state:
    track_frames in chunks of 2 (``"frames"``, and ``"affine"`` on frames
    under a drifting gain and bias) or one joint chunk of 4 from an
    installed moving window (``"joint"``). ``levels`` records every level's
    outlier mask and patch costs as the tracker receives them: all
    keypoints', gathered from the shards."""
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.tracker import blur_tracker as bt
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker

    levels, run_level = [], bt._run_level

    def recorded(*args, **kw):
        k, summary = run_level(*args, **kw)
        levels.append((npy(summary.outlier_mask), npy(summary.patch_costs)))
        return k, summary

    sc = inp["scene"]
    cfg = tracker_config(inp["tracker_cfg"], shard, affine_brightness=case == "affine")
    tr = BlurAwareTracker(cfg, sc["kvec"], tuple(sc["hw"]), device="cpu")
    tr.track_frame(sc["img"], sc["img"], 0.0, sc["exposure"], sc["depth0"])
    state = {"neigh_velocity": inp["velocity"]}
    if case == "joint":
        state.update(joint_knots=inp["joint_window"], joint_dt=inp["joint_window"]["dt"])
    interop.install_tracker_state(tr, state)
    frames = sc["gained"] if case == "affine" else sc["blurred"]
    bt._run_level = recorded
    try:
        if case == "joint":
            poses = tr.track_frames_joint(frames, sc["caps"], sc["exps"], chunk=4)
            final = tr._joint_knots
        else:
            poses = tr.track_frames(frames, sc["caps"], sc["exps"], chunk=2)
            final = tr.knots
    finally:
        bt._run_level = run_level
    return dict(poses=np.stack([np.concatenate([npy(p.t), npy(p.q)]) for p in poses]),
                knots=knots_result(final), stats=np.asarray(tr.last_track_stats),
                levels=levels, mesh=None if tr.mesh is None else (tr.mesh.size, tr.mesh.rank))


def case_ba(inp, key, opts_kw, mesh):
    """run_bundle_adjustment on the dense problem, or
    run_bundle_adjustment_sharded on this rank's landmark slice."""
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.backend.ba import BAOptions, run_bundle_adjustment
    from mba_vo_tpu_torch.parallel.sharded_ba import (
        run_bundle_adjustment_sharded, shard_ba_problem,
    )

    prob = interop.ba_problem_from_arrays(**inp[key])
    opts = BAOptions(**opts_kw)
    if mesh is None:
        out, s = run_bundle_adjustment(prob, opts)
    else:
        local = shard_ba_problem(prob, mesh)
        out, s = run_bundle_adjustment_sharded(local, opts, mesh)
    return dict(pose_t=npy(out.poses.t), pose_q=npy(out.poses.q), points=npy(out.map.points),
                point_mask=npy(out.map.point_mask), initial_cost=float(s.initial_cost),
                final_cost=float(s.final_cost), num_iterations=int(s.num_iterations))


def case_backend(inp, shard):
    """VOBackend over the drift sequence's keyframes (BA only)."""
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.backend.vo_backend import BackendConfig, VOBackend

    b = inp["backend"]
    be = VOBackend(BackendConfig(**b["config"], shard_devices=shard), b["kvec"], device="cpu")
    iters = []
    for k, (img, t) in enumerate(zip(b["sharp"], b["fed"])):
        be.on_keyframe(img, b["depth"], interop.pose_from_arrays(t, b["q"]), float(k))
        iters.append(be.last_summary.num_iterations if be.last_summary else None)
    poses = np.stack([np.concatenate([kf.pose.t, kf.pose.q]) for kf in be.keyframes])
    return dict(poses=poses, ba_iterations=iters, landmarks=len(be.landmarks),
                mesh=None if be.mesh is None else (be.mesh.size, be.mesh.rank))


def case_cli(inp, shard, rank):
    """``track`` on the command-line fixture: each rank names its own
    output, and only rank 0 may write one."""
    from mba_vo_tpu_torch import cli
    from mba_vo_tpu_torch.data import datasets as ds

    out = os.path.join(inp["cli"]["root"], f"t_shard{shard}_rank{rank}.txt")
    argv = [*inp["cli"]["argv"], "--output", out, "--device", "cpu"]
    if shard:
        argv += ["--shard-devices", str(shard)]
    # two decoder threads a rank, not two processes
    read_ahead, cli.READ_AHEAD = cli.READ_AHEAD, "thread"
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(argv) == 0
    finally:
        cli.READ_AHEAD = read_ahead
    if not os.path.exists(out):
        return None
    times, t, q = ds.load_tum_trajectory(out)
    return np.concatenate([times[:, None], t, q], axis=1)


EVALUATE = [(s, n) for s in ("direct", "windowed") for n in (2, 4)] + [("compensated", 4)]
LM_OPTS = dict(huber_a=100.0, max_chi_square_error=1e9, min_abs_cost_decrease=1e-7)
LM_CASES = {
    "direct": ("level", LM_OPTS),
    "windowed": ("level", dict(LM_OPTS, sampling="windowed", window=32)),
    "outliers": ("level_bad", dict(LM_OPTS, max_chi_square_error=3.0)),
}
TRACKER_CASES = ("frames", "affine", "joint")
BA_CASES = {"ba": dict(max_iterations=30, huber_a=1e6), "ba_padded": dict(max_iterations=3,
                                                                          huber_a=1e6)}


def run_cases(inp: dict, rank=None) -> dict:
    """Every case on this rank's shards (``rank`` set, inside the process
    group of WORLD ranks) or in one process (``rank=None``)."""
    from mba_vo_tpu_torch.parallel.distributed import make_pod_mesh
    from mba_vo_tpu_torch.parallel.mesh import make_mesh
    from mba_vo_tpu_torch.parallel.sharded_ba import make_ba_mesh

    sharded = rank is not None
    meshes = {n: None for n in (2, 4)}
    if sharded:
        meshes[4] = make_mesh(WORLD)
        # new_group is collective: every rank asks for the 2-rank mesh, and
        # the ranks outside it are told so
        try:
            meshes[2] = make_mesh(2)
        except ValueError as e:
            assert "outside the mesh" in str(e), e
    out = {}
    for sampling, n in EVALUATE:
        if not sharded and n == 4 and sampling != "compensated":
            continue
        if sharded and meshes[n] is None:
            continue
        out[("evaluate", sampling, n if sharded else 0)] = case_evaluate(
            inp, sampling, meshes[n])
    for name, (level, opts) in LM_CASES.items():
        out[("lm", name)] = case_lm(inp, level, opts, meshes[4])
    if sharded:
        pod = make_pod_mesh(2, 2)
        assert pod.shape == (2, 2) and pod.axis_names == ("host", "kp")
        out[("pod",)] = case_lm(inp, "level", LM_OPTS, pod, pod=True)
    for case in TRACKER_CASES:
        out[("tracker", case)] = case_tracker(inp, case, WORLD if sharded else 0)
    ba_mesh = make_ba_mesh(WORLD) if sharded else None
    for key, opts in BA_CASES.items():
        out[("ba", key)] = case_ba(inp, key, opts, ba_mesh)
    out[("backend",)] = case_backend(inp, WORLD if sharded else 0)
    out[("cli",)] = case_cli(inp, WORLD if sharded else 0, rank or 0)
    return out


# ----------------------------------------------------------------- ranks


def _rank_main(rank, world, store_path, inputs_path, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=TIMEOUT)
    try:
        inp = torch.load(inputs_path, weights_only=False)
        t0 = time.perf_counter()
        res = run_cases(inp, rank)
        res[("seconds",)] = time.perf_counter() - t0
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(inputs: dict, out_dir: str):
    """Start WORLD gloo ranks on ``inputs``; returns the process context."""
    import torch.multiprocessing as mp

    path = os.path.join(out_dir, "inputs.pt")
    torch.save(inputs, path)
    return mp.start_processes(
        _rank_main, args=(WORLD, os.path.join(out_dir, "store"), path, out_dir),
        nprocs=WORLD, join=False, start_method="spawn")


def join_ranks(ctx, out_dir: str, deadline_s: float) -> list:
    """Every rank's results; a failed rank raises here (and its peers are
    ended), and so does a run past the deadline."""
    end = time.time() + deadline_s
    while not ctx.join(timeout=2):
        if time.time() > end:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"the ranks ran past {deadline_s} s")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]
