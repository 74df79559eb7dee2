"""Command-line driver of the PyTorch port: ``python -m mba_vo_tpu_torch.cli``.

Counterpart of ``mba_vo_tpu/cli.py``, with the same subcommands, options
and files:
  track   run the tracker over an image folder + depth maps and write a TUM
          trajectory, optionally behind the keyframe backend
          (``--backend ba|ba+pg``)
  synth   generate a synthetic blurred sequence (planar scene, or with
          ``--scene 3d`` a slanted plane and spheres, ray cast, with true
          per-frame depth maps)
  eval    ATE/RPE between two TUM trajectory files

``--device`` picks where the tracker and the backend run ("cuda" by
default; "cpu" runs the same code on the CPU). A config with
``"dtype": "float64"`` runs the tracker and the backend's solvers in
float64. ``track --distortion k1,k2,p1,p2`` and ``--camera-model unified
--xi XI`` undistort every frame (and depth map) onto the pinhole view
before tracking: the pixel map is built once in float32 on the tracker's
device, frames are remapped bilinearly, depth maps through the rounded map
(nearest neighbour), and the frames stay on the device. ``--viz-dir`` writes
an overlay PNG per tracked frame (keypoints and their blur-kernel
polylines).

``track --shard-devices n`` shards the tracker's keypoints (and the
backend's BA landmarks) over n processes: launch it with
``python -m torch.distributed.run --nproc-per-node n -m mba_vo_tpu_torch.cli
track ... --shard-devices n``. Each rank works on ``cuda:LOCAL_RANK`` (ranks
may share a card, and then talk through gloo; NCCL when each has its own),
and only rank 0 writes the trajectory, checkpoints, overlays and backend
statistics. Without the launcher's environment it raises ``ValueError``.

``track`` reads frame i + 1 while frame i tracks: the blurred frames decode
ahead in two spawned worker processes (the PNG row filters are undone in
Python, which a thread would run under the lock the tracker's dispatch
needs), depth maps in a thread pool, and unreal ASCII depth through the
runtime library's native ``DepthPrefetcher``. Sharp keyframe images are
read on the calling thread, and undistortion runs there, on the tracker's
device.

Sequence format for ``track``:
  --images DIR        sorted 8-bit grey PNG frames
  --times FILE        lines "<image_name> <capture_time> <exposure_time>"
                      (absent: frame index * --frame-dt, fixed exposure)
  --depths DIR        depth maps in image order (read on keyframes only):
                      "eth3d" 16-bit PNG / 5000 or .npy, "unreal" ASCII,
                      "npy"
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np


def _build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="mba_vo_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("track", help="run the blur-aware tracker")
    t.add_argument("--images", required=True, help="image folder")
    t.add_argument("--sharp-images",
                   help="folder of sharp keyframe images matching --images order; "
                        "without it the blurred frame is its own keyframe")
    t.add_argument("--depths", help="depth-map folder (keyframes)")
    t.add_argument("--dataset-type", default="eth3d", choices=["unreal", "eth3d", "npy"])
    t.add_argument("--intrinsics", required=True, help="fx,fy,cx,cy")
    t.add_argument("--times", help="timestamps file")
    t.add_argument("--frame-dt", type=float, default=0.05)
    t.add_argument("--exposure", type=float, default=0.02)
    t.add_argument("--config", help="tracker config JSON")
    t.add_argument("--output", default="trajectory.txt")
    t.add_argument("--checkpoint-every", type=int, default=0)
    t.add_argument("--checkpoint-dir", default="ckpt")
    t.add_argument("--resume", action="store_true")
    t.add_argument("--max-frames", type=int, default=0)
    t.add_argument("--chunk", type=int, default=1,
                   help="frames per track_frames chunk (1 = per-frame tracking)")
    t.add_argument("--inflight", type=int, default=2,
                   help="chunks dispatched ahead of their statistics")
    t.add_argument("--distortion",
                   help="k1,k2,p1,p2 radial-tangential coefficients of the input "
                        "images (pass as --distortion=... when k1 is negative); "
                        "frames and depth maps are undistorted to the pinhole model "
                        "before tracking")
    t.add_argument("--camera-model", choices=["pinhole", "unified"], default="pinhole",
                   help="input camera model; 'unified' (omnidirectional) frames are "
                        "remapped to the pinhole view given --xi")
    t.add_argument("--xi", type=float, default=0.0,
                   help="unified-model mirror parameter (with --camera-model unified)")
    t.add_argument("--backend", choices=["none", "ba", "ba+pg"], default="none",
                   help="keyframe backend: 'ba' = sliding-window Schur BA with "
                        "odometry priors; 'ba+pg' adds PnP loop closure and the "
                        "pose graph")
    t.add_argument("--backend-window", type=int, default=7,
                   help="BA window size in keyframes")
    t.add_argument("--backend-config", help="JSON file of BackendConfig overrides")
    t.add_argument("--backend-stats",
                   help="write the backend's per-keyframe record (ms by stage, each "
                        "stage ended by a device synchronisation; BA and pose-graph "
                        "iterations; loop edges; device-to-host reads) to this JSON "
                        "file")
    t.add_argument("--shard-devices", type=int, default=0,
                   help="shard the tracker's keypoints (and the backend's BA landmarks) "
                        "over this many ranks; run under python -m "
                        "torch.distributed.run --nproc-per-node N")
    t.add_argument("--joint-window", action="store_true",
                   help="optimise each chunk as one joint LM problem over a sliding "
                        "knot window (needs --chunk > 1)")
    t.add_argument("--viz-dir",
                   help="write per-frame overlay PNGs (keypoints and estimated "
                        "blur-kernel polylines); with --chunk > 1 each frame's overlay "
                        "comes from its own committed knot window, rejected frames "
                        "are skipped")
    t.add_argument("--device", default="cuda", help="torch device (default cuda)")

    s = sub.add_parser("synth", help="generate a synthetic blurred sequence")
    s.add_argument("--output", required=True, help="output directory")
    s.add_argument("--texture", choices=("shapes", "random"), default="shapes")
    s.add_argument("--trajectory", choices=("random", "loop"), default="random")
    s.add_argument("--noise", type=float, default=0.0)
    s.add_argument("--scene", choices=("planar", "3d"), default="planar")
    s.add_argument("--num-frames", type=int, default=20)
    s.add_argument("--height", type=int, default=480)
    s.add_argument("--width", type=int, default=640)
    s.add_argument("--exposure", type=float, default=0.03)
    s.add_argument("--frame-dt", type=float, default=0.1)
    s.add_argument("--depth", type=float, default=2.0)
    s.add_argument("--num-samples", type=int, default=31)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--device", default="cuda", help="torch device (default cuda)")

    e = sub.add_parser("eval", help="ATE/RPE between two TUM trajectories")
    e.add_argument("--est", required=True)
    e.add_argument("--ref", required=True)
    e.add_argument("--with-scale", action="store_true")
    return p


def _depth_paths(args, ds):
    if not args.depths:
        return []
    names = sorted(os.listdir(args.depths))
    if args.dataset_type == "eth3d":
        # 16-bit PNGs, and the .npy maps `synth` writes
        return [os.path.join(args.depths, f) for f in names
                if f.lower().endswith(ds.IMAGE_EXTENSIONS + (".npy",))]
    return [os.path.join(args.depths, f) for f in names]


def _build_backend(args, cfg, K, device):
    from .backend.vo_backend import BackendConfig, VOBackend
    from .utils.config import backend_config_from_dict

    if args.backend_config:
        with open(args.backend_config) as f:
            bcfg = backend_config_from_dict(json.load(f))
    else:
        bcfg = BackendConfig()
    rep = dict(window_size=args.backend_window, run_pose_graph=(args.backend == "ba+pg"))
    # the flag overrides only when given: a shard_devices of the backend
    # config file survives the flag's default
    if args.shard_devices > 1:
        rep["shard_devices"] = args.shard_devices
    bcfg = dataclasses.replace(bcfg, **rep)
    return VOBackend(bcfg, K, device=device, dtype=cfg.dtype,
                     profile=bool(args.backend_stats))


# where track's blurred frames decode ahead of the tracker: "process" (two
# spawned workers), "thread" (two threads) or None (every file on the
# calling thread). A seam for tests and measurements; the command line
# always runs "process", which decodes filtered PNGs fastest on the card's
# host (PERF.md section 5)
READ_AHEAD = "process"


class _Prefetcher:
    """The files of ``track``, read ahead of the tracker as the reference's
    command line reads them (``mba_vo_tpu/cli.py``).

    ``image(i)`` returns frame i's blurred image (float32, as
    ``datasets.load_gray_image`` reads it) and submits the reads of the
    next ``max(4, --chunk)`` frames: their PNGs decode in the pool of
    ``READ_AHEAD`` (two spawned processes, which hand back the uint8
    pixels, or two threads) and their depth maps in two threads, or, for
    unreal ASCII depth, in the runtime library's native ``DepthPrefetcher``.
    ``depth(i)`` returns frame i's depth map (float32 z-depth, or the .npy
    array as stored). A frame that was not submitted, and every frame when
    ``READ_AHEAD`` is None, is read on the calling thread."""

    WORKERS = 2

    def __init__(self, args, image_paths, depth_paths, K, H, W):
        from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

        self.args, self.image_paths, self.depth_paths = args, image_paths, depth_paths
        self.K, self.H, self.W = K, H, W
        self.ahead = max(4, args.chunk)
        self._images, self._depths = {}, {}
        self.threads = self.decoder = self.native = None
        self.parse_depth_file = None
        if depth_paths and args.dataset_type == "unreal":
            # the runtime library (loaded only on this path): its native
            # ASCII parser, and its thread pool when reading ahead
            runtime = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "runtime")
            if runtime not in sys.path:
                sys.path.insert(0, runtime)
            from bindings import DepthPrefetcher, parse_depth_file

            self.parse_depth_file = parse_depth_file
            if READ_AHEAD is not None:
                self.native = DepthPrefetcher(self.WORKERS)
        if READ_AHEAD is None:
            return
        self.threads = ThreadPoolExecutor(max_workers=self.WORKERS)
        self.decoder = self.threads
        if READ_AHEAD == "process":
            import multiprocessing

            self.decoder = ProcessPoolExecutor(
                max_workers=self.WORKERS, mp_context=multiprocessing.get_context("spawn"))

    def _depth_now(self, path):
        if path.lower().endswith(".npy") or self.args.dataset_type == "npy":
            return np.load(path)
        from .data import datasets as ds

        if self.args.dataset_type == "unreal":
            raw = (self.native.fetch(path, self.H, self.W) if self.native is not None
                   else self.parse_depth_file(path, self.H, self.W))
            return ds.ray_depth_to_z(raw, self.K)
        return ds.load_depth(path, "eth3d")

    def _submit_ahead(self, j0: int):
        from .data.png import read_png

        for j in range(j0, min(j0 + self.ahead, len(self.image_paths))):
            if j not in self._images:
                self._images[j] = self.decoder.submit(read_png, self.image_paths[j])
            if self.depth_paths and j not in self._depths:
                if self.native is not None:
                    self.native.submit(self.depth_paths[j])
                    self._depths[j] = None
                else:
                    self._depths[j] = self.threads.submit(self._depth_now,
                                                          self.depth_paths[j])

    def image(self, i: int) -> np.ndarray:
        from .data import datasets as ds

        fut = self._images.pop(i, None)
        img = (ds.gray_image(fut.result()) if fut is not None
               else ds.load_gray_image(self.image_paths[i]))
        if self.decoder is not None:
            self._submit_ahead(i + 1)
        return img

    def depth(self, i: int) -> np.ndarray:
        fut = self._depths.pop(i, None)
        return self._depth_now(self.depth_paths[i]) if fut is None else fut.result()

    def close(self):
        for pool in {self.threads, self.decoder} - {None}:
            pool.shutdown(wait=True, cancel_futures=True)


def _undistorters(args, K, H, W, device):
    """(frame, depth map) -> what the tracker takes: identities without
    --distortion and --camera-model unified; otherwise remaps onto the
    pinhole view through one float32 map built on ``device``, bilinear for
    frames and through the rounded map (nearest neighbour: no depth blended
    across an occlusion boundary) for depth maps, each returning a float32
    tensor on ``device``."""
    if not args.distortion and args.camera_model == "pinhole":
        return (lambda im: im), (lambda d: d)
    import torch

    from .models.camera import PinholeCamera, RadTanDistortion, UnifiedCamera
    from .ops.image import build_undistort_map, remap

    f32 = dict(dtype=torch.float32, device=device)
    dist = None
    if args.distortion:
        dist = RadTanDistortion(*(torch.tensor(float(x), **f32)
                                  for x in args.distortion.split(",")))
    Kf = torch.tensor(K, **f32)
    if args.camera_model == "unified":
        src = UnifiedCamera(K=Kf, xi=torch.tensor(args.xi, **f32), height=H, width=W,
                            distortion=dist)
    else:
        src = PinholeCamera(K=Kf, height=H, width=W, distortion=dist)
    umap = build_undistort_map(src, PinholeCamera(K=Kf, height=H, width=W))
    umap_nn = torch.round(umap)

    def frame(im):
        return remap(torch.as_tensor(im, **f32), umap)

    def depth(d):
        return None if d is None else remap(torch.as_tensor(d, **f32), umap_nn)

    return frame, depth


def cmd_track(args) -> int:
    import torch

    from .data import datasets as ds
    from .tracker.blur_tracker import BlurAwareTracker, TrackerConfig
    from .utils import viz
    from .utils.checkpoint import load_tracker_state, save_tracker_state
    from .utils.config import load_tracker_config
    from .utils.profiling import StageTimer

    K = np.array([float(x) for x in args.intrinsics.split(",")])
    if K.shape != (4,):
        print("--intrinsics must be fx,fy,cx,cy", file=sys.stderr)
        return 2

    image_paths = ds.list_image_folder(args.images)
    if not image_paths:
        print(f"no images found in {args.images}", file=sys.stderr)
        return 2
    if args.max_frames:
        image_paths = image_paths[: args.max_frames]

    depth_paths = _depth_paths(args, ds)
    if args.depths and not depth_paths:
        print(f"no depth maps found in {args.depths}", file=sys.stderr)
        return 2
    if depth_paths and len(depth_paths) < len(image_paths):
        print(f"depth/image count mismatch: {len(depth_paths)} depth maps for "
              f"{len(image_paths)} images", file=sys.stderr)
        return 2

    sharp_paths = ds.list_image_folder(args.sharp_images) if args.sharp_images else []
    if sharp_paths and len(sharp_paths) < len(image_paths):
        print(f"sharp/blurred count mismatch: {len(sharp_paths)} sharp images "
              f"for {len(image_paths)} blurred frames", file=sys.stderr)
        return 2
    if not sharp_paths:
        print("warning: no --sharp-images given; keyframes will reuse the "
              "tracked (blurred) frame, which violates the sharp-keyframe "
              "model when blur is strong", file=sys.stderr)

    times = {}
    if args.times:
        with open(args.times) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3 and not line.startswith("#"):
                    times[parts[0]] = (float(parts[1]), float(parts[2]))

    H, W = ds.load_gray_image(image_paths[0]).shape
    cfg = load_tracker_config(args.config) if args.config else TrackerConfig()
    if args.shard_devices > 1:
        cfg = dataclasses.replace(cfg, shard_devices=args.shard_devices)
    device = torch.device(args.device)
    # under python -m torch.distributed.run: one process per shard, each on
    # its own card (or sharing one), rank 0 writing every output
    from .parallel.distributed import initialize_from_env, local_device

    owned = not torch.distributed.is_initialized()
    distributed = initialize_from_env()
    writer = not distributed or torch.distributed.get_rank() == 0
    if distributed and device.type == "cuda":
        device = local_device()
    backend = _build_backend(args, cfg, K, device) if args.backend != "none" else None
    tracker = BlurAwareTracker(cfg, K, (H, W), backend=backend, device=device)
    undistort, undistort_depth = _undistorters(args, K, H, W, tracker.device)

    start_idx = 0
    meta_path = os.path.join(args.checkpoint_dir, "meta.json")
    if args.resume and os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        load_tracker_state(tracker, os.path.join(args.checkpoint_dir, "state"))
        start_idx = meta["next_frame"]
        print(f"resumed at frame {start_idx}")

    reader = _Prefetcher(args, image_paths, depth_paths, K, H, W)
    try:
        def load_image(i):
            return undistort(reader.image(i))

        def load_depth(i):
            return undistort_depth(reader.depth(i)) if depth_paths else None

        def load_sharp(i, blurred):
            return undistort(ds.load_gray_image(sharp_paths[i])) if sharp_paths else blurred

        def frame_meta(i):
            name = os.path.basename(image_paths[i])
            return times.get(name, (i * args.frame_dt, args.exposure))

        out_times, out_t, out_q = [], [], []

        def record(i, cap, pose, kernel=None):
            out_times.append(cap)
            out_t.append(pose.t.detach().double().cpu().numpy())
            out_q.append(pose.q.detach().double().cpu().numpy())
            if kernel is None:
                # per-frame path: the statistics resolve one frame late, so this
                # is the previous frame's kernel length
                kernel = tracker.avg_kernel_length
            tail = ("(rejected, pose held)" if kernel is not None and np.isnan(kernel)
                    else f"kernel={kernel:.2f}px")
            if writer:
                print(f"frame {i:4d} t={cap:.3f} pos="
                      + np.array2string(out_t[-1], precision=4) + " " + tail)
            if args.viz_dir and chunk == 1:
                # chunked runs draw through the tracker's per-frame commit hook
                render_overlay(i, tracker.knots)

        viz_timer = StageTimer()
        viz_uncovered = [0]

        def render_overlay(i, knots):
            """Keypoints and their blur-kernel polylines over frame i's input
            image. Frames whose exposure the knot window does not cover
            (bootstrap, re-anchoring) and rejected frames (knots None) get none;
            ranks other than 0 draw none."""
            if not writer or not tracker.keyframe_levels or knots is None:
                return
            cap, exp_i = frame_meta(i)
            t0 = float(knots.t0)
            t_end = t0 + float(knots.dt) * (knots.num_knots - 1)
            # float32 knots round t0 by ~1e-7 of the time scale: the tolerance
            # stays well above that
            tol = 1e-4 * max(1.0, abs(t_end), float(knots.dt))
            if not (t0 - tol <= cap - 0.5 * exp_i and cap + 0.5 * exp_i <= t_end + tol):
                viz_uncovered[0] += 1
                return
            with viz_timer.stage("overlay"):
                os.makedirs(args.viz_dir, exist_ok=True)
                kf0 = tracker.keyframe_levels[0]
                m = kf0["kp_mask"].cpu().numpy() > 0
                segs = viz.blur_kernel_segments(
                    knots, kf0["kp_xy"].cpu().numpy()[m], kf0["kp_z"].cpu().numpy()[m], K,
                    cap, exp_i, cfg.spline_degree)
                img = viz.to_rgb(ds.load_gray_image(image_paths[i]))
                img = viz.draw_segments(img, segs, color=(64, 220, 64))
                if segs:
                    img = viz.draw_points(img, np.stack([s[len(s) // 2] for s in segs]),
                                          color=(255, 64, 64))
                viz.save_png(os.path.join(args.viz_dir, f"frame_{i:05d}.png"), img)

        def checkpoint(next_frame):
            # the deferred keyframe decision is not part of the state
            tracker.flush()
            if not writer:
                return
            os.makedirs(args.checkpoint_dir, exist_ok=True)
            save_tracker_state(tracker, os.path.join(args.checkpoint_dir, "state"))
            with open(meta_path, "w") as f:
                json.dump({"next_frame": next_frame}, f)

        chunk = max(1, args.chunk)
        if args.joint_window and chunk <= 1:
            print("warning: --joint-window needs --chunk > 1; falling back to "
                  "per-frame tracking")
        viz_base = [start_idx]
        if args.viz_dir and chunk > 1:
            # the tracker calls this at each frame's commit, with that frame's own
            # knot window (None for a rejected frame)
            tracker.frame_callback = lambda r, knots: render_overlay(viz_base[0] + r, knots)
        i = start_idx
        n = len(image_paths)
        since_ckpt = 0
        while i < n:
            if chunk == 1 or tracker.is_first_frame:
                c = 1
                cap, exp = frame_meta(i)
                img = load_image(i)
                n_fail = len(tracker.failure_log)
                pose = tracker.track_frame(load_sharp(i, img), img, cap, exp, load_depth(i))
                if len(tracker.failure_log) > n_fail and out_t:
                    # the deferred health check just rejected the previous frame:
                    # hold the last good pose, as the chunked path does
                    good = -2 if len(out_t) >= 2 else None
                    out_t[-1] = (out_t[good].copy() if good
                                 else tracker.T_keyframe.t.double().cpu().numpy())
                    out_q[-1] = (out_q[good].copy() if good
                                 else tracker.T_keyframe.q.double().cpu().numpy())
                record(i, cap, pose)
                i += 1
            else:
                # many chunks a call keeps the speculation pipeline full; the
                # checkpoint cadence caps the batch
                c = n - i
                if args.checkpoint_every:
                    c = min(c, max(args.checkpoint_every - since_ckpt, chunk))
                c = min(c, chunk * 8)
                idx = list(range(i, i + c))
                metas = [frame_meta(j) for j in idx]
                imgs = [load_image(j) for j in idx]
                depths = [load_depth(j) for j in idx]
                sharps = [load_sharp(j, imgs[r]) for r, j in enumerate(idx)]
                viz_base[0] = i
                track = tracker.track_frames_joint if args.joint_window else tracker.track_frames
                poses = track(imgs, [m[0] for m in metas], [m[1] for m in metas],
                              sharp_imgs=sharps, depth_maps=depths, chunk=chunk,
                              inflight=max(1, args.inflight))
                stats = tracker.last_track_stats
                for r, pose in enumerate(poses):
                    kern = float(stats[r, 1]) if stats is not None else None
                    record(idx[r], metas[r][0], pose, kernel=kern)
                i += c
            since_ckpt += c
            if args.checkpoint_every and since_ckpt >= args.checkpoint_every:
                checkpoint(i)
                since_ckpt = 0

        # the final frame's deferred decision
        n_fail = len(tracker.failure_log)
        tracker.flush()
        if len(tracker.failure_log) > n_fail and len(out_t) >= 2:
            out_t[-1] = out_t[-2].copy()
            out_q[-1] = out_q[-2].copy()

        if not writer:
            return 0
        ds.save_tum_trajectory(args.output, np.asarray(out_times), np.asarray(out_t),
                               np.asarray(out_q))
        print(f"wrote {len(out_times)} poses to {args.output}")
        if args.viz_dir:
            n_viz = viz_timer.counts["overlay"]
            print(f"wrote {n_viz} overlays to {args.viz_dir} "
                  f"({viz_timer.mean_ms('overlay'):.2f} ms each; {viz_uncovered[0]} frames "
                  "outside their knot window)")
        if backend is not None and args.backend_stats:
            with open(args.backend_stats, "w") as f:
                json.dump(backend.stats, f)
        return 0
    finally:
        reader.close()
        if distributed and owned:
            torch.distributed.destroy_process_group()


def _loop_knots(num_frames: int, depth: float):
    """(t [K,3], q [K,4]) of the closed loop: a lateral circle and a yaw
    wiggle, one revolution over the sequence, returning to the start."""
    import torch

    from .core import lie

    R = 0.12 * depth
    kt, kq = [], []
    for k in range(num_frames + 4):
        th = 2.0 * np.pi * k / max(num_frames, 1)
        kt.append(np.array([R * np.sin(th), R * (1 - np.cos(th)),
                            0.02 * depth * np.sin(2 * th)]))
        yaw = 0.06 * np.sin(th)
        pitch = 0.04 * np.sin(2 * th)
        q = lie.quat_exp(torch.tensor([pitch, yaw, 0.0], dtype=torch.float64)).numpy()
        kq.append(q / np.linalg.norm(q))
    return np.array(kt), np.array(kq)


def _random_knots(rng, num_frames: int, frame_dt: float):
    import torch

    from .core import lie

    f64 = dict(dtype=torch.float64)
    vel_t = rng.uniform(-0.08, 0.08, 3)
    vel_w = rng.uniform(-0.08, 0.08, 3)
    kt, kq = [np.zeros(3)], [np.array([0.0, 0.0, 0.0, 1.0])]
    q = kq[0]
    for _ in range(1, num_frames + 4):
        kt.append(kt[-1] + vel_t * frame_dt + rng.normal(0, 1e-3, 3))
        q = lie.quat_multiply(
            torch.tensor(q, **f64),
            lie.quat_exp(torch.tensor(vel_w * frame_dt + rng.normal(0, 1e-3, 3), **f64)),
        ).numpy()
        q = q / np.linalg.norm(q)
        kq.append(q)
    return np.array(kt), np.array(kq)


def cmd_synth(args) -> int:
    import torch

    from .core.lie import quat_rotate
    from .core.spline import make_knots, spline_pose_at
    from .data import datasets as ds
    from .data.png import write_png
    from .data.synthetic import (
        _box_filter_1d, smooth_shapes_image, synthesize_blurred_image, warp_image,
    )

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("synth --device cuda but no CUDA device is visible; "
                           "pass --device cpu to run on the CPU")
    os.makedirs(args.output, exist_ok=True)
    H, W = args.height, args.width
    fx = 0.75 * W
    K = np.array([fx, fx, (W - 1) / 2, (H - 1) / 2])
    f32 = dict(dtype=torch.float32, device=device)

    if args.texture == "random":
        # smoothed random albedo: locally distinctive everywhere, so
        # descriptors do not alias the way the shapes scene's corners do
        timg = np.random.default_rng(args.seed + 1).uniform(0, 255, (H, W))
        for _ in range(2):
            timg = _box_filter_1d(timg, 2, 0)
            timg = _box_filter_1d(timg, 2, 1)
        img0 = torch.tensor(timg, **f32)
    else:
        img0 = torch.tensor(smooth_shapes_image(H, W), **f32)
    rng = np.random.default_rng(args.seed)
    if args.trajectory == "loop":
        kt, kq = _loop_knots(args.num_frames, args.depth)
    else:
        kt, kq = _random_knots(rng, args.num_frames, args.frame_dt)
    traj = make_knots(torch.tensor(kt, **f32), torch.tensor(kq, **f32), 0.0, args.frame_dt)
    Kt = torch.tensor(K, **f32)

    def pose_at(cap):
        return spline_pose_at(traj, torch.tensor(cap, **f32), 2)

    if args.scene == "3d":
        # a slanted textured plane and a field of spheres, ray cast: the
        # sharp view and the true z-depth map come from one render
        from .data import scene3d

        scene = scene3d.default_scene(img0.cpu().numpy(), depth=args.depth, seed=args.seed,
                                      device=device)

        def view_at(cap):
            p = pose_at(cap)
            im, z = scene3d.render_scene(scene, p.t, p.q, Kt, H, W)
            return (np.clip(im.cpu().numpy(), 0, 255).astype(np.uint8),
                    z.cpu().numpy().astype(np.float32))

        def blurred_at(cap):
            return scene3d.synthesize_blurred_image_scene(
                scene, traj, 2, torch.tensor(cap, **f32), args.exposure, args.num_samples,
                Kt, H, W)

        frame0, depth0 = view_at(0.0)
    else:
        # exact z-depth of the world plane z = depth from pose (t, R): with
        # d_cam = (x', y', 1) the camera z-depth of the ray's hit is
        # (depth - t_z) / (R d_cam)_z
        ys_g, xs_g = np.mgrid[0:H, 0:W]
        dcam = torch.tensor(np.stack([(xs_g - K[2]) / K[0], (ys_g - K[3]) / K[1],
                                      np.ones((H, W))], axis=-1), **f32)

        def view_at(cap):
            p = pose_at(cap)
            R_d = quat_rotate(p.q[None, None, :], dcam).cpu().numpy()
            z = (args.depth - float(p.t[2])) / R_d[..., 2]
            im = warp_image(img0, p.t, p.q, args.depth, Kt)
            return (np.clip(im.cpu().numpy(), 0, 255).astype(np.uint8),
                    z.astype(np.float32))

        def blurred_at(cap):
            return synthesize_blurred_image(
                img0, traj, 2, torch.tensor(cap, **f32), args.exposure, args.num_samples,
                args.depth, Kt)

        frame0, depth0 = img0.cpu().numpy().astype(np.uint8), view_at(0.0)[1]

    img_dir = os.path.join(args.output, "images")
    depth_dir = os.path.join(args.output, "depths")
    sharp_dir = os.path.join(args.output, "sharp")
    for d in (img_dir, depth_dir, sharp_dir):
        os.makedirs(d, exist_ok=True)

    write_png(os.path.join(img_dir, "frame_0000.png"), frame0)
    write_png(os.path.join(sharp_dir, "frame_0000.png"), frame0)
    np.save(os.path.join(depth_dir, "frame_0000.npy"), depth0)

    gt_times, gt_t, gt_q = [0.0], [np.zeros(3)], [np.array([0, 0, 0, 1.0])]
    lines = [f"frame_0000.png 0.0 {args.exposure}"]
    for i in range(1, args.num_frames + 1):
        cap = i * args.frame_dt
        blurred = blurred_at(cap).cpu().numpy()
        if args.noise > 0:
            blurred = blurred + rng.normal(0, args.noise, blurred.shape)
        write_png(os.path.join(img_dir, f"frame_{i:04d}.png"),
                  np.clip(blurred, 0, 255).astype(np.uint8))
        sharp, depth = view_at(cap)
        np.save(os.path.join(depth_dir, f"frame_{i:04d}.npy"), depth)
        write_png(os.path.join(sharp_dir, f"frame_{i:04d}.png"), sharp)
        p = pose_at(cap)
        gt_times.append(cap)
        gt_t.append(p.t.cpu().numpy())
        gt_q.append(p.q.cpu().numpy())
        lines.append(f"frame_{i:04d}.png {cap} {args.exposure}")

    with open(os.path.join(args.output, "times.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    ds.save_tum_trajectory(os.path.join(args.output, "groundtruth.txt"),
                           np.asarray(gt_times), np.asarray(gt_t), np.asarray(gt_q))
    with open(os.path.join(args.output, "intrinsics.txt"), "w") as f:
        f.write(",".join(str(v) for v in K) + "\n")
    print(f"wrote {args.num_frames + 1} frames to {args.output}")
    return 0


def cmd_eval(args) -> int:
    from .data import datasets as ds
    from .utils.metrics import ate_rmse, rpe_rmse

    _t_est, est_t, _ = ds.load_tum_trajectory(args.est)
    _t_ref, ref_t, _ = ds.load_tum_trajectory(args.ref)
    n = min(len(est_t), len(ref_t))
    ate = ate_rmse(est_t[:n], ref_t[:n], with_scale=args.with_scale)
    rpe = rpe_rmse(est_t[:n], ref_t[:n])
    print(json.dumps({"ate_rmse": ate, "rpe_rmse": rpe, "num_poses": n}))
    return 0


def main(argv=None) -> int:
    args = _build_arg_parser().parse_args(argv)
    if args.command == "track":
        return cmd_track(args)
    if args.command == "synth":
        return cmd_synth(args)
    if args.command == "eval":
        return cmd_eval(args)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
