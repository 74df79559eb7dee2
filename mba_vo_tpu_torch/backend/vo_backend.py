"""Sliding-window VO backend: the glue between the blur-aware tracker and
the BA / pose-graph optimisers.

Counterpart of ``mba_vo_tpu/backend/vo_backend.py``. On every new keyframe
(the tracker calls :meth:`VOBackend.on_keyframe`):

  1. detect sparse corners and oriented-BRIEF descriptors on the sharp
     keyframe image (in float32, as the reference does) and read each
     feature's depth from the keyframe depth map;
  2. match them to the previous keyframe's features, gated by the
     predicted position: each previous feature's 3D estimate (its
     landmark, else its depth-lifted point) projects into the new keyframe
     through the odometry pose and the match must land within
     ``max_match_radius`` px of it (features with no 3D estimate use a
     raw-pixel radius);
  3. matched features extend existing landmarks or create new ones, lifted
     through the keyframe depth map or two-view DLT-triangulated; window
     landmarks the match chain missed are re-associated through a k-d tree
     over the new keyframe's corners (``runtime/bindings.py``'s KDTree2D);
  4. the last ``window_size`` keyframes and their landmarks become a dense
     ``BAProblem`` with relative-pose odometry priors, and one Schur
     bundle adjustment refines the window poses and landmarks;
  5. loop closure: the new keyframe is matched against older,
     out-of-window keyframes (all candidates in one batched match); enough
     re-observed landmarks give a PnP edge measured in the old keyframe's
     local frame (all candidates' PnP problems solved as one batch); with at least one loop edge, a pose graph over the chain
     and the loop edges relaxes the keyframes, landmarks re-anchor to
     their moved host keyframes, and the corrected newest pose goes back
     to the tracker.

Host bookkeeping (landmark table, window ids, keyframe poses) is numpy in
float64, as in the reference. Detection, matching, triangulation, BA, PnP
and the pose graph run on ``device`` ("cuda" by default; a CUDA device
without a visible GPU raises), the solvers in ``dtype``. With
``profile=True`` every stage ends with a device synchronisation and its
wall time, BA/PG iterations and host reads are kept per keyframe in
``stats``.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.transform import Pose
from ..tracker.detector import DetectorOptions
from ..tracker.sparse_features import SparseFeatures, detect_sparse, match_descriptors
from .ba import BAOptions, BAProblem, OdomPrior, run_bundle_adjustment
from .geometry import pnp_rounds_row, projection_matrix, triangulate_points
from .map import SlidingWindowMap
from .pose_graph import PoseGraphEdge, PoseGraphOptions, optimize_pose_graph_counted

# the native runtime (k-d tree) lives outside the package, beside it
_RUNTIME_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "runtime",
)

STAGES = ("detect", "associate", "ba", "loop", "pose_graph")


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Static backend configuration (the reference's fields and defaults).

    window_size: keyframes in the BA window.
    max_landmarks: landmark slots of the dense BA problem.
    min_observations: window observations a landmark needs to enter BA.
    max_match_radius: gate in px around the predicted feature position;
        raw_match_radius gates features with no 3D estimate (<= 0 disables).
    odom_weight: information of the consecutive-keyframe priors in BA.
    run_pose_graph: relax the keyframe chain when loop edges exist.
    loop_*: loop-closure detection knobs.
    reassoc_radius: k-d tree radius of the map-to-frame re-association
        (<= 0 disables).
    max_chain: pose-graph node budget (the most recent keyframes).
    shard_devices: > 1 runs the window BA landmark-sharded over the first
        n ranks of the default process group (parallel.sharded_ba).
    """

    window_size: int = 7
    max_landmarks: int = 512
    min_observations: int = 2
    max_hamming: float = 96.0
    match_ratio: float = 0.85
    max_match_radius: float = 20.0
    raw_match_radius: float = 60.0
    min_depth: float = 1e-2
    max_depth: float = 1e3
    odom_weight: float = 1e6
    run_pose_graph: bool = True
    loop_min_matches: int = 20
    loop_inlier_px: float = 4.0
    loop_max_pnp_cost: float = 4.0
    loop_edge_weight: float = 5.0
    loop_skip_recent: int = 2      # candidates older than window end - this
    reassoc_radius: float = 2.0
    max_chain: int = 64
    ba: BAOptions = BAOptions()
    pose_graph: PoseGraphOptions = PoseGraphOptions()
    detector: DetectorOptions = DetectorOptions(
        score_threshold=1.0, cell_h=16, cell_w=16, max_keypoints=384
    )
    shard_devices: int = 0


# ------------------------------------------------------ host quaternion math


def _qconj(q: np.ndarray) -> np.ndarray:
    return q * np.array([-1.0, -1.0, -1.0, 1.0])


def _cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return np.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], axis=-1)


def _qmul(q: np.ndarray, p: np.ndarray) -> np.ndarray:
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return np.stack([
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py + qy * pw + qz * px - qx * pz,
        qw * pz + qz * pw + qx * py - qy * px,
        qw * pw - qx * px - qy * py - qz * pz,
    ], axis=-1)


def _qrot(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    xyz = q[..., :3]
    w = q[..., 3:4]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def _as_pose64(pose) -> Pose:
    """A Pose of float64 numpy arrays from tensors (any device) or arrays."""
    def arr(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        return np.asarray(x, np.float64)
    return Pose(t=arr(pose.t), q=arr(pose.q))


class _Keyframe:
    """Host-side record of one keyframe in the chain."""

    __slots__ = ("pose", "odom_rel_prev", "features", "cap_time",
                 "feat_landmark", "kp_np", "feat_z", "desc_np", "mask_np")

    def __init__(self, pose: Pose, features: SparseFeatures, cap_time: float,
                 odom_rel_prev: Optional[np.ndarray] = None,
                 feat_z: Optional[np.ndarray] = None,
                 host: Optional[np.ndarray] = None):
        self.pose = pose                      # camera -> world, float64 arrays
        # [7] (t, q) relative pose from the previous keyframe, measured by
        # the tracker's odometry at insertion (re-measured after a loop
        # closure); the BA priors and the pose-graph backbone read it
        self.odom_rel_prev = odom_rel_prev
        self.features = features              # tensors on the backend's device
        self.cap_time = cap_time
        if host is None:
            host = _features_to_host(features)
        n = host.shape[0]
        self.kp_np = host[:, :2]
        self.mask_np = host[:, 2]
        self.desc_np = host[:, 3:]
        self.feat_landmark = np.full((n,), -1, np.int64)   # landmark id per slot
        self.feat_z = (feat_z if feat_z is not None
                       else np.full((n,), np.nan, np.float64))


def _features_to_host(f: SparseFeatures) -> np.ndarray:
    """[N, 2 + 1 + 256] (kp_xy, mask, descriptors) in one device->host copy."""
    return torch.cat([f.kp_xy, f.mask[:, None], f.descriptors], dim=1).cpu().numpy()


class _Landmark:
    """Host-side landmark: a world position plus (keyframe, pixel)
    observations, its first-observing keyframe and the descriptor of its
    most recent observation."""

    __slots__ = ("position", "obs", "anchor", "desc")

    def __init__(self, position: np.ndarray, anchor: int,
                 desc: Optional[np.ndarray] = None):
        self.position = position              # [3] world
        self.obs: Dict[int, np.ndarray] = {}  # kf index -> [2] pixel
        self.anchor = anchor
        self.desc = desc


def _unproject(xy: np.ndarray, z: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Pinhole back-projection to camera-frame points [N, 3]."""
    return np.stack([z * (xy[:, 0] - K[2]) / K[0], z * (xy[:, 1] - K[3]) / K[1], z],
                    axis=-1)


def _transform_points(pose: Pose, pts_cam: np.ndarray) -> np.ndarray:
    """Camera-frame -> world."""
    return _qrot(pose.q[None], pts_cam) + pose.t[None]


def _world_to_cam_points(pose: Pose, pts_w: np.ndarray) -> np.ndarray:
    """World -> camera-frame points [N, 3]."""
    return _qrot(_qconj(pose.q)[None], pts_w - pose.t[None])


def _project(pts_cam: np.ndarray, K: np.ndarray) -> np.ndarray:
    z = np.maximum(pts_cam[:, 2], 1e-6)
    return np.stack([pts_cam[:, 0] / z * K[0] + K[2], pts_cam[:, 1] / z * K[1] + K[3]],
                    axis=-1)


def _world_to_cam(pose: Pose):
    """(R_w2c [3,3], t_w2c [3]) of a camera-to-world pose."""
    q_inv = _qconj(pose.q)
    R = np.stack([_qrot(q_inv, e) for e in np.eye(3)], axis=1)
    return R, -_qrot(q_inv, pose.t)


def _rel_pose(a: Pose, b: Pose) -> np.ndarray:
    """[7] (t, q) of T_a^-1 * T_b."""
    qa_inv = _qconj(a.q)
    return np.concatenate([_qrot(qa_inv, b.t - a.t), _qmul(qa_inv, b.q)])


def _kdtree_class():
    """runtime/bindings.py's KDTree2D (native when the runtime library
    builds, a numpy radius query otherwise)."""
    if _RUNTIME_DIR not in sys.path:
        sys.path.insert(0, _RUNTIME_DIR)
    from bindings import KDTree2D

    return KDTree2D


class VOBackend:
    """Sliding-window landmark map + BA (+ loop-closing pose graph) behind
    the tracker."""

    def __init__(self, config: BackendConfig, K: np.ndarray, device="cuda",
                 dtype=torch.float64, profile: bool = False):
        # landmark-sharded BA (BackendConfig.shard_devices): every rank of
        # the mesh runs the backend and holds its landmark slice in BA
        self.mesh = None
        if config.shard_devices and config.shard_devices > 1:
            from ..parallel.sharded_ba import make_ba_mesh

            n = int(config.shard_devices)
            if config.max_landmarks % n:
                raise ValueError(
                    f"max_landmarks ({config.max_landmarks}) must be a "
                    f"multiple of shard_devices ({n})")
            self.mesh = make_ba_mesh(n)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "VOBackend(device='cuda') but no CUDA device is visible; "
                    "pass device='cpu' to run on the CPU")
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        if isinstance(dtype, str):
            dtype = {"float32": torch.float32, "float64": torch.float64}[dtype]
        self.dtype = dtype
        self.cfg = config
        self.K = np.asarray(K, np.float64)
        self.keyframes: List[_Keyframe] = []
        self.landmarks: Dict[int, _Landmark] = {}
        self._next_lm = 0
        self.last_summary = None
        self.last_num_loop_edges = 0
        self.last_pg_iterations = 0
        # landmarks dropped by the max_landmarks budget in the last BA window
        self.last_landmarks_dropped = 0
        self.profile = profile
        # per keyframe: ms of each stage (with profile=True), BA and PG
        # iterations, loop edges, device->host reads, landmarks after it
        self.stats: List[dict] = []
        self._cur: dict = {}

    # ------------------------------------------------------------ helpers

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype, device=self.device)

    def _host(self, x: torch.Tensor) -> np.ndarray:
        """One device->host read, counted."""
        self._cur["syncs"] = self._cur.get("syncs", 0) + 1
        return x.detach().cpu().numpy()

    @contextmanager
    def _stage(self, name: str):
        if not self.profile:
            yield
            return
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            sync()
            ms = self._cur.setdefault("ms", {})
            ms[name] = ms.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)

    # ------------------------------------------------------------- keyframe

    def on_keyframe(
        self,
        sharp_img: np.ndarray,
        depth_map: Optional[np.ndarray],
        pose: Pose,
        cap_time: float,
    ) -> Optional[Pose]:
        """Ingest a new keyframe; returns the refined pose of this keyframe
        as float64 numpy arrays (None when nothing refined it)."""
        cfg = self.cfg
        self._cur = {"syncs": 0, "ba_iterations": 0, "pg_iterations": 0,
                     "loop_edges": 0}
        pose = _as_pose64(pose)
        with self._stage("detect"):
            img = torch.as_tensor(sharp_img if isinstance(sharp_img, torch.Tensor)
                                  else np.asarray(sharp_img), dtype=torch.float32,
                                  device=self.device)
            feats = detect_sparse(img, cfg.detector)
            self._cur["syncs"] += 1
            host = _features_to_host(feats)
            kp_np = host[:, :2]
            feat_z = None
            if depth_map is not None:
                depth_map = (depth_map.cpu().numpy() if isinstance(depth_map, torch.Tensor)
                             else np.asarray(depth_map))
                xi = np.clip(np.round(kp_np[:, 0]).astype(int), 0, depth_map.shape[1] - 1)
                yi = np.clip(np.round(kp_np[:, 1]).astype(int), 0, depth_map.shape[0] - 1)
                feat_z = depth_map[yi, xi].astype(np.float64)
                feat_z[(feat_z <= cfg.min_depth) | (feat_z >= cfg.max_depth)] = np.nan

        prev = self.keyframes[-1] if self.keyframes else None
        odom_rel = _rel_pose(prev.pose, pose) if prev is not None else None
        kf = _Keyframe(pose, feats, cap_time, odom_rel_prev=odom_rel,
                       feat_z=feat_z, host=host)
        self.keyframes.append(kf)
        idx = len(self.keyframes) - 1

        with self._stage("associate"):
            if prev is not None:
                self._associate(prev, idx - 1, kf, idx)
                if cfg.reassoc_radius > 0:
                    self._reassociate_map(kf, idx)
            self._prune_window()

        refined_any = False
        if len(self._window_ids()) >= 2:
            with self._stage("ba"):
                if self._run_window_ba() is not None:
                    refined_any = True

        if cfg.run_pose_graph and idx >= cfg.window_size:
            with self._stage("loop"):
                loop_edges = self._detect_loop_closures(idx)
            self.last_num_loop_edges = len(loop_edges)
            self._cur["loop_edges"] = len(loop_edges)
            if loop_edges:
                print(f"[vo_backend] keyframe {idx}: "
                      f"{len(loop_edges)} loop-closure edge(s) -> "
                      f"{sorted(set(int(e[0]) for e in loop_edges))}")
                with self._stage("pose_graph"):
                    self._run_pose_graph(loop_edges)
                refined_any = True

        self._cur["landmarks"] = len(self.landmarks)
        self.stats.append(self._cur)
        return self.keyframes[-1].pose if refined_any else None

    # ---------------------------------------------------------- association

    def _feature_points_world(self, kf: _Keyframe) -> np.ndarray:
        """[N, 3] best 3D estimate per feature in world coordinates (NaN
        where none exists): the landmark position, else the depth-lifted
        keyframe point."""
        n = kf.kp_np.shape[0]
        pts = np.full((n, 3), np.nan)
        has_z = np.isfinite(kf.feat_z)
        if has_z.any():
            pts[has_z] = _transform_points(
                kf.pose, _unproject(kf.kp_np[has_z], kf.feat_z[has_z], self.K))
        for a in range(n):
            lid = kf.feat_landmark[a]
            lm = self.landmarks.get(lid) if lid >= 0 else None
            if lm is not None:   # the landmark may have been pruned since
                pts[a] = lm.position
        return pts

    def _associate(self, prev: _Keyframe, prev_idx: int, cur: _Keyframe, cur_idx: int):
        """Match prev->cur features; extend or create landmarks."""
        cfg = self.cfg
        match_idx, _dist = match_descriptors(
            prev.features, cur.features,
            max_hamming=cfg.max_hamming, ratio=cfg.match_ratio)
        match_idx = self._host(match_idx).astype(np.int64)

        # gate on the predicted position (see the module docstring)
        pts_w = self._feature_points_world(prev)
        has_3d = np.isfinite(pts_w[:, 0])
        pred = np.full_like(prev.kp_np, np.nan)
        if has_3d.any():
            pred[has_3d] = _project(_world_to_cam_points(cur.pose, pts_w[has_3d]), self.K)
        matched = match_idx >= 0
        tgt = cur.kp_np[np.clip(match_idx, 0, None)]
        d_pred = np.linalg.norm(tgt - pred, axis=-1)
        d_raw = np.linalg.norm(tgt - prev.kp_np, axis=-1)
        ok = np.where(
            has_3d,
            (d_pred <= cfg.max_match_radius) | (cfg.max_match_radius <= 0),
            (d_raw <= cfg.raw_match_radius) | (cfg.raw_match_radius <= 0),
        )
        match_idx[~(matched & ok)] = -1

        new_a, new_b = [], []
        for a, b in enumerate(match_idx):
            if b < 0:
                continue
            lm_id = prev.feat_landmark[a]
            lm = self.landmarks.get(lm_id) if lm_id >= 0 else None
            if lm is not None:
                lm.obs[cur_idx] = cur.kp_np[b]
                lm.desc = cur.desc_np[b]
                cur.feat_landmark[b] = lm_id
            else:
                new_a.append(a)
                new_b.append(int(b))

        if not new_a:
            return
        a_idx = np.asarray(new_a)
        b_idx = np.asarray(new_b)
        xy_prev = prev.kp_np[a_idx]
        xy_cur = cur.kp_np[b_idx]

        z_cur = cur.feat_z[b_idx]
        direct = np.isfinite(z_cur)
        pts_w = np.zeros((len(a_idx), 3))
        ok = np.zeros((len(a_idx),), bool)
        if direct.any():
            # lift through the current keyframe's depth map (z-depth)
            pts_w[direct] = _transform_points(
                cur.pose, _unproject(xy_cur[direct], z_cur[direct], self.K))
            ok[direct] = True
        need_tri = ~direct
        if need_tri.any():
            # two-view DLT triangulation from the pose estimates
            Kt = self._t(self.K)
            P1 = projection_matrix(Kt, *(self._t(x) for x in _world_to_cam(prev.pose)))
            P2 = projection_matrix(Kt, *(self._t(x) for x in _world_to_cam(cur.pose)))
            tri = self._host(triangulate_points(
                P1, P2, self._t(xy_prev[need_tri]), self._t(xy_cur[need_tri])))
            tri = tri.astype(np.float64)
            pts_w[need_tri] = tri
            # cheirality and depth sanity in the current view
            z = _world_to_cam_points(cur.pose, tri)[:, 2]
            ok[need_tri] = (z > cfg.min_depth) & (z < cfg.max_depth)

        for k in range(len(a_idx)):
            if not ok[k]:
                continue
            lm = _Landmark(pts_w[k], anchor=prev_idx, desc=cur.desc_np[b_idx[k]])
            lm.obs[prev_idx] = xy_prev[k]
            lm.obs[cur_idx] = xy_cur[k]
            lm_id = self._next_lm
            self._next_lm += 1
            self.landmarks[lm_id] = lm
            prev.feat_landmark[a_idx[k]] = lm_id
            cur.feat_landmark[b_idx[k]] = lm_id

    def _reassociate_map(self, cur: _Keyframe, cur_idx: int):
        """Map-to-frame re-association: window landmarks the prev->cur chain
        missed are projected into the new keyframe; a k-d tree over the
        keyframe's corners finds unassigned corners near each projection,
        and the best descriptor agreement (within max_hamming) claims one."""
        cfg = self.cfg
        win = set(self._window_ids())
        cand = [
            (lid, lm) for lid, lm in self.landmarks.items()
            if cur_idx not in lm.obs and any(k in win for k in lm.obs)
        ]
        if not cand:
            return
        live = cur.mask_np > 0
        tree = _kdtree_class()(cur.kp_np)
        pts_w = np.stack([lm.position for _, lm in cand])
        proj = _project(_world_to_cam_points(cur.pose, pts_w), self.K)
        half_bits = cur.desc_np.shape[1] / 2.0
        for (lid, lm), (px, py) in zip(cand, proj):
            if lm.desc is None:
                continue
            idxs = tree.radius_query(float(px), float(py), cfg.reassoc_radius)
            best_b, best_d = -1, cfg.max_hamming
            for b in idxs:
                if not live[b] or cur.feat_landmark[b] >= 0:
                    continue
                ham = half_bits - 0.5 * float(cur.desc_np[b] @ lm.desc)
                if ham < best_d:
                    best_d, best_b = ham, int(b)
            if best_b >= 0:
                lm.obs[cur_idx] = cur.kp_np[best_b]
                lm.desc = cur.desc_np[best_b]
                cur.feat_landmark[best_b] = lid

    # -------------------------------------------------------------- window

    def _window_ids(self) -> List[int]:
        n = len(self.keyframes)
        return list(range(max(0, n - self.cfg.window_size), n))

    def _prune_window(self):
        """Drop landmarks with too few window observations that lie fully
        behind the window."""
        win = set(self._window_ids())
        dead = [
            lid for lid, lm in self.landmarks.items()
            if sum(1 for k in lm.obs if k in win) < self.cfg.min_observations
            and max(lm.obs) < min(win)
        ]
        for lid in dead:
            del self.landmarks[lid]

    def _build_problem(self):
        """Dense BAProblem over the window (padded to max_landmarks slots and
        window_size poses). Landmarks are ranked by in-window observations,
        most first, then by id, before the slot cut."""
        cfg = self.cfg
        win = self._window_ids()
        Wn = cfg.window_size
        Mn = cfg.max_landmarks
        kf_of = {k: r for r, k in enumerate(win)}

        eligible = [
            (lid, sum(1 for k in lm.obs if k in kf_of))
            for lid, lm in self.landmarks.items()
        ]
        eligible = [(lid, n_obs) for lid, n_obs in eligible
                    if n_obs >= cfg.min_observations]
        eligible.sort(key=lambda e: (-e[1], e[0]))
        lids = [lid for lid, _ in eligible[:Mn]]
        self.last_landmarks_dropped = max(0, len(eligible) - Mn)
        if self.last_landmarks_dropped:
            print(
                f"[vo_backend] landmark budget: {len(eligible)} eligible > "
                f"{Mn} slots; dropped {self.last_landmarks_dropped} "
                "lowest-observation landmarks from this BA window"
            )

        points = np.zeros((Mn, 3))
        point_mask = np.zeros((Mn,))
        obs_xy = np.zeros((Wn, Mn, 2))
        obs_mask = np.zeros((Wn, Mn))
        for m, lid in enumerate(lids):
            lm = self.landmarks[lid]
            points[m] = lm.position
            point_mask[m] = 1.0
            for k, xy in lm.obs.items():
                if k in kf_of:
                    obs_xy[kf_of[k], m] = xy
                    obs_mask[kf_of[k], m] = 1.0

        pose_t = np.zeros((Wn, 3))
        pose_q = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (Wn, 1))
        pose_mask = np.zeros((Wn,))
        for r, k in enumerate(win):
            pose_t[r] = self.keyframes[k].pose.t
            pose_q[r] = self.keyframes[k].pose.q
            pose_mask[r] = 1.0

        # consecutive odometry priors: measured at insertion, re-measured
        # along the corrected chain after a loop closure
        odom_t = np.zeros((Wn - 1, 3))
        odom_q = np.tile(np.array([0.0, 0.0, 0.0, 1.0]), (Wn - 1, 1))
        odom_w = np.zeros((Wn - 1,))
        for r in range(len(win) - 1):
            rel = self.keyframes[win[r + 1]].odom_rel_prev
            if rel is None:
                continue
            odom_t[r] = rel[:3]
            odom_q[r] = rel[3:]
            odom_w[r] = cfg.odom_weight

        t = self._t
        problem = BAProblem(
            poses=Pose(t=t(pose_t), q=t(pose_q)),
            map=SlidingWindowMap(points=t(points), point_mask=t(point_mask),
                                 obs_xy=t(obs_xy), obs_mask=t(obs_mask)),
            K=t(self.K),
            odom=OdomPrior(t=t(odom_t), q=t(odom_q), weight=t(odom_w)),
            pose_mask=t(pose_mask),
        )
        return problem, win, lids

    def _run_window_ba(self):
        problem, win, lids = self._build_problem()
        if self.mesh is not None:
            from ..parallel.sharded_ba import (
                run_bundle_adjustment_sharded,
                shard_ba_problem,
            )

            # max_landmarks is a multiple of the mesh size (checked at
            # init): the landmark padding is a no-op and ``refined`` keeps
            # the dense problem's shapes
            refined, summary = run_bundle_adjustment_sharded(
                shard_ba_problem(problem, self.mesh), self.cfg.ba, self.mesh)
        else:
            refined, summary = run_bundle_adjustment(problem, self.cfg.ba)
        self.last_summary = summary
        self._cur["ba_iterations"] = summary.num_iterations
        self._cur["syncs"] += summary.num_iterations
        # costs, poses and points in one read
        Wn = problem.poses.t.shape[0]
        pack = self._host(torch.cat([
            torch.stack([summary.initial_cost, summary.final_cost]),
            refined.poses.t.reshape(-1), refined.poses.q.reshape(-1),
            refined.map.points.reshape(-1)])).astype(np.float64)
        c0, c1 = pack[0], pack[1]
        self._cur["ba_cost"] = float(c1)
        if not np.isfinite(c1) or c1 > c0:
            return None
        new_t = pack[2:2 + 3 * Wn].reshape(Wn, 3)
        new_q = pack[2 + 3 * Wn:2 + 7 * Wn].reshape(Wn, 4)
        new_pts = pack[2 + 7 * Wn:].reshape(-1, 3)
        for r, k in enumerate(win):
            self.keyframes[k].pose = Pose(t=new_t[r].copy(), q=new_q[r].copy())
        for m, lid in enumerate(lids):
            self.landmarks[lid].position = new_pts[m].copy()
        return refined

    # --------------------------------------------------------- loop closure

    def _detect_loop_closures(self, cur_idx: int):
        """Match the newest keyframe against out-of-window older keyframes;
        enough re-observed landmarks give a PnP edge (i -> cur) measured in
        keyframe i's local frame, independent of accumulated world drift."""
        cfg = self.cfg
        cur = self.keyframes[cur_idx]
        win_start = self._window_ids()[0]
        first = max(0, cur_idx - cfg.max_chain + 1)
        candidates = list(range(first, max(first, win_start - cfg.loop_skip_recent)))
        if not candidates:
            return []
        # every candidate against the new keyframe in one batched match
        olds = [self.keyframes[i].features for i in candidates]
        stacked = SparseFeatures(*(torch.stack(f) for f in zip(*olds)))
        all_idx = self._host(match_descriptors(
            stacked, cur.features, max_hamming=cfg.max_hamming,
            ratio=cfg.match_ratio)[0])
        # each candidate with enough support becomes one PnP problem of 256
        # slots (the reference's static size); all of them solve as one batch
        n_fix = 256
        Kt = self._t(self.K)
        cand, pts, oxy, msk, init = [], [], [], [], []
        for i, match_idx in zip(candidates, all_idx):
            old = self.keyframes[i]
            # each matched feature's 3D point: its landmark, else its
            # depth-lifted point, else none (in match order)
            a = np.flatnonzero(match_idx >= 0)
            lms = [self.landmarks.get(lid) if lid >= 0 else None
                   for lid in old.feat_landmark[a]]
            has_lm = np.array([lm is not None for lm in lms], bool)
            use = has_lm | np.isfinite(old.feat_z[a])
            if use.sum() < cfg.loop_min_matches:
                continue
            X_w = np.zeros((len(a), 3))
            if has_lm.any():
                X_w[has_lm] = np.stack([lm.position for lm in lms if lm is not None])
            lift = use & ~has_lm
            if lift.any():
                X_w[lift] = _transform_points(
                    old.pose, _unproject(old.kp_np[a[lift]], old.feat_z[a[lift]], self.K))
            # in keyframe i's local frame (drift-independent)
            pts_i = _world_to_cam_points(old.pose, X_w[use])
            obs = cur.kp_np[match_idx[a[use]]]
            m = min(len(pts_i), n_fix)
            cand.append(i)
            pts.append(np.zeros((n_fix, 3)))
            oxy.append(np.zeros((n_fix, 2)))
            msk.append(np.zeros((n_fix,)))
            pts[-1][:m] = np.asarray(pts_i)[:m]
            oxy[-1][:m] = np.asarray(obs)[:m]
            msk[-1][:m] = 1.0
            # init: the current drifted estimate of T_i^-1 * T_cur
            init.append(_rel_pose(old.pose, cur.pose))
        if not cand:
            return []
        # solve, drop residuals beyond the gate, re-solve on the survivors;
        # gate on the inlier count (both rounds) and the second round's cost
        ptsj, oxyj = self._t(np.stack(pts)), self._t(np.stack(oxy))
        msk = np.stack(msk)
        solve_mask = msk.copy()
        init = np.stack(init)
        pose = Pose(t=self._t(init[:, :3]), q=self._t(init[:, 3:]))
        live = np.arange(len(cand))
        for _round in range(2):
            rows = torch.as_tensor(live, device=self.device)
            # one row a candidate, [norms (n_fix) | cost | t | q]: one read a round
            solved = pnp_rounds_row(ptsj[rows], oxyj[rows], self._t(solve_mask[live]), Kt,
                                    pose, 2.0, 30)
            out = self._host(solved)
            inl = msk[live] * (out[:, :n_fix] < cfg.loop_inlier_px)
            keep = inl.sum(axis=1) >= cfg.loop_min_matches
            solve_mask[live] = inl
            kept = torch.as_tensor(np.flatnonzero(keep), device=self.device)
            live, out = live[keep], out[keep]
            pose = Pose(t=solved[kept, n_fix + 1:n_fix + 4], q=solved[kept, n_fix + 4:])
        edges = []
        for k, row in zip(live, out.astype(np.float64)):
            if row[n_fix] > cfg.loop_max_pnp_cost:
                continue
            edges.append((cand[k], cur_idx, row[n_fix + 1:n_fix + 4], row[n_fix + 4:],
                          cfg.loop_edge_weight))
        return edges

    # ----------------------------------------------------------- pose graph

    def _run_pose_graph(self, loop_edges):
        """Distribute loop-closure corrections through the keyframe chain:
        consecutive edges measured from the current chain plus the loop
        edges; landmarks re-anchor to their moved host keyframes; the
        consecutive priors are re-measured along the corrected chain."""
        n = len(self.keyframes)
        start = max(0, n - self.cfg.max_chain)
        nodes = list(range(start, n))
        node_of = {k: r for r, k in enumerate(nodes)}
        old_poses = {k: self.keyframes[k].pose for k in nodes}

        t = self._t(np.stack([self.keyframes[k].pose.t for k in nodes]))
        q = self._t(np.stack([self.keyframes[k].pose.q for k in nodes]))

        ii, jj, et, eq, w = [], [], [], [], []
        for r in range(len(nodes) - 1):
            a, b = nodes[r], nodes[r + 1]
            rel = _rel_pose(self.keyframes[a].pose, self.keyframes[b].pose)
            et.append(rel[:3])
            eq.append(rel[3:])
            ii.append(r)
            jj.append(r + 1)
            w.append(1.0)
        for (a, b, lt, lq, lw) in loop_edges:
            if a not in node_of or b not in node_of:
                continue
            ii.append(node_of[a])
            jj.append(node_of[b])
            et.append(lt)
            eq.append(lq)
            w.append(lw)

        edges = PoseGraphEdge(
            i=self._t(np.asarray(ii), torch.int64),
            j=self._t(np.asarray(jj), torch.int64),
            t_ij=self._t(np.stack(et)),
            q_ij=self._t(np.stack(eq)),
            weight=self._t(np.asarray(w)),
        )
        relaxed, _cost, iters = optimize_pose_graph_counted(
            Pose(t=t, q=q), edges, self.cfg.pose_graph)
        self.last_pg_iterations = iters
        self._cur["pg_iterations"] = iters
        self._cur["syncs"] += iters
        out = self._host(torch.cat([relaxed.t, relaxed.q], dim=1)).astype(np.float64)
        for r, k in enumerate(nodes):
            self.keyframes[k].pose = Pose(t=out[r, :3].copy(), q=out[r, 3:].copy())

        # re-anchor landmarks with their host keyframe's correction:
        # X' = T_new * T_old^-1 * X
        for lm in self.landmarks.values():
            k = lm.anchor
            if k not in node_of:
                continue
            X_local = _world_to_cam_points(old_poses[k], lm.position[None])
            lm.position = _transform_points(self.keyframes[k].pose, X_local)[0]

        # re-measure the consecutive priors from the corrected chain, or the
        # next window BA would pull the chain back to the old odometry
        for r in range(1, len(nodes)):
            a, b = nodes[r - 1], nodes[r]
            self.keyframes[b].odom_rel_prev = _rel_pose(
                self.keyframes[a].pose, self.keyframes[b].pose)
        # the chain's first node moved but its predecessor did not
        if start > 0:
            self.keyframes[start].odom_rel_prev = _rel_pose(
                self.keyframes[start - 1].pose, self.keyframes[start].pose)
