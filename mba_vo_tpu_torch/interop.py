"""Tracker and backend state, and model parameters, carried in from numpy
arrays.

The system has no weights: its state is the knot window, the poses, each
keyframe level's (img, grad, kp_xy, kp_z, kp_mask, wincache) and, with a
backend, the keyframe chain and the landmark table; its models are
parameter tuples (cameras, scenes, dynamic points, navigation states, IMU
parameters). These helpers build the port's tensors from plain numpy arrays
or from any object with the same field names (for example the JAX
package's named tuples, read through ``np.asarray``), so both packages can
run from identical state and parameters. Nothing here imports ``jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from .backend.ba import BAOptions, BAProblem, OdomPrior
from .backend.map import SlidingWindowMap
from .backend.pose_graph import PoseGraphEdge, PoseGraphOptions
from .backend.vo_backend import BackendConfig, VOBackend, _Keyframe, _Landmark
from .backend.dynamic_points import DynamicPoints
from .core.navstate import NavState
from .core.spline import SplineKnots
from .core.transform import Pose
from .data.scene3d import Scene3D
from .models.camera import PinholeCamera, RadTanDistortion, UnifiedCamera
from .models.trajectory import ImuParams
from .tracker.blur_tracker import BlurAwareTracker, TrackerConfig
from .tracker.detector import DetectorOptions
from .tracker.sparse_features import SparseFeatures


def _tensor(x, dtype, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def knots_from_arrays(t, q, t0, dt, dtype=torch.float64, device="cpu") -> SplineKnots:
    """SplineKnots from [K,3] translations, [K,4] xyzw quaternions and the
    scalar start time and knot interval."""
    return SplineKnots(*(_tensor(x, dtype, device) for x in (t, q, t0, dt)))


def pose_from_arrays(t, q, dtype=torch.float64, device="cpu") -> Pose:
    return Pose(t=_tensor(t, dtype, device), q=_tensor(q, dtype, device))


def keyframe_levels_from_arrays(levels: Sequence[Mapping], dtype=torch.float64,
                                device="cpu") -> list:
    """Per-level keyframe dicts from mappings with keys img, grad, kp_xy,
    kp_z, kp_mask and wincache = (windows [N,3,wh,ww], starts [N,2] ints)."""
    out = []
    for lv in levels:
        windows, starts = lv["wincache"]
        out.append(dict(
            img=_tensor(lv["img"], dtype, device),
            grad=_tensor(lv["grad"], dtype, device),
            kp_xy=_tensor(lv["kp_xy"], dtype, device),
            kp_z=_tensor(lv["kp_z"], dtype, device),
            kp_mask=_tensor(lv["kp_mask"], dtype, device),
            wincache=(_tensor(windows, dtype, device),
                      _tensor(starts, torch.int64, device)),
        ))
    return out


def install_tracker_state(tracker: BlurAwareTracker, arrays: Mapping) -> None:
    """Install tracker state from numpy arrays. Every key is optional:

    knots:           mapping with t, q, t0, dt
    T_keyframe:      mapping with t, q
    T_prev_b2w:      mapping with t, q
    neigh_velocity:  [6]
    prev_timestamp:  float
    keyframe_levels: sequence of per-level mappings (keyframe_levels_from_arrays)
    joint_knots:     mapping with t, q, t0, dt: the joint multi-frame window
    joint_dt:        float, the host-side knot interval that window was
                     created with (track_frames_joint keeps a live window
                     only when both are present)

    Installing knots or keyframe levels ends the tracker's bootstrap, so the
    next ``track_frame`` tracks against this state. Any pending keyframe
    decision is dropped.
    """
    dt, dev = tracker.dtype, tracker.device
    if "knots" in arrays:
        k = arrays["knots"]
        tracker.knots = knots_from_arrays(k["t"], k["q"], k["t0"], k["dt"], dt, dev)
        tracker.is_first_frame = False
    for name in ("T_keyframe", "T_prev_b2w"):
        if name in arrays:
            p = arrays[name]
            setattr(tracker, name, pose_from_arrays(p["t"], p["q"], dt, dev))
    if "neigh_velocity" in arrays:
        tracker.neigh_velocity = _tensor(arrays["neigh_velocity"], dt, dev)
    if "prev_timestamp" in arrays:
        tracker.prev_timestamp = float(arrays["prev_timestamp"])
    if "joint_knots" in arrays:
        k = arrays["joint_knots"]
        tracker._joint_knots = knots_from_arrays(k["t"], k["q"], k["t0"], k["dt"], dt, dev)
    if "joint_dt" in arrays:
        tracker._joint_dt = float(arrays["joint_dt"])
    if "keyframe_levels" in arrays:
        tracker.keyframe_levels = keyframe_levels_from_arrays(
            arrays["keyframe_levels"], dt, dev)
        tracker.is_first_frame = False
    tracker._pending = None


def config_from_fields(obj) -> TrackerConfig:
    """The port's TrackerConfig from any dataclass with TrackerConfig's field
    names (such as the JAX package's), read through ``dataclasses.fields``."""
    values = {f.name: getattr(obj, f.name) for f in dataclasses.fields(TrackerConfig)}
    det = values["detector"]
    values["detector"] = DetectorOptions(
        **{f.name: getattr(det, f.name) for f in dataclasses.fields(DetectorOptions)})
    values["num_virtual_poses"] = tuple(values["num_virtual_poses"])
    return TrackerConfig(**values)


def _fields_of(cls, obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}


def backend_config_from_fields(obj) -> BackendConfig:
    """The port's BackendConfig from any dataclass with its field names
    (such as the JAX package's), nested options included."""
    values = _fields_of(BackendConfig, obj)
    values["ba"] = BAOptions(**_fields_of(BAOptions, values["ba"]))
    values["pose_graph"] = PoseGraphOptions(
        **_fields_of(PoseGraphOptions, values["pose_graph"]))
    values["detector"] = DetectorOptions(**_fields_of(DetectorOptions, values["detector"]))
    return BackendConfig(**values)


def ba_problem_from_arrays(pose_t, pose_q, points, obs_xy, obs_mask, K,
                           point_mask=None, odom=None, pose_mask=None,
                           dtype=torch.float64, device="cpu") -> BAProblem:
    """BAProblem from numpy arrays; ``odom``: None or (t [W-1,3],
    q [W-1,4], weight [W-1])."""
    t = lambda x: _tensor(x, dtype, device)  # noqa: E731
    if point_mask is None:
        point_mask = np.ones(np.shape(points)[0])
    return BAProblem(
        poses=Pose(t=t(pose_t), q=t(pose_q)),
        map=SlidingWindowMap(points=t(points), point_mask=t(point_mask),
                             obs_xy=t(obs_xy), obs_mask=t(obs_mask)),
        K=t(K),
        odom=None if odom is None else OdomPrior(*(t(x) for x in odom)),
        pose_mask=None if pose_mask is None else t(pose_mask),
    )


def pose_graph_edges_from_arrays(i, j, t_ij, q_ij, weight, dtype=torch.float64,
                                 device="cpu") -> PoseGraphEdge:
    return PoseGraphEdge(
        i=_tensor(i, torch.int64, device), j=_tensor(j, torch.int64, device),
        t_ij=_tensor(t_ij, dtype, device), q_ij=_tensor(q_ij, dtype, device),
        weight=_tensor(weight, dtype, device))


def sparse_features_from_arrays(kp_xy, response, mask, orientation, descriptors,
                                dtype=torch.float32, device="cpu") -> SparseFeatures:
    return SparseFeatures(*(_tensor(x, dtype, device) for x in (
        kp_xy, response, mask, orientation, descriptors)))


def install_backend_state(backend: VOBackend, state: Mapping) -> None:
    """Replace a VOBackend's keyframe chain and landmark table with ``state``:

    keyframes:        sequence of mappings with pose_t, pose_q,
                      odom_rel_prev ([7], NaN for none), cap_time,
                      feat_landmark, feat_z, kp_xy, response, mask,
                      orientation, descriptors
    next_lm:          the next landmark id
    landmark_ids, landmark_pos, landmark_anchor, landmark_desc (NaN rows for
    none), obs_row, obs_kf, obs_xy: the landmark table, each observation a
    (landmark row, keyframe index, pixel) triplet; absent when empty.

    The layout is the one ``mba_vo_tpu/utils/checkpoint.py`` serialises a
    backend to; features go to the backend's device in float32."""
    backend.keyframes = []
    for s in state["keyframes"]:
        feats = sparse_features_from_arrays(
            s["kp_xy"], s["response"], s["mask"], s["orientation"],
            s["descriptors"], device=backend.device)
        rel = np.asarray(s["odom_rel_prev"], np.float64)
        kf = _Keyframe(
            Pose(t=np.asarray(s["pose_t"], np.float64),
                 q=np.asarray(s["pose_q"], np.float64)),
            feats, float(s["cap_time"]),
            odom_rel_prev=None if np.isnan(rel[0]) else rel,
            feat_z=np.asarray(s["feat_z"], np.float64).copy(),
            host=np.concatenate([np.asarray(s["kp_xy"], np.float32),
                                 np.asarray(s["mask"], np.float32)[:, None],
                                 np.asarray(s["descriptors"], np.float32)], axis=1),
        )
        kf.feat_landmark = np.asarray(s["feat_landmark"], np.int64).copy()
        backend.keyframes.append(kf)

    backend.landmarks = {}
    lm_ids = np.asarray(state.get("landmark_ids", np.zeros((0,), np.int64)))
    if lm_ids.size:
        pos = np.asarray(state["landmark_pos"], np.float64)
        anchor = np.asarray(state["landmark_anchor"])
        descs = state.get("landmark_desc")
        for row, lid in enumerate(lm_ids):
            desc = None
            if descs is not None and np.isfinite(descs[row][0]):
                desc = np.asarray(descs[row], np.float32)
            backend.landmarks[int(lid)] = _Landmark(pos[row].copy(), int(anchor[row]),
                                                    desc=desc)
    if state.get("obs_row") is not None:
        for r, k, xy in zip(np.asarray(state["obs_row"]), np.asarray(state["obs_kf"]),
                            np.asarray(state["obs_xy"])):
            backend.landmarks[int(lm_ids[r])].obs[int(k)] = np.asarray(xy)
    backend._next_lm = int(state["next_lm"])


def backend_state_arrays(backend: VOBackend) -> dict:
    """The inverse of :func:`install_backend_state`: a VOBackend's chain and
    landmark table as numpy arrays in the same layout."""
    kfs = []
    for kf in backend.keyframes:
        f = kf.features
        kfs.append({
            "pose_t": np.asarray(kf.pose.t), "pose_q": np.asarray(kf.pose.q),
            "odom_rel_prev": (np.asarray(kf.odom_rel_prev) if kf.odom_rel_prev is not None
                              else np.full((7,), np.nan)),
            "cap_time": np.asarray(kf.cap_time),
            "feat_landmark": kf.feat_landmark.copy(), "feat_z": kf.feat_z.copy(),
            **{name: getattr(f, name).detach().cpu().numpy() for name in f._fields},
        })
    lm_ids = sorted(backend.landmarks)
    state = {"keyframes": kfs, "next_lm": np.asarray(backend._next_lm)}
    if lm_ids:
        lms = [backend.landmarks[lid] for lid in lm_ids]
        state["landmark_ids"] = np.asarray(lm_ids, np.int64)
        state["landmark_pos"] = np.stack([lm.position for lm in lms])
        state["landmark_anchor"] = np.asarray([lm.anchor for lm in lms], np.int64)
        state["landmark_desc"] = np.stack([
            lm.desc if lm.desc is not None else np.full((256,), np.nan, np.float32)
            for lm in lms]).astype(np.float32)
        obs = [(row, k, xy) for row, lm in enumerate(lms) for k, xy in lm.obs.items()]
        if obs:
            state["obs_row"] = np.asarray([o[0] for o in obs], np.int64)
            state["obs_kf"] = np.asarray([o[1] for o in obs], np.int64)
            state["obs_xy"] = np.stack([np.asarray(o[2]) for o in obs])
    return state


# ------------------------------------------------------------------- models


def _tuple_from_fields(cls, obj, dtype, device, ints=()):
    """cls(**fields of obj), each field a tensor (int32 for ``ints``)."""
    return cls(**{f: _tensor(getattr(obj, f), torch.int32 if f in ints else dtype, device)
                  for f in cls._fields})


def camera_from_fields(cam, dtype=torch.float64, device="cpu"):
    """The port's PinholeCamera, or UnifiedCamera when ``cam`` has ``xi``,
    from any object with their field names; a ``distortion`` with k1, k2,
    p1, p2 becomes a RadTanDistortion of 0-d tensors."""
    dist = cam.distortion
    if dist is not None:
        dist = _tuple_from_fields(RadTanDistortion, dist, dtype, device)
    K = _tensor(cam.K, dtype, device)
    size = dict(height=int(cam.height), width=int(cam.width), distortion=dist)
    if hasattr(cam, "xi"):
        return UnifiedCamera(K=K, xi=_tensor(cam.xi, dtype, device), **size)
    return PinholeCamera(K=K, **size)


def scene_from_fields(scene, dtype=torch.float64, device="cpu") -> Scene3D:
    return _tuple_from_fields(Scene3D, scene, dtype, device)


def dynamic_points_from_fields(pts, dtype=torch.float64, device="cpu") -> DynamicPoints:
    return _tuple_from_fields(DynamicPoints, pts, dtype, device, ints=("status",))


def imu_params_from_fields(params, dtype=torch.float64, device="cpu") -> ImuParams:
    return _tuple_from_fields(ImuParams, params, dtype, device)


def navstate_from_fields(state, dtype=torch.float64, device="cpu") -> NavState:
    return NavState(pose=pose_from_arrays(state.pose.t, state.pose.q, dtype, device),
                    **{f: _tensor(getattr(state, f), dtype, device)
                       for f in ("velocity", "bias_acc", "bias_gyro")})
