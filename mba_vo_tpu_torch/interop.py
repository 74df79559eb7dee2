"""Tracker state carried in from numpy arrays.

The system has no weights: its state is the knot window, the poses and each
keyframe level's (img, grad, kp_xy, kp_z, kp_mask, wincache). These helpers
build the port's tensors from plain numpy arrays (for example arrays read
out of the JAX tracker), so two trackers can run from identical keyframe
state. Nothing here imports ``jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from .core.spline import SplineKnots
from .core.transform import Pose
from .tracker.blur_tracker import BlurAwareTracker, TrackerConfig
from .tracker.detector import DetectorOptions


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
