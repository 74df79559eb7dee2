"""Checkpoint and resume of the tracker's runtime state.

Counterpart of ``mba_vo_tpu/utils/checkpoint.py``, written with
``torch.save`` in place of orbax: the spline knots, the joint multi-frame
window and the host float interval it was created with, the keyframe
levels (without the window caches, which are rebuilt on load), the
scalars, the poses and velocity, and with a backend its keyframe chain,
features and landmark table. Everything is stored as plain CPU tensors in
nested dicts and lists, so a checkpoint loads with
``torch.load(weights_only=True)``; a run resumed from it goes on exactly
as the uninterrupted run.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

STATE_FILE = "state.pt"


def _cpu(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    return torch.from_numpy(np.array(x))


def _knots(k) -> Dict[str, torch.Tensor]:
    return {"t": _cpu(k.t), "q": _cpu(k.q), "t0": _cpu(k.t0), "dt": _cpu(k.dt)}


def tracker_state(tracker) -> Dict[str, Any]:
    """The tracker's resumable state as a dict of CPU tensors."""
    from ..interop import backend_state_arrays

    state = {
        "knots": _knots(tracker.knots) if tracker.knots is not None else {},
        "joint_knots": (
            dict(_knots(tracker._joint_knots),
                 host_dt=torch.tensor(tracker._joint_dt if tracker._joint_dt is not None
                                      else float("nan"), dtype=torch.float64))
            if tracker._joint_knots is not None else {}),
        "keyframe_levels": [{k: _cpu(v) for k, v in lvl.items() if k != "wincache"}
                            for lvl in tracker.keyframe_levels],
        "scalars": {
            "is_first_frame": bool(tracker.is_first_frame),
            "prev_timestamp": float(tracker.prev_timestamp),
            "avg_kernel_length": float(tracker.avg_kernel_length),
        },
        "T_prev_b2w": {"t": _cpu(tracker.T_prev_b2w.t), "q": _cpu(tracker.T_prev_b2w.q)},
        "T_keyframe": {"t": _cpu(tracker.T_keyframe.t), "q": _cpu(tracker.T_keyframe.q)},
        "neigh_velocity": _cpu(tracker.neigh_velocity),
    }
    if tracker.backend is not None:
        arrays = backend_state_arrays(tracker.backend)
        state["backend"] = {
            "keyframes": [{k: _cpu(v) for k, v in kf.items()} for kf in arrays["keyframes"]],
            **{k: _cpu(v) for k, v in arrays.items() if k != "keyframes"},
        }
    return state


def save_tracker_state(tracker, path: str) -> None:
    """Write the tracker's state (with its backend's, when one is attached)
    to ``path``/state.pt. Resolve any deferred keyframe decision first
    (``tracker.flush()``): it is not part of the state."""
    os.makedirs(path, exist_ok=True)
    torch.save(tracker_state(tracker), os.path.join(path, STATE_FILE))


def load_tracker_state(tracker, path: str) -> None:
    """Restore state saved by :func:`save_tracker_state` into an existing
    tracker with the same configuration and camera."""
    from ..core.spline import SplineKnots
    from ..core.transform import Pose
    from ..interop import install_backend_state
    from ..ops.window_sampling import extract_windows, stack_image_channels

    state = torch.load(os.path.join(path, STATE_FILE), weights_only=True)
    dev = tracker.device

    def knots(d):
        return SplineKnots(*(d[k].to(dev) for k in ("t", "q", "t0", "dt")))

    if state["knots"]:
        tracker.knots = knots(state["knots"])
    jk = state["joint_knots"]
    if jk:
        tracker._joint_knots = knots(jk)
        host_dt = float(jk["host_dt"])
        tracker._joint_dt = host_dt if np.isfinite(host_dt) else None
    levels = []
    for lvl in state["keyframe_levels"]:
        lvl = {k: v.to(dev) for k, v in lvl.items()}
        # the window caches are derived data, rebuilt as process_keyframe does
        lvl["wincache"] = extract_windows(stack_image_channels(lvl["img"], lvl["grad"]),
                                          lvl["kp_xy"], tracker.cfg.sampling_window)
        levels.append(lvl)
    tracker.keyframe_levels = levels
    sc = state["scalars"]
    tracker.is_first_frame = bool(sc["is_first_frame"])
    tracker.prev_timestamp = float(sc["prev_timestamp"])
    tracker.avg_kernel_length = float(sc["avg_kernel_length"])
    tracker.T_prev_b2w = Pose(*(state["T_prev_b2w"][k].to(dev) for k in ("t", "q")))
    tracker.T_keyframe = Pose(*(state["T_keyframe"][k].to(dev) for k in ("t", "q")))
    tracker.neigh_velocity = state["neigh_velocity"].to(dev)
    tracker._pending = None
    if "backend" in state and tracker.backend is not None:
        b = state["backend"]
        install_backend_state(tracker.backend, {
            "keyframes": [{k: v.numpy() for k, v in kf.items()} for kf in b["keyframes"]],
            **{k: v.numpy() for k, v in b.items() if k != "keyframes"},
        })
