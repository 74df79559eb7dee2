"""Typed config loading for the command line.

Counterpart of ``mba_vo_tpu/utils/config.py``: JSON files map onto the
frozen dataclass configs (``TrackerConfig``, ``BackendConfig``), nested
``detector`` / ``ba`` / ``pose_graph`` dicts included, lists become tuples, and an unknown key raises ``ValueError`` naming the valid
keys.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

from ..tracker.blur_tracker import TrackerConfig
from ..tracker.detector import DetectorOptions


def _build(cls, data: Dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys: {sorted(unknown)}; "
            f"valid keys: {sorted(fields)}"
        )
    kwargs = {}
    for k, v in data.items():
        if k == "detector" and isinstance(v, dict):
            v = _build(DetectorOptions, v)
        if isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def tracker_config_from_dict(data: Dict[str, Any]) -> TrackerConfig:
    return _build(TrackerConfig, data)


def load_tracker_config(path: str) -> TrackerConfig:
    with open(path) as f:
        return tracker_config_from_dict(json.load(f))


def backend_config_from_dict(data: Dict[str, Any]):
    """BackendConfig from JSON (nested 'detector' / 'ba' / 'pose_graph'
    dicts; unknown keys raise like the tracker config)."""
    from ..backend.ba import BAOptions
    from ..backend.pose_graph import PoseGraphOptions
    from ..backend.vo_backend import BackendConfig

    data = dict(data)
    if isinstance(data.get("ba"), dict):
        data["ba"] = _build(BAOptions, data["ba"])
    if isinstance(data.get("pose_graph"), dict):
        data["pose_graph"] = _build(PoseGraphOptions, data["pose_graph"])
    return _build(BackendConfig, data)


def tracker_config_to_dict(cfg: TrackerConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def save_tracker_config(cfg: TrackerConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(tracker_config_to_dict(cfg), f, indent=2)
