"""Residual patch patterns (numpy only).

A copy of ``mba_vo_tpu/tracker/patterns.py``: importing that module would
run the JAX package's ``__init__`` files, which import ``jax``. The standard
choices: a DSO-style 8-point spread pattern and dense squares.
"""

from __future__ import annotations

import numpy as np


def pattern_dso8() -> np.ndarray:
    """8-point spread pattern (DSO residual pattern style)."""
    return np.array(
        [[0, 0], [-2, 0], [2, 0], [0, -2], [0, 2], [-1, -1], [1, 1], [-1, 1]],
        dtype=np.int32,
    )


def pattern_square(radius: int) -> np.ndarray:
    """Dense (2r+1)^2 square pattern."""
    r = np.arange(-radius, radius + 1)
    xx, yy = np.meshgrid(r, r)
    return np.stack([xx.ravel(), yy.ravel()], axis=-1).astype(np.int32)


def pattern_cross(radius: int) -> np.ndarray:
    """Cross pattern: center + 4 arms of length radius (4r+1 pixels)."""
    pts = [[0, 0]]
    for d in range(1, radius + 1):
        pts += [[d, 0], [-d, 0], [0, d], [0, -d]]
    return np.asarray(pts, dtype=np.int32)


PATTERNS = {
    "dso8": pattern_dso8,
    "square1": lambda: pattern_square(1),
    "square2": lambda: pattern_square(2),
    "cross2": lambda: pattern_cross(2),
}
