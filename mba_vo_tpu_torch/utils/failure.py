"""Tracking failure detection + elastic recovery.

The reference has no failure handling at all — errors call std::exit(0)
(Spline.h:50, blur_aware_direct_tracker.cpp:817; SURVEY.md §5 failure row).
Production tracking needs the opposite: a corrupted frame (sensor glitch,
dropped exposure, garbage image) must not destroy the trajectory state or
the process.

Detection is cheap and rides data the tracker already fetches per frame:
the keyframe-decision statistics (average optical flow, blur-kernel
length). A diverged LM solve shows up there as non-finite or physically
insane flow. Recovery is elastic: the tracker restores its pre-frame spline
/ velocity state (the frame is *rejected*, reported with the last good
pose) and continues tracking the next frame against the unchanged keyframe
— combined with utils.checkpoint, a crashed process restarts from its last
checkpoint the same way.

Wired into tracker.blur_tracker.BlurAwareTracker (auto_recover flag); each
rejection is recorded as a FailureEvent on tracker.failure_log.

A copy of ``mba_vo_tpu/utils/failure.py``: importing that module would run
the JAX package's ``__init__`` files, which import ``jax``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One detected-and-recovered tracking failure."""

    cap_time: float
    reason: str
    avg_flow: float
    avg_kernel: float


def stats_healthy(
    avg_flow: float, avg_kernel: float, max_sane_flow: float,
    lm_cost: float = 0.0,
) -> Tuple[bool, Optional[str]]:
    """Health verdict from the per-frame tracking statistics.

    Non-finite statistics mean the solve produced NaN/Inf somewhere in the
    pose chain; a non-finite LM cost means the frame data itself was
    corrupted (the LM loop's rejected-step path keeps the *knots* finite
    for NaN inputs, so the cost is the observable); a flow beyond
    ``max_sane_flow`` pixels means the optimizer left the image entirely
    (divergence), whatever the arithmetic says.
    """
    if not (math.isfinite(avg_flow) and math.isfinite(avg_kernel)):
        return False, "non-finite tracking statistics"
    if not math.isfinite(lm_cost):
        return False, "non-finite LM cost (corrupted frame data)"
    if avg_flow > max_sane_flow:
        return False, f"average flow {avg_flow:.1f}px exceeds sanity bound"
    return True, None
