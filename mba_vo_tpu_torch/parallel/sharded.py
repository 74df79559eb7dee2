"""Keypoint-sharded LM over the ranks of a mesh.

Counterpart of ``mba_vo_tpu/parallel/sharded.py``. The reference wraps the
whole on-device LM loop of a level in one ``shard_map``; here every rank
runs ``solver.lm.optimize_level`` on its keypoint slice with the mesh's
process group: each evaluation's H [6K, 6K], g [6K], cost and outlier
statistics are all-reduced inside the LM's decision and commit stages,
which therefore run their plain versions here (``solver/lm.py``'s
``lm_step_plain``, ``lm_decide_plain``, ``lm_commit_plain``, on the card
too), and the small dense solve runs on every rank on the same bits, so
the knots stay replicated and every rank reads the same continue flag. The summary's keypoint-indexed fields (the
outlier mask [N] and the patch costs [F, N]) are gathered back to the
global keypoint axis after the level, as the reference's ``out_specs``
give its caller global arrays: the post-track statistics, the joint health
check and the next level then see what they see in one process.
"""

from __future__ import annotations

from typing import Callable, Tuple

from ..core.spline import SplineKnots
from ..ops.residual import TrackingLevelData
from ..solver.lm import LMOptions, LMSummary, optimize_level
from ..utils.collectives import allgather
from .mesh import Mesh, shard_level_data, shard_rows


def _global_summary(summary: LMSummary, mesh: Mesh) -> LMSummary:
    return summary._replace(
        outlier_mask=allgather(summary.outlier_mask, mesh.group, dim=0),
        patch_costs=allgather(summary.patch_costs, mesh.group, dim=1),
    )


def optimize_level_sharded(
    knots: SplineKnots,
    data: TrackingLevelData,
    num_vir: int,
    degree: int,
    opts: LMOptions,
    mesh: Mesh,
    cache=None,
) -> Tuple[SplineKnots, LMSummary]:
    """Keypoint-sharded optimize_level. ``data`` (and ``cache``, when given)
    hold this rank's keypoint slice (``parallel.mesh.shard_level_data``);
    the summary's outlier mask and patch costs cover every rank's slice, in
    rank order."""
    knots, summary = optimize_level(knots, data, num_vir, degree, opts, cache=cache,
                                    group=mesh.group)
    return knots, _global_summary(summary, mesh)


def optimize_level_shardmapped(
    mesh: Mesh, num_vir: int, degree: int, opts: LMOptions, with_cache: bool = True,
) -> Callable:
    """optimize_level over the whole keypoint set, sharded: the callable
    takes the global level data (and the keyframe's global window cache,
    ``with_cache``), runs the LM on this rank's slice of both and returns
    global summaries. The tracker's fused frame, chunk and joint paths call
    it per level (TrackerConfig.shard_devices); the cache is sliced, never
    re-extracted per shard."""
    def run(knots: SplineKnots, data: TrackingLevelData, cache=None):
        local = shard_level_data(data, mesh)
        if with_cache:
            cache = tuple(shard_rows(c, mesh) for c in cache)
        return optimize_level_sharded(knots, local, num_vir, degree, opts, mesh,
                                      cache=cache)

    return run


def optimize_level_sharded_pod(
    knots: SplineKnots,
    data: TrackingLevelData,
    num_vir: int,
    degree: int,
    opts: LMOptions,
    mesh: Mesh,
) -> Tuple[SplineKnots, LMSummary]:
    """Keypoint-sharded LM over a (host, device) pod mesh: the keypoints
    shard over the flattened ranks, host-major, and every reduction runs
    over the whole pod. ``data`` holds this rank's slice."""
    return optimize_level_sharded(knots, data, num_vir, degree, opts, mesh)
