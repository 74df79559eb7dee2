"""Landmark-sharded bundle adjustment over the ranks of a mesh.

Counterpart of ``mba_vo_tpu/parallel/sharded_ba.py``. Keyframe poses are
replicated; the landmarks and their observation columns shard over the
ranks. Each rank runs ``backend.ba.run_bundle_adjustment`` with the mesh's
process group: it builds its landmarks' V, W and g_x blocks, the reduced
camera system and its right-hand side are all-reduced, the [6W, 6W] solve
runs on every rank alike, and the landmark back-substitution stays on its
rank. The refined map is gathered back to the global landmark axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..backend.ba import BAOptions, BAProblem, BASummary, run_bundle_adjustment
from ..backend.map import SlidingWindowMap, pad_map
from ..utils.collectives import allgather
from .mesh import Mesh, make_mesh, shard_rows

LM_AXIS = "lm"

# the landmark axis of each map field
_MAP_AXES = SlidingWindowMap(points=0, point_mask=0, obs_xy=1, obs_mask=1)


def make_ba_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D mesh of the first n ranks over the landmark axis."""
    return make_mesh(n_devices, axis=LM_AXIS)


def shard_ba_problem(problem: BAProblem, mesh: Mesh) -> BAProblem:
    """Pad the landmark axis to a multiple of the mesh size with inert slots
    and keep this rank's landmark columns."""
    m = problem.map
    target = -(-m.num_points // mesh.size) * mesh.size
    m = pad_map(m, target)
    return problem._replace(map=SlidingWindowMap(
        *(shard_rows(x, mesh, dim) for x, dim in zip(m, _MAP_AXES))))


def run_bundle_adjustment_sharded(
    problem: BAProblem, opts: BAOptions, mesh: Mesh
) -> Tuple[BAProblem, BASummary]:
    """Landmark-sharded BA; ``problem`` comes from :func:`shard_ba_problem`.
    Returns the refined problem with the global (padded) landmark axis."""
    refined, summary = run_bundle_adjustment(problem, opts, group=mesh.group)
    m = refined.map
    return refined._replace(map=SlidingWindowMap(
        *(allgather(x, mesh.group, dim) for x, dim in zip(m, _MAP_AXES)))), summary
