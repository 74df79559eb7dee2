"""Meshes of ranks and keypoint sharding helpers.

Counterpart of ``mba_vo_tpu/parallel/mesh.py``. The reference shards the
keypoints over a ``jax.sharding.Mesh`` of devices inside one process; the
port runs one process per shard and a :class:`Mesh` is the
``torch.distributed`` process group of those ranks. Each rank holds every
keypoint, replicated, and hands the LM of a level its contiguous slice
``[rank N/n, (rank + 1) N/n)``; images and the spline are replicated, and
the normal equations are all-reduced over the group
(``utils.collectives.allreduce``, the reference's psum).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..ops.residual import TrackingLevelData

KP_AXIS = "kp"


class Mesh(NamedTuple):
    """The ranks one sharded computation runs on.

    group:      the process group every collective of the computation uses
    size:       its number of ranks (the shard count)
    rank:       this process's rank in it (its shard)
    axis_names: the reference mesh's axis names
    shape:      the reference mesh's shape (its product is ``size``)
    """

    group: object
    size: int
    rank: int
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]


def visible_ranks() -> int:
    """Ranks of the default process group (1 without one): the port's
    count of the devices a mesh can take."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _mesh(n: int, axis_names: Tuple[str, ...], shape: Tuple[int, ...]) -> Mesh:
    visible = visible_ranks()
    if visible < n:
        raise ValueError(
            f"shard_devices={n} but only {visible} devices are visible (the "
            "ranks of the torch.distributed default process group; launch with "
            f"python -m torch.distributed.run --nproc-per-node {n})")
    if not dist.is_initialized():
        # one process: a mesh of one rank, whose collectives are no-ops
        return Mesh(group=None, size=n, rank=0, axis_names=axis_names, shape=shape)
    world = dist.get_world_size()
    # new_group is collective: every rank of the default group calls it
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    rank = dist.get_rank()
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh of the first {n} ranks")
    return Mesh(group=group, size=n, rank=rank, axis_names=axis_names, shape=shape)


def make_mesh(n_devices: Optional[int] = None, axis: str = KP_AXIS) -> Mesh:
    """1-D mesh over the first n ranks of the default process group
    (default: all of them). Every rank of the default group calls it."""
    n = visible_ranks() if n_devices is None else int(n_devices)
    return _mesh(n, (axis,), (n,))


def pad_keypoints(data: TrackingLevelData, multiple: int) -> TrackingLevelData:
    """Pad the keypoint axis to a multiple of the shard count with masked
    slots (mask 0 keypoints contribute nothing anywhere downstream)."""
    n = data.kp_xy.shape[0]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return data
    return data._replace(
        kp_xy=torch.cat([data.kp_xy, data.kp_xy.new_zeros((n_pad, 2))]),
        # depth 1, masked anyway (no division by zero downstream)
        kp_z=torch.cat([data.kp_z, data.kp_z.new_ones((n_pad,))]),
        kp_mask=torch.cat([data.kp_mask, data.kp_mask.new_zeros((n_pad,))]),
    )


def level_data_specs() -> Tuple[str, ...]:
    """The keypoint-indexed fields of TrackingLevelData, which shard; every
    other field is replicated."""
    return ("kp_xy", "kp_z", "kp_mask")


def shard_rows(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``, whose length is a
    multiple of the mesh size (host-major over a pod mesh's axes)."""
    per = x.shape[dim] // mesh.size
    return x.narrow(dim, mesh.rank * per, per)


def shard_level_data(data: TrackingLevelData, mesh: Mesh) -> TrackingLevelData:
    """Pad the keypoints to a multiple of the mesh size and keep this rank's
    slice of them. Works for 1-D and pod meshes alike (keypoints over the
    flattened ranks)."""
    data = pad_keypoints(data, mesh.size)
    return data._replace(**{f: shard_rows(getattr(data, f), mesh)
                            for f in level_data_specs()})
