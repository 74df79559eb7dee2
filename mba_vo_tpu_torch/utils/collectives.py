"""The two collectives of the sharded paths, as plain functions on tensors.

``group=None`` means no collective: each function returns its input, so
the single-process code paths run unchanged. Otherwise ``group`` is the
``torch.distributed`` process group of a ``parallel.mesh.Mesh`` and every
rank of it must make the same calls in the same order.

:func:`allreduce` is the counterpart of the reference's
``lax.psum(x, axis_name)``: the sum over the ranks, the same bits on every
rank, so every rank takes the same branch of a host loop that reads it.
Every reduction of the tracker's normal equations (``ops.residual.assemble``),
its affine fit, its outlier statistics (``solver.lm.detect_outliers``) and
the bundle adjustment's Schur system passes through it; a fused
normal-equation kernel writes its per-rank sums just before it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the ranks of ``group`` (``x`` itself when None)."""
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y


def allgather(x: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order (``x``
    itself when None): a shard-local keypoint or landmark axis back to the
    global one."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)
