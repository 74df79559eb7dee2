"""Sparse landmark map as dense fixed-shape tensors.

Counterpart of ``mba_vo_tpu/backend/map.py``: the sliding window's whole
observation structure is three dense tensors plus a landmark mask, so the
bundle adjustment works on fixed shapes:

    points   [M, 3]      landmark positions (world)
    obs_xy   [W, M, 2]   pixel observation of landmark m in window frame w
    obs_mask [W, M]      1.0 where frame w observes landmark m
    point_mask [M]       padding slots and culled points are 0
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SlidingWindowMap(NamedTuple):
    points: torch.Tensor      # [M, 3]
    point_mask: torch.Tensor  # [M]
    obs_xy: torch.Tensor      # [W, M, 2]
    obs_mask: torch.Tensor    # [W, M]

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def window_size(self) -> int:
        return self.obs_xy.shape[0]


def make_map(points, obs_xy, obs_mask, point_mask=None) -> SlidingWindowMap:
    points = torch.as_tensor(points)
    opts = dict(dtype=points.dtype, device=points.device)
    if point_mask is None:
        point_mask = torch.ones(points.shape[0], **opts)
    return SlidingWindowMap(
        points=points,
        point_mask=torch.as_tensor(point_mask, **opts),
        obs_xy=torch.as_tensor(obs_xy, **opts),
        obs_mask=torch.as_tensor(obs_mask, **opts),
    )


def pad_map(m: SlidingWindowMap, num_points: int) -> SlidingWindowMap:
    """Pad the landmark axis to a static size with masked slots."""
    cur = m.num_points
    if cur >= num_points:
        return m
    pad = num_points - cur
    W = m.window_size
    return SlidingWindowMap(
        points=torch.cat([m.points, m.points.new_ones((pad, 3))], dim=0),
        point_mask=torch.cat([m.point_mask, m.point_mask.new_zeros((pad,))]),
        obs_xy=torch.cat([m.obs_xy, m.obs_xy.new_zeros((W, pad, 2))], dim=1),
        obs_mask=torch.cat([m.obs_mask, m.obs_mask.new_zeros((W, pad))], dim=1),
    )
