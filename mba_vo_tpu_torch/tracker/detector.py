"""Semi-dense feature detection with grid non-maximum suppression.

Counterpart of ``mba_vo_tpu/tracker/detector.py``: every pixel whose
gradient magnitude exceeds a threshold is a candidate; grid NMS keeps the
strongest candidate per cell (cells shrink by 1/sqrt(2) per level); the
result is a fixed-size [max_keypoints] array plus a validity mask.
``refine_subpixel`` moves corners to the peak of a parabola through the
response along each axis.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class DetectorOptions:
    score_threshold: float = 25.0
    cell_h: int = 30
    cell_w: int = 30
    max_keypoints: int = 512


def _cell_size_at_level(cell: int, level: int) -> int:
    """Cell shrinks by 1.414^level."""
    return max(1, int(cell / math.pow(1.414, level)))


def detect_semidense(
    grad_mag: torch.Tensor,
    level: int,
    opts: DetectorOptions,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Detect up to max_keypoints semi-dense features on one pyramid level.

    grad_mag: [H, W] gradient-magnitude image of this level.
    Returns (kp_xy [M, 2] float, response [M], mask [M] float) with
    M = opts.max_keypoints; invalid slots have mask 0 and position (0, 0).

    Cells are ranked by response with ties broken by cell index, as
    ``jax.lax.top_k`` does: a stable descending sort (``torch.topk`` orders
    ties, such as the many zero-response cells, differently).
    """
    H, W = grad_mag.shape
    ch = _cell_size_at_level(opts.cell_h, level)
    cw = _cell_size_at_level(opts.cell_w, level)
    n_ch = H // ch + 1
    n_cw = W // cw + 1

    resp = torch.where(grad_mag > opts.score_threshold, grad_mag,
                       torch.zeros_like(grad_mag))
    padded = resp.new_zeros((n_ch * ch, n_cw * cw))
    padded[:H, :W] = resp
    cells = padded.reshape(n_ch, ch, n_cw, cw).permute(0, 2, 1, 3)
    cells = cells.reshape(n_ch, n_cw, ch * cw)

    best = torch.argmax(cells, dim=-1)           # [n_ch, n_cw], first max
    best_val = torch.gather(cells, -1, best[..., None])[..., 0]

    cy = torch.arange(n_ch, device=grad_mag.device)[:, None]
    cx = torch.arange(n_cw, device=grad_mag.device)[None, :]
    py = cy * ch + best // cw
    px = cx * cw + best % cw

    flat_val = best_val.reshape(-1)
    flat_x = px.reshape(-1)
    flat_y = py.reshape(-1)

    m = opts.max_keypoints
    n_cells = flat_val.shape[0]
    if n_cells < m:
        pad = m - n_cells
        flat_val = torch.cat([flat_val, flat_val.new_zeros(pad)])
        flat_x = torch.cat([flat_x, flat_x.new_zeros(pad)])
        flat_y = torch.cat([flat_y, flat_y.new_zeros(pad)])
    top_idx = torch.sort(flat_val, descending=True, stable=True).indices[:m]
    top_val = flat_val[top_idx]

    xs = flat_x[top_idx].to(grad_mag.dtype)
    ys = flat_y[top_idx].to(grad_mag.dtype)
    # cells with no candidate have response 0
    mask = (top_val > 1e-6).to(grad_mag.dtype)
    kp_xy = torch.stack([xs, ys], dim=-1) * mask[:, None]
    return kp_xy, top_val, mask


def refine_subpixel(
    resp: torch.Tensor, kp_xy: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Sub-pixel corner refinement by a per-axis parabola through the
    response: the quadratic through (r[-1], r[0], r[+1]) peaks at
    -0.5 (r[+1] - r[-1]) / (r[+1] - 2 r[0] + r[-1]); offsets are clamped to
    +-0.5 px and zeroed where the denominator is flat, and masked slots keep
    their position. The integer pixel is clamped one pixel inside the
    image."""
    H, W = resp.shape
    xi = torch.clamp(kp_xy[:, 0].to(torch.int32), 1, W - 2).long()
    yi = torch.clamp(kp_xy[:, 1].to(torch.int32), 1, H - 2).long()

    def at(dy, dx):
        return resp[yi + dy, xi + dx]

    def axis_offset(rm, r0, rp):
        denom = rp - 2.0 * r0 + rm
        flat = torch.abs(denom) > 1e-12
        # the quotient in float64, rounded back, as on every device
        num = (-0.5 * (rp - rm)).double()
        off = (num / torch.where(flat, denom, 1.0).double()).to(denom.dtype)
        off = torch.where(flat, off, torch.zeros_like(denom))
        return torch.clamp(off, -0.5, 0.5)

    ox = axis_offset(at(0, -1), at(0, 0), at(0, 1))
    oy = axis_offset(at(-1, 0), at(0, 0), at(1, 0))
    refined = kp_xy + torch.stack([ox, oy], dim=-1).to(kp_xy.dtype)
    return torch.where(mask[:, None] > 0, refined, kp_xy)
