"""Windowed bilinear sampling: per-keypoint windows + in-window interpolation.

Counterpart of ``mba_vo_tpu/ops/window_sampling.py``. For one keypoint, all
patch-pixel x virtual-pose samples land near the keyframe keypoint, so the
tracker extracts one [C, win, win] window of (I, dI/dx, dI/dy) per keypoint
once per keyframe and samples inside it. Samples outside the window
contribute 0, which bounds the blur length the model represents.

``window_bilinear`` launches kernel K1 (``ops.cuda_sampling``) on CUDA
tensors and runs the plain PyTorch version on CPU tensors. Nothing else
chooses between them: on a CUDA tensor the kernel runs or raises.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import cuda_sampling


def stack_image_channels(img: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """[3, H, W] stacked (I, gx, gy) for windowed extraction."""
    return torch.stack([img, grad[..., 0], grad[..., 1]], dim=0)


def extract_windows(
    chans: torch.Tensor, centers: torch.Tensor, win: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract [N, C, win_h, win_w] windows centred (as close as the borders
    allow) on ``centers`` [N, 2] (x, y), with win_h = min(win, H) and
    win_w = min(win, W). Returns (windows, starts [N, 2] int64 (x0, y0)).

    The starts are clamped into the image, so no window reads past a border
    (torch would raise on the CPU and read out of bounds on CUDA).
    """
    C, H, W = chans.shape
    win_h = min(win, H)
    win_w = min(win, W)
    cx = torch.floor(centers[:, 0]).to(torch.int64) - win_w // 2
    cy = torch.floor(centers[:, 1]).to(torch.int64) - win_h // 2
    x0 = torch.clamp(cx, 0, max(W - win_w, 0))
    y0 = torch.clamp(cy, 0, max(H - win_h, 0))
    rows = y0[:, None] + torch.arange(win_h, device=chans.device)  # [N, win_h]
    cols = x0[:, None] + torch.arange(win_w, device=chans.device)  # [N, win_w]
    windows = chans[:, rows[:, :, None], cols[:, None, :]]         # [C, N, wh, ww]
    return windows.permute(1, 0, 2, 3).contiguous(), torch.stack([x0, y0], dim=-1)


def _hat_weights(coord: torch.Tensor, win: int) -> torch.Tensor:
    """[..., win] bilinear hat weights: w[i] = max(0, 1 - |coord - i|)."""
    grid = torch.arange(win, dtype=coord.dtype, device=coord.device)
    # torch.maximum propagates a NaN coordinate, as jnp.maximum does
    return torch.maximum(torch.zeros((), dtype=coord.dtype, device=coord.device),
                         1.0 - torch.abs(coord[..., None] - grid))


def window_bilinear_plain(
    windows: torch.Tensor,   # [N, C, win_h, win_w]
    local_xy: torch.Tensor,  # [N, S, 2] window-relative coords
    valid: torch.Tensor,     # [N, S] bool/float
) -> torch.Tensor:
    """Plain PyTorch version of K1: two contractions with materialised hat
    weights, the Y axis of the windows first. Counterpart of
    ``window_bilinear_xla``."""
    wx = _hat_weights(local_xy[..., 0], windows.shape[-1])   # [N, S, win_w]
    wy = _hat_weights(local_xy[..., 1], windows.shape[-2])   # [N, S, win_h]
    A = torch.einsum("ncij,nsi->ncjs", windows, wy)
    out = torch.einsum("ncjs,nsj->ncs", A, wx)
    return out * valid.to(out.dtype)[:, None, :]


def window_bilinear(
    windows: torch.Tensor,   # [N, C, win_h, win_w]
    local_xy: torch.Tensor,  # [N, S, 2] window-relative coords
    valid: torch.Tensor,     # [N, S] bool/float
) -> torch.Tensor:
    """[N, C, S] bilinear samples of every channel.

    Out-of-window coordinates give 0; ``valid`` additionally masks samples
    whose global position is outside the image. CUDA tensors go to kernel
    K1, CPU tensors to :func:`window_bilinear_plain`.
    """
    if windows.is_cuda:
        dtype = windows.dtype
        return cuda_sampling.window_bilinear_cuda(
            cuda_sampling.kernel_windows(windows),
            local_xy.to(dtype).contiguous(),
            valid.to(dtype).contiguous(),
        )
    return window_bilinear_plain(windows, local_xy, valid)


def sample_windows_lk(
    windows: torch.Tensor, local_xy: torch.Tensor, valid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Intensity samples [N, S] with their Lucas-Kanade position derivative.

    Returns (value, d/dx, d/dy), each [N, S]: one C = 3 call of
    :func:`window_bilinear` samples (I, dI/dx, dI/dy). Under the reference's
    custom JVP of ``sample_windows_lk`` the windows are constant, so the
    tangent of the sample for a coordinate tangent (dx, dy) is
    ``d/dx * dx + d/dy * dy`` — the caller chains it with the coordinates'
    Jacobian. No derivative rule passes through the kernel itself.
    """
    allc = window_bilinear(windows, local_xy, valid)   # [N, 3, S]
    return allc[:, 0], allc[:, 1], allc[:, 2]


def sample_windows(
    windows: torch.Tensor, local_xy: torch.Tensor, valid: torch.Tensor
) -> torch.Tensor:
    """Intensity samples [N, S] only: one C = 1 call (the cost-only path).
    The slice ``windows[:, :1]`` is not contiguous; the kernel reads it in
    place through its keypoint stride."""
    return window_bilinear(windows[:, :1], local_xy, valid)[:, 0]
