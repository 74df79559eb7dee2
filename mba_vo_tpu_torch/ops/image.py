"""Image pyramids, gradients and bilinear sampling on tensors.

Counterpart of ``mba_vo_tpu/ops/image.py``:
  * pyramid levels come from an exact 2x2 box filter that drops an odd last
    row or column;
  * gradients are central differences with zeroed one-pixel borders;
  * out-of-bounds bilinear samples return 0 (masking in place of branches);
  * ``sample_lk`` is bilinear sampling whose derivative with respect to the
    position is the bilinearly sampled gradient image (the Lucas-Kanade
    convention), not the derivative of the bilinear interpolant.

``remap``, ``build_undistort_map`` and ``undistort_image`` are not ported
yet (see ROADMAP.md).
"""

from __future__ import annotations

from typing import List, Tuple

import torch


def downsample2x(img: torch.Tensor) -> torch.Tensor:
    """Exact 2x2 box-filter downsample to floor(H/2) x floor(W/2).

    The four taps are summed in row-major window order, then scaled by 1/4.
    """
    H, W = img.shape[-2], img.shape[-1]
    h2, w2 = H // 2, W // 2
    x = img[..., : 2 * h2, : 2 * w2]
    s = x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
    s = s + x[..., 1::2, 0::2]
    s = s + x[..., 1::2, 1::2]
    return s * 0.25


def image_pyramid(img: torch.Tensor, num_levels: int) -> List[torch.Tensor]:
    """List of pyramid levels, level 0 = full resolution."""
    levels = [img]
    for _ in range(1, num_levels):
        levels.append(downsample2x(levels[-1]))
    return levels


def image_gradients(img: torch.Tensor) -> torch.Tensor:
    """Central-difference gradients [..., H, W, 2] = (dI/dx, dI/dy), zeroed
    at the one-pixel border."""
    dx = torch.zeros_like(img)
    dy = torch.zeros_like(img)
    dx[..., 1:-1, 1:-1] = 0.5 * (img[..., 1:-1, 2:] - img[..., 1:-1, :-2])
    dy[..., 1:-1, 1:-1] = 0.5 * (img[..., 2:, 1:-1] - img[..., :-2, 1:-1])
    return torch.stack([dx, dy], dim=-1)


def gradient_magnitude(grad: torch.Tensor) -> torch.Tensor:
    """[H, W] gradient magnitude from an [H, W, 2] gradient image."""
    return torch.sqrt(grad[..., 0] ** 2 + grad[..., 1] ** 2)


def in_bounds(xy: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """True where the bilinear support is fully inside the image."""
    x, y = xy[..., 0], xy[..., 1]
    return (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)


def bilinear_sample(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of ``img`` [H, W] at positions ``xy`` [..., 2].

    Corner indices are clamped into the image before the gather and
    out-of-bounds positions return 0.
    """
    h, w = img.shape[-2], img.shape[-1]
    x, y = xy[..., 0], xy[..., 1]
    xf = torch.floor(x)
    yf = torch.floor(y)
    dx = x - xf
    dy = y - yf
    # clamp in float first: an int cast of a huge or non-finite coordinate
    # is undefined, and the clamped taps are masked out below anyway
    x0 = torch.clamp(xf, 0, w - 1).to(torch.int64)
    y0 = torch.clamp(yf, 0, h - 1).to(torch.int64)
    x1 = torch.clamp(xf + 1, 0, w - 1).to(torch.int64)
    y1 = torch.clamp(yf + 1, 0, h - 1).to(torch.int64)
    v00, v01 = img[..., y0, x0], img[..., y0, x1]
    v10, v11 = img[..., y1, x0], img[..., y1, x1]
    dxdy = dx * dy
    val = (
        (1.0 - dx - dy + dxdy) * v00
        + (dx - dxdy) * v01
        + (dy - dxdy) * v10
        + dxdy * v11
    )
    return torch.where(in_bounds(xy, h, w), val, torch.zeros_like(val))


def sample_lk_with_gradient(
    img: torch.Tensor, grad_img: torch.Tensor, xy: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(value, d/dx, d/dy) of the Lucas-Kanade sample at ``xy`` [..., 2]: the
    bilinear samples of ``img`` [H, W] and of the two channels of
    ``grad_img`` [H, W, 2], taken in one gather. All three are 0 out of
    bounds."""
    chans = torch.stack([img, grad_img[..., 0], grad_img[..., 1]], dim=0)
    out = bilinear_sample(chans, xy)
    return out[0], out[1], out[2]


class _SampleLK(torch.autograd.Function):
    """bilinear_sample(img, xy) with the Lucas-Kanade derivative rule."""

    @staticmethod
    def forward(img, grad_img, xy):
        return bilinear_sample(img, xy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _img, grad_img, xy = inputs
        ctx.save_for_backward(grad_img, xy)
        ctx.save_for_forward(grad_img, xy)

    @staticmethod
    def backward(ctx, grad_out):
        grad_img, xy = ctx.saved_tensors
        gx = bilinear_sample(grad_img[..., 0], xy)
        gy = bilinear_sample(grad_img[..., 1], xy)
        return None, None, torch.stack([grad_out * gx, grad_out * gy], dim=-1)

    @staticmethod
    def jvp(ctx, dimg, _dgrad, dxy):
        grad_img, xy = ctx.saved_tensors
        out = torch.zeros(xy.shape[:-1], dtype=xy.dtype, device=xy.device)
        if dxy is not None:
            gx = bilinear_sample(grad_img[..., 0], xy)
            gy = bilinear_sample(grad_img[..., 1], xy)
            out = out + gx * dxy[..., 0] + gy * dxy[..., 1]
        if dimg is not None:
            out = out + bilinear_sample(dimg, xy)
        return out


def sample_lk(img: torch.Tensor, grad_img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample whose position derivative is the sampled gradient image.

    Value: ``bilinear_sample(img, xy)``. Under ``torch.autograd`` (backward
    and forward mode) the derivative with respect to ``xy`` is
    ``bilinear_sample(grad_img, xy)``, the smoothed central-difference
    gradient; a tangent of ``grad_img`` is ignored and a forward-mode tangent
    of ``img`` passes through the (linear) interpolation. Backward mode
    gives no gradient for ``img``. Out of bounds: value 0, gradient 0.
    img: [H, W]; grad_img: [H, W, 2]; xy: [..., 2].
    """
    return _SampleLK.apply(img, grad_img, xy)
