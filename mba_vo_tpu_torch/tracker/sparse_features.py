"""Sparse corner features: Shi-Tomasi detection, oriented-BRIEF descriptors
and Hamming matching as one matrix product.

Counterpart of ``mba_vo_tpu/tracker/sparse_features.py``:
  * the Shi-Tomasi response is the smaller eigenvalue of the 3x3 box-summed
    structure tensor, grid-NMS'd by the semi-dense detector and refined to
    sub-pixel positions;
  * descriptors are oriented BRIEF: a fixed seeded 256-pair pattern rotated
    by the intensity-centroid orientation, sampled bilinearly;
  * descriptors are {-1, +1} vectors, so the Hamming distance matrix is one
    product, (bits - a b^T) / 2, followed by a mutual-best and Lowe-ratio
    test. ``torch.argmin`` returns the first index of a tie, as
    ``jnp.argmin`` does.

The box sums and the orientation moments add their terms in a fixed order
(shifted slices, a pairwise tree), and sqrt, atan2, cos and sin run in
float64 and round back, so float32 features come out the same on the CPU
and on a GPU.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.image import bilinear_sample, image_gradients
from .detector import DetectorOptions, detect_semidense, refine_subpixel

NUM_BRIEF_BITS = 256
_PATCH_RADIUS = 15


def brief_pattern(seed: int = 7) -> np.ndarray:
    """[256, 4] (ax, ay, bx, by) BRIEF test pairs, Gaussian-distributed in a
    31x31 patch (the classic BRIEF-31 construction)."""
    rng = np.random.default_rng(seed)
    pts = np.clip(
        rng.normal(0.0, _PATCH_RADIUS / 2.5, (NUM_BRIEF_BITS, 4)),
        -_PATCH_RADIUS, _PATCH_RADIUS,
    )
    return pts.astype(np.float32)


class SparseFeatures(NamedTuple):
    kp_xy: torch.Tensor        # [N, 2]
    response: torch.Tensor     # [N]
    mask: torch.Tensor         # [N]
    orientation: torch.Tensor  # [N] radians
    descriptors: torch.Tensor  # [N, 256] in {-1, +1} (0 rows for masked slots)


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a tree of halves (zero-padded to a power
    of two): the same additions in the same order on every device."""
    n = x.shape[-1]
    size = 1 << max(0, (n - 1).bit_length())
    if size > n:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (size - n,))], dim=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _box_mean(a: torch.Tensor, window: int) -> torch.Tensor:
    """'same'-size convolution with a window x window box of 1/window^2
    (zero outside the image), as nine shifted products added row by row."""
    r = window // 2
    H, W = a.shape
    k = 1.0 / (window * window)
    p = torch.nn.functional.pad(a[None, None], (r, r, r, r))[0, 0]
    out = None
    for dy in range(window):
        for dx in range(window):
            term = p[dy:dy + H, dx:dx + W] * k
            out = term if out is None else out + term
    return out


def shi_tomasi_response(img: torch.Tensor, window: int = 3) -> torch.Tensor:
    """Min-eigenvalue corner response of the box-summed structure tensor."""
    g = image_gradients(img)
    gx, gy = g[..., 0], g[..., 1]
    sxx = _box_mean(gx * gx, window)
    syy = _box_mean(gy * gy, window)
    sxy = _box_mean(gx * gy, window)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    # the square root in float64, rounded back: CUDA's float32 sqrt is not
    # always correctly rounded, float64 rounded to float32 is
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0).double()).to(img.dtype)
    return 0.5 * (tr - disc)


def _disc_offsets(radius: int):
    r = np.arange(-radius, radius + 1)
    ox, oy = np.meshgrid(r, r)
    keep = (ox ** 2 + oy ** 2) <= radius ** 2
    return ox[keep], oy[keep]


def orientation_ic(img: torch.Tensor, kp_xy: torch.Tensor,
                   radius: int = 7) -> torch.Tensor:
    """Intensity-centroid orientation (the ORB construction): theta =
    atan2(m01, m10) over a disc around each keypoint."""
    ox_np, oy_np = _disc_offsets(radius)
    opts = dict(dtype=img.dtype, device=img.device)
    ox = torch.tensor(ox_np, **opts)
    oy = torch.tensor(oy_np, **opts)
    n = kp_xy.shape[0]
    pos = kp_xy[:, None, :] + torch.stack(
        [ox.expand(n, -1), oy.expand(n, -1)], dim=-1)
    vals = bilinear_sample(img, pos)  # [N, P]
    m10 = _pairwise_sum(vals * ox[None, :])
    m01 = _pairwise_sum(vals * oy[None, :])
    # in float64, rounded back: float32 atan2 differs by an ulp between
    # the CPU's and CUDA's libraries, float64 rounded to float32 does not
    return torch.atan2(m01.double(), m10.double()).to(img.dtype)


def brief_descriptors(
    img: torch.Tensor, kp_xy: torch.Tensor, orientation: torch.Tensor,
    pattern: torch.Tensor,
) -> torch.Tensor:
    """[N, 256] descriptors in {-1, +1}: sign of I(p + R a) - I(p + R b)."""
    theta = orientation.double()    # as in orientation_ic
    c = torch.cos(theta).to(orientation.dtype)
    s = torch.sin(theta).to(orientation.dtype)

    def rotate(off_x, off_y):
        rx = c[:, None] * off_x[None, :] - s[:, None] * off_y[None, :]
        ry = s[:, None] * off_x[None, :] + c[:, None] * off_y[None, :]
        return rx, ry

    ax, ay = rotate(pattern[:, 0], pattern[:, 1])
    bx, by = rotate(pattern[:, 2], pattern[:, 3])
    pa = kp_xy[:, None, :] + torch.stack([ax, ay], dim=-1)
    pb = kp_xy[:, None, :] + torch.stack([bx, by], dim=-1)
    va = bilinear_sample(img, pa)
    vb = bilinear_sample(img, pb)
    one = torch.ones((), dtype=img.dtype, device=img.device)
    return torch.where(va < vb, one, -one)


def detect_sparse(
    img: torch.Tensor, opts: DetectorOptions, level: int = 0,
    pattern: torch.Tensor = None,
) -> SparseFeatures:
    """Shi-Tomasi corners, grid NMS, sub-pixel refinement and oriented BRIEF
    on one [H, W] image, in the image's dtype and on its device."""
    if pattern is None:
        pattern = torch.as_tensor(brief_pattern(), device=img.device)
    resp = shi_tomasi_response(img)
    kp_xy, response, mask = detect_semidense(resp, level, opts)
    kp_xy = refine_subpixel(resp, kp_xy, mask)
    theta = orientation_ic(img, kp_xy)
    desc = brief_descriptors(img, kp_xy, theta, pattern)
    desc = desc * mask[:, None]
    return SparseFeatures(
        kp_xy=kp_xy, response=response, mask=mask,
        orientation=theta, descriptors=desc,
    )


def match_descriptors(
    a: SparseFeatures, b: SparseFeatures,
    max_hamming: float = 80.0, ratio: float = 0.8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mutual-best Hamming matching with the Lowe ratio test.

    Returns (match_idx [..., Na] int32, an index into b or -1, distance
    [..., Na]). ``a`` may carry leading batch axes (several keyframes
    matched against one ``b`` at once); each batch entry is matched as on
    its own. The distance matrix is one product of {-1, +1} descriptors:
    hamming = (bits - a . b^T) / 2, exact in any float type.
    """
    dot = a.descriptors @ b.descriptors.T               # [..., Na, Nb]
    ham = 0.5 * (NUM_BRIEF_BITS - dot)
    big = torch.tensor(1e9, dtype=ham.dtype, device=ham.device)
    valid = (a.mask[..., :, None] > 0) & (b.mask[None, :] > 0)
    ham = torch.where(valid, ham, big)

    best_j = torch.argmin(ham, dim=-1)                   # [..., Na], first min
    best_d = torch.gather(ham, -1, best_j[..., None])[..., 0]
    # second best for the ratio test: the best entry set to `big`
    ham_wo = ham.scatter(-1, best_j[..., None], 1e9)
    second_d = ham_wo.min(dim=-1).values
    # mutual check
    best_i_of_b = torch.argmin(ham, dim=-2)              # [..., Nb]
    rows = torch.arange(ham.shape[-2], device=ham.device)
    mutual = torch.gather(best_i_of_b, -1, best_j) == rows

    ok = (
        (best_d <= max_hamming)
        & (best_d <= ratio * second_d)
        & mutual
        & (a.mask > 0)
    )
    minus = torch.full_like(best_j, -1)
    return torch.where(ok, best_j, minus).to(torch.int32), best_d
