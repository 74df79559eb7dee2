"""Bind and launch the direct path's whole-image Lucas-Kanade sampler K4.

``csrc/image_bilinear.cu`` replaces the gather that XLA fuses into
``mba_vo_tpu/ops/residual.py::compute_residuals`` (``warp_and_sample`` ->
``sample_lk`` -> ``bilinear_sample``; no Pallas source). Three designs of
one function, equal to the bit: :func:`image_bilinear_cuda`, the select
design the tracker launches (32-bit indices, ``i // S`` by the constant of
:func:`sample_divisor`, every tap load issued before the in-image test
selects 0; its geometry is :func:`select_layout`), which samples the
keyframe image and, with C = 3, both channels of its gradient image at
N x S whole-image positions, reading the planes in place (no stacked
copy); :func:`image_bilinear_interleaved_cuda`,
the same from one [H, W, 4] plane (:func:`interleave_planes`), and
:func:`image_bilinear_branch_cuda`, the earlier design (64-bit indices, a
branch before the taps), which only the sweeps launch. Its plain PyTorch
version is ``ops/image.py::image_bilinear_lk_plain``, which CPU tensors
take; ``ops/image.py::image_bilinear_lk`` chooses by the tensors' device and
nothing else. The library is built and loaded by ``ops/cuda_build.py`` at
first use; nothing here runs when the module is imported.

The wrappers take CUDA tensors only and raise on anything else (device,
dtype, shape, contiguity, positions or a gradient image whose pairs are not
aligned for one load, sizes past the 32-bit indices); they never fall back
to the plain version. ``LAUNCHES_IMAGE`` counts the select design's
launches, one a call, ``LAUNCHES_IMAGE_INTERLEAVED`` and
``LAUNCHES_IMAGE_BRANCH`` the other designs'; a call recorded into a CUDA
graph is not a launch and is not counted.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple, Union

import torch

from . import cuda_build
from .cuda_residual import _check, _launch

LAUNCHES_IMAGE = 0
LAUNCHES_IMAGE_INTERLEAVED = 0
LAUNCHES_IMAGE_BRANCH = 0
# the select design's block (image_bilinear.cu's kThreads), one sample a thread
IMAGE_THREADS = 256
_loaded: Dict[str, ctypes.CDLL] = {}
_P, _I, _U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
_SIGNATURES = {
    # img, grad, loc, out, N, S, H, W, C, m, k, stream
    "image_bilinear": [_P] * 4 + [_I] * 5 + [_U, _I, _P],
    # plane, loc, out, N, S, H, W, m, k, stream
    "image_bilinear_interleaved": [_P] * 3 + [_I] * 4 + [_U, _I, _P],
    # img, grad, loc, out, N, S, H, W, C, stream
    "image_bilinear_branch": [_P] * 4 + [_I] * 5 + [_P],
}

Output = Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def sample_divisor(S: int) -> Tuple[int, int]:
    """(m, k) with (i m) >> k == i // S for every 0 <= i < 2^31: k = 31 +
    ceil(log2 S), m = ceil(2^k / S) < 2^32. The error e = m S - 2^k lies in
    [0, S), so i m / 2^k = i / S + i e / (S 2^k) with i e < 2^31 S <= 2^k:
    the excess stays under 1 / S and never carries past the next
    integer."""
    if S < 1:
        raise ValueError(f"sample_divisor: S = {S}")
    k = 31 + (S - 1).bit_length()
    m = -(-(1 << k) // S)
    return m, k


@dataclasses.dataclass(frozen=True)
class SelectLayout:
    """The select design's launch geometry for N S samples: ``grid`` blocks
    of :data:`IMAGE_THREADS` threads, and the divisor (m, k) of
    :func:`sample_divisor`. Thread t of block b takes sample i = b
    IMAGE_THREADS + t below N S, and writes sample (n, s) = ((i m) >> k,
    i - n S) (``image_bilinear.cu``'s launcher computes the same grid)."""
    grid: int
    m: int
    k: int

    def samples(self, block, thread):
        """The sample index i of thread ``thread`` of ``block`` (numpy or
        Python integers)."""
        return block * IMAGE_THREADS + thread

    def keypoint(self, i):
        """n = i // S as the kernel computes it, from i (numpy int64 or a
        Python int below 2^31)."""
        return (i * self.m) >> self.k


def select_layout(N: int, S: int) -> SelectLayout:
    """The select design's geometry (:class:`SelectLayout`); raises past its
    32-bit indices."""
    if N * S >= 2 ** 31:
        raise ValueError(f"image_bilinear: {N} x {S} samples exceed the 32-bit indices")
    m, k = sample_divisor(max(S, 1))
    return SelectLayout(-(-N * S // IMAGE_THREADS), m, k)


def _entry(design: str, dtype: torch.dtype):
    if "image_bilinear" not in _loaded:
        lib = cuda_build.load("image_bilinear")
        for name, signature in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes, fn.restype = signature, ctypes.c_int
        _loaded["image_bilinear"] = lib
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(_loaded["image_bilinear"], f"{design}_{suffix}")


def _aligned(who: str, name: str, x: torch.Tensor, nbytes: int):
    if x.data_ptr() % nbytes:
        raise ValueError(f"{who}: {name}'s storage is not aligned to {nbytes} bytes")


def _checked(who, img, grad, loc, channels):
    """The select and the branch designs' checks; returns (dtype, H, W, N,
    S, the output [N, channels, S])."""
    if channels not in (1, 3):
        raise ValueError(f"{who}: {channels} channels (1 or 3)")
    H, W = img.shape if img.dim() == 2 else (None, None)
    N, S = loc.shape[:2] if loc.dim() == 3 else (None, None)
    tensors, shapes = dict(img=img, loc=loc), dict(img=(H, W), loc=(N, S, 2))
    if channels == 3:
        tensors["grad"], shapes["grad"] = grad, (H, W, 2)
    dtype = _check(who, tensors, shapes)
    if channels == 3:
        _aligned(who, "grad", grad, 2 * grad.element_size())
    out = torch.empty((N, channels, S), dtype=dtype, device=loc.device)
    return dtype, H, W, N, S, out


def _channels(out: torch.Tensor) -> Output:
    if out.shape[1] == 1:
        return out[:, 0]
    return out[:, 0], out[:, 1], out[:, 2]


def image_bilinear_cuda(img: torch.Tensor, grad: torch.Tensor, loc: torch.Tensor,
                        channels: int = 3) -> Output:
    """K4: ``ops.image.image_bilinear_lk_plain`` on the card, in one launch
    of the select design.

    img [H, W], grad [H, W, 2] (read only with ``channels`` = 3), loc
    [N, S, 2] whole-image positions, one float dtype, contiguous, on one
    device, loc and grad aligned to a pair of their elements; H W and
    N S ``channels`` below 2^31. Returns, with ``channels`` = 3, (val, gx,
    gy), each [N, S]: the channel views of one [N, 3, S] output (K1's
    layout, which ``blur_rows`` reads as one run a keypoint); with 1, val
    [N, S]. 0 where the position lies off [0, W-1] x [0, H-1] or is NaN.
    """
    global LAUNCHES_IMAGE
    who = "image_bilinear_cuda"
    dtype, H, W, N, S, out = _checked(who, img, grad, loc, channels)
    _aligned(who, "loc", loc, 2 * loc.element_size())
    if H * W >= 2 ** 31 or N * S * channels >= 2 ** 31:
        raise ValueError(f"{who}: sizes exceed the kernel's 32-bit indexing")
    lay = select_layout(N, S)
    if N * S:
        LAUNCHES_IMAGE += _launch(
            _entry("image_bilinear", dtype), loc.device, img.data_ptr(),
            grad.data_ptr() if channels == 3 else None, loc.data_ptr(), out.data_ptr(), N, S,
            H, W, channels, lay.m, lay.k)
    return _channels(out)


def interleave_planes(img: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """The [H, W, 4] plane (value, d/dx, d/dy, 0) of
    :func:`image_bilinear_interleaved_cuda`, from img [H, W] and grad
    [H, W, 2]."""
    return torch.cat([img[..., None], grad, torch.zeros_like(img)[..., None]], dim=-1)


def image_bilinear_interleaved_cuda(plane: torch.Tensor, loc: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4 with C = 3 from one interleaved plane [H, W, 4]
    (:func:`interleave_planes`, 16-byte aligned), one 16-byte load a corner
    in float32; :func:`image_bilinear_cuda`'s bits. A timed row: the
    tracker does not build the plane."""
    global LAUNCHES_IMAGE_INTERLEAVED
    who = "image_bilinear_interleaved_cuda"
    H, W = plane.shape[:2] if plane.dim() == 3 else (None, None)
    N, S = loc.shape[:2] if loc.dim() == 3 else (None, None)
    dtype = _check(who, dict(plane=plane, loc=loc), dict(plane=(H, W, 4), loc=(N, S, 2)))
    _aligned(who, "plane", plane, 16)
    _aligned(who, "loc", loc, 2 * loc.element_size())
    if H * W * 4 >= 2 ** 31 or N * S * 3 >= 2 ** 31:
        raise ValueError(f"{who}: sizes exceed the kernel's 32-bit indexing")
    out = torch.empty((N, 3, S), dtype=dtype, device=loc.device)
    if N * S:
        m, k = sample_divisor(S)
        LAUNCHES_IMAGE_INTERLEAVED += _launch(
            _entry("image_bilinear_interleaved", dtype), loc.device, plane.data_ptr(),
            loc.data_ptr(), out.data_ptr(), N, S, H, W, m, k)
    return _channels(out)


def image_bilinear_branch_cuda(img: torch.Tensor, grad: torch.Tensor, loc: torch.Tensor,
                               channels: int = 3) -> Output:
    """K4's earlier design (its first: one thread a sample, 64-bit indices, a
    branch to 0 before the taps), with :func:`image_bilinear_cuda`'s
    arguments and bits; sizes up to 2^62 samples."""
    global LAUNCHES_IMAGE_BRANCH
    who = "image_bilinear_branch_cuda"
    dtype, H, W, N, S, out = _checked(who, img, grad, loc, channels)
    if H * W >= 2 ** 31 or N * S * channels >= 2 ** 62:
        raise ValueError(f"{who}: sizes exceed the kernel's indexing")
    if N * S:
        LAUNCHES_IMAGE_BRANCH += _launch(
            _entry("image_bilinear_branch", dtype), loc.device, img.data_ptr(),
            grad.data_ptr() if channels == 3 else None, loc.data_ptr(), out.data_ptr(), N, S,
            H, W, channels)
    return _channels(out)
