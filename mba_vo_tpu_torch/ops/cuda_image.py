"""Bind and launch the direct path's whole-image Lucas-Kanade sampler K4.

``csrc/image_bilinear.cu`` replaces the gather that XLA fuses into
``mba_vo_tpu/ops/residual.py::compute_residuals`` (``warp_and_sample`` ->
``sample_lk`` -> ``bilinear_sample``; no Pallas source).
:func:`image_bilinear_cuda` samples the keyframe image and, with C = 3, both
channels of its gradient image at N x S whole-image positions, one thread a
sample, reading the planes in place (no stacked copy). Its plain PyTorch
version is ``ops/image.py::image_bilinear_lk_plain``, which CPU tensors
take; ``ops/image.py::image_bilinear_lk`` chooses by the tensors' device and
nothing else. The library is built and loaded by ``ops/cuda_build.py`` at
first use; nothing here runs when the module is imported.

The wrapper takes CUDA tensors only and raises on anything else (device,
dtype, shape, contiguity, a gradient image whose pairs are not aligned for
one load); it never falls back to the plain version. ``LAUNCHES_IMAGE``
counts its launches, one a call; a call recorded into a CUDA graph is not a
launch and is not counted.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple, Union

import torch

from . import cuda_build
from .cuda_residual import _check, _launch

LAUNCHES_IMAGE = 0
_loaded: Dict[str, ctypes.CDLL] = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# img, grad, loc, out, N, S, H, W, C, stream
_SIGNATURE = [_P] * 4 + [_I] * 5 + [_P]


def _entry(dtype: torch.dtype):
    if "image_bilinear" not in _loaded:
        lib = cuda_build.load("image_bilinear")
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"image_bilinear_{suffix}")
            fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
        _loaded["image_bilinear"] = lib
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(_loaded["image_bilinear"], f"image_bilinear_{suffix}")


def image_bilinear_cuda(img: torch.Tensor, grad: torch.Tensor, loc: torch.Tensor,
                        channels: int = 3
                        ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """K4: ``ops.image.image_bilinear_lk_plain`` on the card, in one launch.

    img [H, W], grad [H, W, 2] (read only with ``channels`` = 3), loc
    [N, S, 2] whole-image positions, one float dtype, contiguous, on one
    device. Returns, with ``channels`` = 3, (val, gx, gy), each [N, S]: the
    channel views of one [N, 3, S] output (K1's layout, which ``blur_rows``
    reads as one run a keypoint); with 1, val [N, S]. 0 where the position
    lies off [0, W-1] x [0, H-1] or is NaN.
    """
    global LAUNCHES_IMAGE
    who = "image_bilinear_cuda"
    if channels not in (1, 3):
        raise ValueError(f"{who}: {channels} channels (1 or 3)")
    H, W = img.shape if img.dim() == 2 else (None, None)
    N, S = loc.shape[:2] if loc.dim() == 3 else (None, None)
    tensors, shapes = dict(img=img, loc=loc), dict(img=(H, W), loc=(N, S, 2))
    if channels == 3:
        tensors["grad"], shapes["grad"] = grad, (H, W, 2)
    dtype = _check(who, tensors, shapes)
    if channels == 3 and grad.data_ptr() % (2 * grad.element_size()):
        raise ValueError(f"{who}: grad's storage is not aligned to a pair of its elements")
    if H * W >= 2 ** 31 or N * S * channels >= 2 ** 62:
        raise ValueError(f"{who}: sizes exceed the kernel's indexing")
    out = torch.empty((N, channels, S), dtype=dtype, device=loc.device)
    if N * S:
        LAUNCHES_IMAGE += _launch(
            _entry(dtype), loc.device, img.data_ptr(),
            grad.data_ptr() if channels == 3 else None, loc.data_ptr(), out.data_ptr(), N, S,
            H, W, channels)
    if channels == 1:
        return out[:, 0]
    return out[:, 0], out[:, 1], out[:, 2]
