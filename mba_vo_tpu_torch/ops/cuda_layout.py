"""Bind and launch the patch layout K5.

``csrc/frame_layout.cu`` replaces the stage XLA fuses in
``mba_vo_tpu/ops/residual.py::prepare_frame_layout`` (no Pallas source): each
frame's mid-exposure pose from the spline knots, the keypoints' anchors
through it, the integer patch pixels, their validity and the observed
intensities, in one launch (a CTA a frame and a block of (keypoint, pattern
pixel) pairs). Every path of the tracker runs it once an LM evaluation.
Its plain PyTorch version is ``ops/residual.py::prepare_frame_layout_plain``,
which CPU tensors take; ``ops/residual.py::prepare_frame_layout`` chooses by
the tensors' device and nothing else. The library is built and loaded by
``ops/cuda_build.py`` at first use; nothing here runs when the module is
imported.

The wrapper takes CUDA tensors only and raises on anything else (device,
dtype, shape, contiguity, a spline degree other than 2 or 4); it never falls
back to the plain version. ``LAUNCHES_LAYOUT`` counts its launches, one a
call; a call recorded into a CUDA graph is not a launch and is not counted.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import cuda_build
from .cuda_residual import _check, _launch

LAUNCHES_LAYOUT = 0
_loaded: Dict[str, ctypes.CDLL] = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# knot t, knot q, t0, dt, capture times, exposure times, kp_xy, kp_z,
# kp_mask, K, pattern, cur_imgs, pix, valid, obs, anchors, knots, degree, N,
# F, P, V, H, W, Hc, Wc, stream
_SIGNATURE = [_P] * 16 + [_I] * 10 + [_P]


def _entry(dtype: torch.dtype):
    if "frame_layout" not in _loaded:
        lib = cuda_build.load("frame_layout")
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"frame_layout_{suffix}")
            fn.argtypes, fn.restype = _SIGNATURE, ctypes.c_int
        _loaded["frame_layout"] = lib
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(_loaded["frame_layout"], f"frame_layout_{suffix}")


def frame_layout_cuda(knots, cap_times: torch.Tensor, exp_times: torch.Tensor, num_vir: int,
                      degree: int, kp_xy: torch.Tensor, kp_z: torch.Tensor,
                      kp_mask: torch.Tensor, K: torch.Tensor, pattern: torch.Tensor,
                      cur_imgs: torch.Tensor, height: int, width: int,
                      anchors: bool = False) -> Tuple[torch.Tensor, ...]:
    """K5: ``ops.residual.prepare_frame_layout_plain`` on the card, in one
    launch.

    knots: a ``core.spline.SplineKnots`` (t [K, 3], q [K, 4], 0-dim t0 and
    dt); cap_times and exp_times [F]; kp_xy [N, 2], kp_z [N], kp_mask [N],
    K [4], cur_imgs [F, Hc, Wc] (float, one dtype), pattern [P, 2] int32,
    all contiguous on one device; ``degree`` 2 or 4; ``height`` and
    ``width`` the keyframe level's (the in-image test). Returns (pix
    [F, N, P, 2] in the float dtype, valid [F, N, P] bool, obs [F, N, P]),
    and with ``anchors`` the keypoints' anchors [F, N, 2] last.
    """
    global LAUNCHES_LAYOUT
    who = "frame_layout_cuda"
    Kn = knots.t.shape[0] if knots.t.dim() == 2 else None
    F = cap_times.shape[0] if cap_times.dim() == 1 else None
    N = kp_z.shape[0] if kp_z.dim() == 1 else None
    dtype = _check(who, dict(knot_t=knots.t, knot_q=knots.q, t0=knots.t0, dt=knots.dt,
                             cap_times=cap_times, exp_times=exp_times, kp_xy=kp_xy, kp_z=kp_z,
                             kp_mask=kp_mask, K=K, cur_imgs=cur_imgs),
                   dict(knot_t=(Kn, 3), knot_q=(Kn, 4), t0=(), dt=(), cap_times=(F,),
                        exp_times=(F,), kp_xy=(N, 2), kp_z=(N,), kp_mask=(N,), K=(4,),
                        cur_imgs=(F, None, None)))
    if (not pattern.is_cuda or pattern.device != kp_z.device or pattern.dtype != torch.int32
            or pattern.dim() != 2 or pattern.shape[1] != 2 or not pattern.is_contiguous()):
        raise ValueError(f"{who}: pattern must be a contiguous [P, 2] torch.int32 tensor on "
                         f"{kp_z.device}, got {list(pattern.shape)} {pattern.dtype} on "
                         f"{pattern.device}")
    if degree not in (2, 4) or Kn < degree:
        raise ValueError(f"{who}: spline degree {degree} over {Kn} knots (2 or 4, at most "
                         f"the knots)")
    V, P = int(num_vir), pattern.shape[0]
    if V < 1 or P < 1 or F < 1 or F > 65535:
        raise ValueError(f"{who}: {V} virtual poses, {P} pattern pixels, {F} frames")
    Hc, Wc = cur_imgs.shape[1:]
    if N * P >= 2 ** 31 or F * Hc * Wc >= 2 ** 62:
        raise ValueError(f"{who}: sizes exceed the kernel's indexing")
    opts = dict(dtype=dtype, device=kp_z.device)
    pix = torch.empty((F, N, P, 2), **opts)
    valid = torch.empty((F, N, P), dtype=torch.bool, device=kp_z.device)
    obs = torch.empty((F, N, P), **opts)
    anc = torch.empty((F, N, 2), **opts) if anchors else None
    if N:
        LAUNCHES_LAYOUT += _launch(
            _entry(dtype), kp_z.device, *(x.data_ptr() for x in (
                knots.t, knots.q, knots.t0, knots.dt, cap_times, exp_times, kp_xy, kp_z,
                kp_mask, K, pattern, cur_imgs, pix, valid, obs)),
            None if anc is None else anc.data_ptr(), Kn, degree, N, F, P, V, int(height),
            int(width), Hc, Wc)
    return (pix, valid, obs) + ((anc,) if anchors else ())
