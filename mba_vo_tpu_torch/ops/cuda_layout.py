"""Bind and launch the patch layout K5.

``csrc/frame_layout.cu`` replaces the stage XLA fuses in
``mba_vo_tpu/ops/residual.py::prepare_frame_layout`` (no Pallas source): each
frame's mid-exposure pose from the spline knots, the keypoints' anchors
through it, the integer patch pixels, their validity and the observed
intensities, in one launch (a CTA a frame and a block of (keypoint, pattern
pixel) pairs). Every path of the tracker runs it once an LM evaluation.
Two designs, equal to the bit: :func:`frame_layout_cuda`, the staged design
the tracker launches (warps 0 and 1 stage the whole knot array into shared
memory in the same trip as every other input, :func:`layout_staging`), and
:func:`frame_layout_serial_cuda`, the earlier design (four dependent trips
to memory), which only the sweeps launch.
Its plain PyTorch version is ``ops/residual.py::prepare_frame_layout_plain``,
which CPU tensors take; ``ops/residual.py::prepare_frame_layout`` chooses by
the tensors' device and nothing else. The library is built and loaded by
``ops/cuda_build.py`` at first use; nothing here runs when the module is
imported.

The wrappers take CUDA tensors only and raise on anything else (device,
dtype, shape, contiguity, a spline degree other than 2 or 4, more knots than
the staged design stages); they never fall back to the plain version.
``LAUNCHES_LAYOUT`` counts the staged design's launches, one a call,
``LAUNCHES_LAYOUT_SERIAL`` the earlier design's; a call recorded into a
CUDA graph is not a launch and is not counted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, Tuple

import torch

from . import cuda_build
from .cuda_residual import _check, _launch

LAUNCHES_LAYOUT = 0
LAUNCHES_LAYOUT_SERIAL = 0
# the staged design: values a lane of warp 0 (the knots' 4 K rotation
# values) and of warp 1 (their 3 K translation values) loads in the one trip,
# hence the most knots a call may have (frame_layout.cu's kLoads, kMaxKnots)
LAYOUT_LOADS = 8
MAX_LAYOUT_KNOTS = 32 * LAYOUT_LOADS // 4
_loaded: Dict[str, ctypes.CDLL] = {}
_P, _I = ctypes.c_void_p, ctypes.c_int
# knot t, knot q, t0, dt, capture times, exposure times, kp_xy, kp_z,
# kp_mask, K, pattern, cur_imgs, pix, valid, obs, anchors, knots, degree, N,
# F, P, V, H, W, Hc, Wc, (the staged design: shared bytes), stream
_SIGNATURES = {"frame_layout": [_P] * 16 + [_I] * 10 + [ctypes.c_longlong, _P],
               "frame_layout_serial": [_P] * 16 + [_I] * 10 + [_P]}


@dataclasses.dataclass(frozen=True)
class LayoutStaging:
    """The staged design's shared memory for K knots (``frame_layout.cu``'s
    ``staged_smem_bytes`` computes the same bytes): the knots' rotations
    [K, 4] and translations [K, 3], the segments' exps (4 values for each of
    up to 3), the pose (7 values), rounded up to 16 bytes; and the values a
    lane of warp 0 (rotations) and of warp 1 (translations) loads."""
    loads_q: int
    loads_t: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def layout_staging(K: int, itemsize: int) -> LayoutStaging:
    """The staged design's staging of K knots of ``itemsize``-byte floats;
    raises past :data:`MAX_LAYOUT_KNOTS`."""
    if not 1 <= K <= MAX_LAYOUT_KNOTS:
        raise ValueError(f"frame_layout: {K} knots; the staged design stages at most "
                         f"MAX_LAYOUT_KNOTS = {MAX_LAYOUT_KNOTS}")
    smem = -(-((7 * K + 12 + 7) * itemsize) // 16) * 16
    return LayoutStaging(-(-4 * K // 32), -(-3 * K // 32), smem)


def _entry(design: str, dtype: torch.dtype):
    if "frame_layout" not in _loaded:
        lib = cuda_build.load("frame_layout")
        for name, signature in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{name}_{suffix}")
                fn.argtypes, fn.restype = signature, ctypes.c_int
        query = lib.frame_layout_max_knots
        query.argtypes, query.restype = [], ctypes.c_int
        if query() != MAX_LAYOUT_KNOTS:
            raise RuntimeError(f"frame_layout.cu stages at most {query()} knots, not "
                               f"{MAX_LAYOUT_KNOTS}")
        _loaded["frame_layout"] = lib
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(_loaded["frame_layout"], f"{design}_{suffix}")


def _layout_call(who, knots, cap_times, exp_times, num_vir, degree, kp_xy, kp_z, kp_mask, K,
                 pattern, cur_imgs, height, width, anchors):
    """Both designs' checks; returns (dtype, knots, keypoints, the outputs
    (pix, valid, obs, anchors or None), the pointer and size arguments both
    designs' launches begin with)."""
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
    args = tuple(x.data_ptr() for x in (
        knots.t, knots.q, knots.t0, knots.dt, cap_times, exp_times, kp_xy, kp_z, kp_mask, K,
        pattern, cur_imgs, pix, valid, obs)) + (
        None if anc is None else anc.data_ptr(), Kn, degree, N, F, P, V, int(height),
        int(width), Hc, Wc)
    return dtype, Kn, N, (pix, valid, obs, anc), args


def _result(outs, anchors):
    pix, valid, obs, anc = outs
    return (pix, valid, obs) + ((anc,) if anchors else ())


def frame_layout_cuda(knots, cap_times: torch.Tensor, exp_times: torch.Tensor, num_vir: int,
                      degree: int, kp_xy: torch.Tensor, kp_z: torch.Tensor,
                      kp_mask: torch.Tensor, K: torch.Tensor, pattern: torch.Tensor,
                      cur_imgs: torch.Tensor, height: int, width: int,
                      anchors: bool = False) -> Tuple[torch.Tensor, ...]:
    """K5: ``ops.residual.prepare_frame_layout_plain`` on the card, in one
    launch of the staged design (:func:`layout_staging`).

    knots: a ``core.spline.SplineKnots`` (t [K, 3], q [K, 4], 0-dim t0 and
    dt); cap_times and exp_times [F]; kp_xy [N, 2], kp_z [N], kp_mask [N],
    K [4], cur_imgs [F, Hc, Wc] (float, one dtype), pattern [P, 2] int32,
    all contiguous on one device; ``degree`` 2 or 4, at most
    :data:`MAX_LAYOUT_KNOTS` knots; ``height`` and ``width`` the keyframe
    level's (the in-image test). Returns (pix [F, N, P, 2] in the float
    dtype, valid [F, N, P] bool, obs [F, N, P]), and with ``anchors`` the
    keypoints' anchors [F, N, 2] last.
    """
    global LAUNCHES_LAYOUT
    who = "frame_layout_cuda"
    dtype, Kn, N, outs, args = _layout_call(
        who, knots, cap_times, exp_times, num_vir, degree, kp_xy, kp_z, kp_mask, K, pattern,
        cur_imgs, height, width, anchors)
    staging = layout_staging(Kn, outs[0].element_size())
    if N:
        LAUNCHES_LAYOUT += _launch(_entry("frame_layout", dtype), kp_z.device, *args,
                                   staging.smem_bytes)
    return _result(outs, anchors)


def frame_layout_serial_cuda(knots, cap_times: torch.Tensor, exp_times: torch.Tensor,
                             num_vir: int, degree: int, kp_xy: torch.Tensor, kp_z: torch.Tensor,
                             kp_mask: torch.Tensor, K: torch.Tensor, pattern: torch.Tensor,
                             cur_imgs: torch.Tensor, height: int, width: int,
                             anchors: bool = False) -> Tuple[torch.Tensor, ...]:
    """K5's earlier design (its first: the segment found before its knots are
    loaded, the chain in one thread, four dependent trips to memory), with
    :func:`frame_layout_cuda`'s arguments and bits; any number of knots."""
    global LAUNCHES_LAYOUT_SERIAL
    dtype, _, N, outs, args = _layout_call(
        "frame_layout_serial_cuda", knots, cap_times, exp_times, num_vir, degree, kp_xy, kp_z,
        kp_mask, K, pattern, cur_imgs, height, width, anchors)
    if N:
        LAUNCHES_LAYOUT_SERIAL += _launch(_entry("frame_layout_serial", dtype), kp_z.device,
                                          *args)
    return _result(outs, anchors)
