"""Bind and launch the residual/Jacobian rows K2 and the Huber normal
equations K3.

Two CUDA sources under ``mba_vo_tpu_torch/csrc/``, which replace the two
stages XLA fuses in ``mba_vo_tpu/ops/residual.py`` (they have no Pallas
source):

  * ``residual_rows.cu`` (K2), two entry points around the sampler K1:
    :func:`warp_tangents_cuda` warps every (n, f, p, v) sample into the
    keyframe with its derivative along the knot tangents, and
    :func:`blur_rows_cuda` averages K1's samples over the virtual poses into
    the residual and its Jacobian row;
  * ``normal_equations.cu`` (K3): :func:`normal_equations_cuda`, the Huber
    cost, the unmasked patch costs, g and H (optionally Kahan-combined over
    16 chunks of rows), in two launches with no atomics.

Each has its plain PyTorch version in ``ops/residual.py``
(``warp_tangents_plain``, ``blur_rows_plain``, ``normal_equations_plain``),
which CPU tensors take; ``ops/residual.py`` chooses by the tensors' device
and nothing else. The libraries are built and loaded by
``ops/cuda_build.py`` at first use; nothing here runs when the module is
imported.

The wrappers take CUDA tensors only and raise on anything else (device,
dtype, shape, contiguity, more than :data:`MAX_TANGENTS` knot tangents);
none falls back to the plain version. ``LAUNCHES_WARP``, ``LAUNCHES_BLUR``
and ``LAUNCHES_NORMAL`` count the kernels each wrapper launched (a call of
K3 launches two, the partials and their combination); a call recorded into
a CUDA graph is not a launch and is not counted.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build

LAUNCHES_WARP = 0
LAUNCHES_BLUR = 0
LAUNCHES_NORMAL = 0
# the most knot tangents (6K) a launch of K2 or K3 may take, compiled into
# both sources (-DMAX_TANGENTS): K3 keeps its share of the 8,384 entries of
# H and g at this size in registers. 6K = 66 at a joint chunk of 8 at
# degree 4; 128 leaves room for chunks up to 16 (degree 4) and 19 (degree 2)
MAX_TANGENTS = 128
# the chunks of normal_equations.cu's rows (the reference's compensated
# sum's) and its stage-1 blocks, whose partials go to a scratch buffer
CHUNKS = 16
BLOCKS = 128

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # pose_t, pose_q, dpose, kp_z, K, pix, starts, loc, vs, dxy,
    # N, F, P, V, D, H, W, stream
    "warp_tangents": [_P] * 10 + [_I] * 7 + [_P],
    # val, gx, gy, row_stride, dxy, obs, valid, r, J, N, F, P, V, D, affine, stream
    "blur_rows": [_P] * 3 + [_L] + [_P] * 5 + [_I] * 6 + [_P],
    # r, J, kp_w, partials, cost, patch, g, H, F, N, P, D, huber_a, compensated, stream
    "normal_equations": [_P] * 8 + [_I] * 4 + [ctypes.c_double, _I, _P],
}
_LIBRARY = {"warp_tangents": "residual_rows", "blur_rows": "residual_rows",
            "normal_equations": "normal_equations"}
_loaded: Dict[str, ctypes.CDLL] = {}


def launch_counts() -> Dict[str, int]:
    """The launch counters, by the name of the kernel's entry point."""
    return {"warp_tangents": LAUNCHES_WARP, "blur_rows": LAUNCHES_BLUR,
            "normal_equations": LAUNCHES_NORMAL}


def zero_launch_counts() -> None:
    global LAUNCHES_WARP, LAUNCHES_BLUR, LAUNCHES_NORMAL
    LAUNCHES_WARP = LAUNCHES_BLUR = LAUNCHES_NORMAL = 0


def _entry(kernel: str, dtype: torch.dtype):
    name = _LIBRARY[kernel]
    if name not in _loaded:
        lib = cuda_build.load(name)
        for k, lib_name in _LIBRARY.items():
            if lib_name != name:
                continue
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{k}_{suffix}")
                fn.argtypes = _SIGNATURES[k]
                fn.restype = ctypes.c_int
        queries = [(f"{name}_max_tangents", MAX_TANGENTS)]
        if name == "normal_equations":
            queries += [("normal_equations_chunks", CHUNKS), ("normal_equations_blocks", BLOCKS)]
        for query, expected in queries:
            fn = getattr(lib, query)
            fn.argtypes, fn.restype = [], ctypes.c_int
            if fn() != expected:
                raise RuntimeError(f"{name}.cu was built with {query} = {fn()}, "
                                   f"not {expected}")
        _loaded[name] = lib
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(_loaded[name], f"{kernel}_{suffix}")


def _check(who: str, tensors: Dict[str, torch.Tensor], shapes: Dict[str, tuple],
           int_names=()) -> torch.dtype:
    """Device, dtype, contiguity and shape checks; returns the float dtype.
    ``shapes`` gives each tensor's expected shape (None: any size there)."""
    first = next(iter(tensors.values()))
    dtype = None
    for name, x in tensors.items():
        if not x.is_cuda:
            raise ValueError(f"{who}: {name} is on {x.device}, not CUDA")
        if x.device != first.device:
            raise ValueError(f"{who}: {name} is on {x.device}, the others on {first.device}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")
        if name in int_names:
            if x.dtype != torch.int64:
                raise ValueError(f"{who}: {name} is {x.dtype}, not torch.int64")
        elif name == "valid":
            if x.dtype != torch.bool:
                raise ValueError(f"{who}: {name} is {x.dtype}, not torch.bool")
        elif dtype is None:
            dtype = x.dtype
        elif x.dtype != dtype:
            raise ValueError(f"{who}: {name} is {x.dtype}, the others {dtype}")
        want = shapes[name]
        if x.dim() != len(want) or any(w is not None and s != w
                                       for s, w in zip(x.shape, want)):
            raise ValueError(f"{who}: {name} must be {list(want)} (None: any), "
                             f"got {list(x.shape)}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{who}: unsupported dtype {dtype}")
    return dtype


def _tangents(who: str, D: int):
    if D > MAX_TANGENTS:
        raise ValueError(f"{who}: {D} knot tangents; the kernels were built for at most "
                         f"MAX_TANGENTS = {MAX_TANGENTS}")


def _launch(fn, device: torch.device, *args) -> int:
    """Launch on the current stream; returns the launches made: 1, or 0 when
    the stream is capturing a CUDA graph, where the call is only recorded."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        recorded = torch.cuda.is_current_stream_capturing()
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err}")
    return 0 if recorded else 1


def warp_tangents_cuda(pose_t: torch.Tensor, pose_q: torch.Tensor, dpose: torch.Tensor,
                       kp_z: torch.Tensor, K: torch.Tensor, pix: torch.Tensor,
                       starts: torch.Tensor, height: int,
                       width: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's first entry: ``ops.residual.warp_tangents_plain`` on the card.

    pose_t [F, V, 3], pose_q [F, V, 4], dpose [D, F, V, 7], kp_z [N], K [4],
    pix [F, N, P, 2] (float, one dtype), starts [N, 2] int64, all
    contiguous on one device. Returns (loc [N, S, 2], vs [N, S],
    dxy [2, D, N, S]) with S = F P V in (f, p, v) order.
    """
    global LAUNCHES_WARP
    who = "warp_tangents_cuda"
    F, V = pose_t.shape[:2] if pose_t.dim() == 3 else (None, None)
    N = kp_z.shape[0] if kp_z.dim() == 1 else None
    dtype = _check(who, dict(pose_t=pose_t, pose_q=pose_q, dpose=dpose, kp_z=kp_z, K=K,
                             pix=pix, starts=starts),
                   dict(pose_t=(F, V, 3), pose_q=(F, V, 4), dpose=(None, F, V, 7),
                        kp_z=(N,), K=(4,), pix=(F, N, None, 2), starts=(N, 2)),
                   int_names=("starts",))
    D, P = dpose.shape[0], pix.shape[2]
    _tangents(who, D)
    S = F * P * V
    if N * S >= 2 ** 31:
        raise ValueError(f"{who}: sizes exceed the kernel's indexing")
    opts = dict(dtype=dtype, device=pix.device)
    loc = torch.empty((N, S, 2), **opts)
    vs = torch.empty((N, S), **opts)
    dxy = torch.empty((2, D, N, S), **opts)
    if N * S:
        LAUNCHES_WARP += _launch(
            _entry("warp_tangents", dtype), pix.device, pose_t.data_ptr(), pose_q.data_ptr(),
            dpose.data_ptr(), kp_z.data_ptr(), K.data_ptr(), pix.data_ptr(),
            starts.data_ptr(), loc.data_ptr(), vs.data_ptr(), dxy.data_ptr(),
            N, F, P, V, D, int(height), int(width))
    return loc, vs, dxy


def blur_rows_cuda(val: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                   dxy: torch.Tensor, obs: torch.Tensor, valid: torch.Tensor,
                   num_vir: int, affine: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's second entry: ``ops.residual.blur_rows_plain`` on the card.

    val, gx, gy [N, S]: K1's samples, each with unit stride along S and one
    keypoint stride for all three (the channel views of K1's [N, 3, S]
    output are read in place); dxy [2, D, N, S], obs [F, N, P] and the bool
    patch-pixel mask ``valid`` [F, N, P], contiguous. Returns [F, N, P] and
    [F, N, P, D], contiguous: (r, J), masked by ``valid``; with ``affine``
    (pred, dpred), unmasked, for the gain/bias elimination.
    """
    global LAUNCHES_BLUR
    who = "blur_rows_cuda"
    F, N, P = obs.shape if obs.dim() == 3 else (None, None, None)
    dtype = _check(who, dict(dxy=dxy, obs=obs, valid=valid),
                   dict(dxy=(2, None, N, None), obs=(F, N, P), valid=(F, N, P)))
    V = int(num_vir)
    S = F * P * V
    for name, x in (("val", val), ("gx", gx), ("gy", gy)):
        if not x.is_cuda or x.device != obs.device or x.dtype != dtype:
            raise ValueError(f"{who}: {name} must be a {dtype} tensor on {obs.device}, "
                             f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != (N, S) or x.stride(1) != 1 or x.stride(0) != val.stride(0):
            raise ValueError(f"{who}: {name} must be [{N}, {S}] with unit stride along S "
                             f"and val's keypoint stride, got {list(x.shape)}, strides "
                             f"{x.stride()}")
    if dxy.shape[3] != S:
        raise ValueError(f"{who}: dxy must be [2, D, {N}, {S}], got {list(dxy.shape)}")
    D = dxy.shape[1]
    _tangents(who, D)
    if N * S >= 2 ** 31:
        raise ValueError(f"{who}: sizes exceed the kernel's indexing")
    opts = dict(dtype=dtype, device=obs.device)
    r = torch.empty((F, N, P), **opts)
    J = torch.empty((F, N, P, D), **opts)
    if r.numel():
        LAUNCHES_BLUR += _launch(
            _entry("blur_rows", dtype), obs.device, val.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), val.stride(0), dxy.data_ptr(), obs.data_ptr(), valid.data_ptr(),
            r.data_ptr(), J.data_ptr(), N, F, P, V, D, int(bool(affine)))
    return r, J


def normal_equations_cuda(
    r: torch.Tensor, J: Optional[torch.Tensor], kp_w: torch.Tensor, huber_a: float,
    compensated: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K3: ``ops.residual.normal_equations_plain`` on the card.

    r [F, N, P], J [F, N, P, D] or None (cost only), kp_w [N], one dtype,
    contiguous. Returns the raw per-rank sums (cost, patch [F, N], g [D],
    H [D, D]), g and H None without J. A run repeats bit for bit.
    """
    global LAUNCHES_NORMAL
    who = "normal_equations_cuda"
    F, N, P = r.shape if r.dim() == 3 else (None, None, None)
    tensors = dict(r=r, kp_w=kp_w)
    shapes = dict(r=(F, N, P), kp_w=(N,))
    if J is not None:
        tensors["J"], shapes["J"] = J, (F, N, P, None)
    dtype = _check(who, tensors, shapes)
    D = 0 if J is None else J.shape[-1]
    _tangents(who, D)
    if r.numel() * max(D, 1) >= 2 ** 62:
        raise ValueError(f"{who}: sizes exceed the kernel's indexing")
    E = (D + 1) * (D + 2) // 2 - 1 if D else 0
    opts = dict(dtype=dtype, device=r.device)
    part = torch.empty((BLOCKS, 1 + E), **opts)
    cost = torch.empty((), **opts)
    patch = torch.empty((F, N), **opts)
    g = torch.empty((D,), **opts)
    H = torch.empty((D, D), **opts)
    # two kernels: the per-block partials, then their combination
    LAUNCHES_NORMAL += 2 * _launch(
        _entry("normal_equations", dtype), r.device, r.data_ptr(),
        J.data_ptr() if J is not None else None, kp_w.data_ptr(), part.data_ptr(),
        cost.data_ptr(), patch.data_ptr(), g.data_ptr(), H.data_ptr(), F, N, P, D,
        float(huber_a), int(bool(compensated)))
    if J is None:
        return cost, patch, None, None
    return cost, patch, g, H
