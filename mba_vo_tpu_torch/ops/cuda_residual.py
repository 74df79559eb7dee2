"""Bind and launch the residual/Jacobian rows K2 and the Huber normal
equations K3.

Two CUDA sources under ``mba_vo_tpu_torch/csrc/``, which replace the two
stages XLA fuses in ``mba_vo_tpu/ops/residual.py`` (they have no Pallas
source):

  * ``residual_rows.cu`` (K2), two entry points around the sampler K1:
    :func:`warp_tangents_cuda` goes from the spline knots to every (n, f,
    p, v) sample warped into the keyframe with its derivative along the
    knot tangents (the virtual poses and their tangents computed in the
    same launch, kp keypoints of one frame a CTA), and
    :func:`blur_rows_cuda` averages K1's samples over the virtual poses into
    the residual and its Jacobian row (one CTA a keypoint, its operands
    brought in by bulk copies);
  * ``normal_equations.cu`` (K3): :func:`normal_equations_cuda`, the Huber
    cost, the unmasked patch costs, g and H (optionally Kahan-combined over
    16 chunks of rows), in one launch of a 16-CTA thread-block cluster, no
    atomics.

The earlier design of each, which the tracker no longer launches, stays
launchable for the sweeps: :func:`warp_tangents_threads_cuda` (one thread a
sample, from poses and pose tangents that torch computes), and, equal to
the new designs bit for bit, :func:`blur_rows_threads_cuda` (one thread a
row) and :func:`normal_equations_split_cuda` (two launches: partials, then
their combination). The launch geometry of the new designs is plain Python
(:func:`warp_tangents_layout`, :func:`blur_rows_layout`,
:func:`normal_equations_layout`, :func:`normal_equations_rows`), which the
kernels check against their own.

Each has its plain PyTorch version in ``ops/residual.py``
(``warp_tangents_plain``, ``warp_tangents_threads_plain``,
``blur_rows_plain``, ``normal_equations_plain``), which CPU tensors take;
``ops/residual.py`` chooses by the tensors' device and nothing else. The
libraries are built and loaded by ``ops/cuda_build.py`` at first use;
nothing here runs when the module is imported.

The wrappers take CUDA tensors only and raise on anything else (device,
dtype, shape, contiguity, more than :data:`MAX_TANGENTS` knot tangents);
none falls back to the plain version. ``LAUNCHES_WARP``, ``LAUNCHES_BLUR``
and ``LAUNCHES_NORMAL`` count the kernels each wrapper launched, one a
call; ``LAUNCHES_WARP_THREADS``, ``LAUNCHES_BLUR_THREADS`` and
``LAUNCHES_NORMAL_SPLIT`` those of the earlier designs (two a call of the
split design). A call recorded into a CUDA graph is not a launch and is not
counted.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import torch

from . import cuda_build

LAUNCHES_WARP = 0
LAUNCHES_BLUR = 0
LAUNCHES_NORMAL = 0
LAUNCHES_WARP_THREADS = 0
LAUNCHES_BLUR_THREADS = 0
LAUNCHES_NORMAL_SPLIT = 0
# the most knot tangents (6K) a launch of K2 or K3 may take, compiled into
# both sources (-DMAX_TANGENTS): K3 keeps its share of the 8,384 entries of
# H and g at this size in registers. 6K = 66 at a joint chunk of 8 at
# degree 4; 128 leaves room for chunks up to 16 (degree 4) and 19 (degree 2)
MAX_TANGENTS = 128
# the chunks of normal_equations.cu's rows (the reference's compensated
# sum's), the parts of a chunk and the rows of a tile: the order of every
# sum of K3's two designs
CHUNKS = 16
SPLIT = 8
TILE_ROWS = 32
# the split design's stage-1 blocks, whose partials go to a scratch buffer
BLOCKS = CHUNKS * SPLIT
# the cluster design: CTAs of CLUSTER_THREADS threads (PART_THREADS where a
# CTA takes one part), each thread owning BLOCK x BLOCK entries of a part
CLUSTER_THREADS = 512
PART_THREADS = 256
BLOCK = 4
# shared memory a block may use on the card (227 KB)
MAX_SHARED_BYTES = 232448
# K3's cluster design stages kp_w in shared memory up to KW_STAGE_BYTES
KW_STAGE_BYTES = 16 * 1024
# blur_rows' keypoint design: a keypoint's whole slab of runs stays in one
# stage up to BLUR_SLAB_BYTES; past it the tangents stream in tiles of up
# to BLUR_TILE, two stages deep
BLUR_SLAB_BYTES = 48 * 1024
BLUR_TILE = 8
# warp_tangents' knots design: a CTA of WARP_THREADS threads takes blocks of
# as many keypoints of one frame as make at most WARP_SAMPLES samples (at
# least one keypoint, at most WARP_THREADS samples); a pose keeps WARP_JOBS
# rotation tangents (the zero seed and 3 axes of 4 knots)
WARP_THREADS = 256
WARP_SAMPLES = 256
WARP_JOBS = 13


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _slot(nbytes: int) -> int:
    """Shared memory a bulk copy of ``nbytes`` takes, whatever its alignment
    (``bulk_copy.cuh``'s ``slot_bytes``)."""
    return _round16(nbytes) + 16


def _span(nbytes: int) -> int:
    """blur_rows' span: a bulk copy's slot for ``nbytes`` (:func:`_slot`),
    16 bytes past a multiple of 128 (its tangents' spans start on banks 4
    words apart)."""
    b = _slot(nbytes)
    return b + (16 - b % 128) % 128


def _blur_threads(rows: int, tile: int) -> int:
    """Threads of a CTA of blur_rows' keypoint design: a warp a block of
    32 / WD rows x WD tangents (WD = 8 where the tile is a multiple of 8,
    else 4), at most 1024."""
    wd = 8 if tile % 8 == 0 else 4
    blocks = -(-rows // (32 // wd)) * -(-tile // wd)
    return min(1024, 32 * blocks)


@dataclasses.dataclass(frozen=True)
class BlurRowsLayout:
    """Launch geometry of blur_rows' keypoint design (``residual_rows.cu``'s
    ``blur_layout`` computes the same bytes), a CTA a keypoint: the tangent
    tile and its stages, threads a CTA, and the dynamic shared memory: 2
    mbarriers, a table of the F P rows' rows of r and J (8 bytes a row), 3
    sample spans and ``stages`` x 2 x ``tile`` tangent spans, a span holding
    a run of S = F P V samples (:func:`_span`)."""
    tile: int
    stages: int
    threads: int
    span_bytes: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def blur_rows_layout(F: int, P: int, V: int, D: int, itemsize: int) -> BlurRowsLayout:
    """The keypoint design's geometry. The tangent tile: all D in one stage
    where a keypoint's whole slab fits BLUR_SLAB_BYTES, else the widest of
    BLUR_TILE, ..., 2, 1 whose two stages fit it (or, failing that, fit a
    block's shared memory)."""
    span = _span(F * P * V * itemsize)

    def smem(width, stages):
        return 16 + _round16(F * P * 8) + (3 + stages * 2 * width) * span

    fits = [w for w in (32, 16, 8, 4, 2, 1) if w < D and w <= BLUR_TILE]
    if smem(max(D, 1), 1) <= BLUR_SLAB_BYTES or not fits:
        tile = max(D, 1)
    else:
        tile = next((w for w in fits if smem(w, 2) <= BLUR_SLAB_BYTES),
                    next((w for w in fits if smem(w, 2) <= MAX_SHARED_BYTES), 1))
    stages = 2 if D > tile else 1
    if smem(tile, stages) > MAX_SHARED_BYTES:
        raise ValueError(f"blur_rows: a keypoint of S = {F * P * V} samples of {itemsize} "
                         f"bytes needs {smem(tile, stages)} B of shared memory a CTA, more "
                         f"than {MAX_SHARED_BYTES}")
    return BlurRowsLayout(tile, stages, _blur_threads(F * P, tile), span, smem(tile, stages))


@dataclasses.dataclass(frozen=True)
class WarpTangentsLayout:
    """Launch geometry of warp_tangents' knots design (``residual_rows.cu``'s
    ``knots_smem_bytes`` computes the same bytes): blocks of ``keypoints``
    of one frame, their ``samples`` (keypoints x P V), ``groups`` of threads
    a block (WARP_THREADS // samples, each thread a sample and every
    groups-th tangent), and the dynamic shared memory: the poses' D
    tangents (7 values and a pad each), the frame's V poses (7 values
    each), each pose's segment (4 basis weights and its first knot), its
    WARP_JOBS rotation tangents (4 values each) and each job's exps of its 3
    segments and their tangents (8 values each)."""
    keypoints: int
    samples: int
    groups: int
    smem_bytes: int


@functools.lru_cache(maxsize=256)
def warp_tangents_layout(P: int, V: int, D: int, itemsize: int) -> WarpTangentsLayout:
    """The knots design's geometry for P patch pixels, V virtual poses and D
    knot tangents; raises where a keypoint's P V samples outnumber a CTA's
    threads or the poses' tables a block's shared memory."""
    kp = max(1, WARP_SAMPLES // (P * V))
    samples = kp * P * V
    smem = (8 * V * D + 7 * V + 5 * V + 28 * WARP_JOBS * V) * itemsize
    if samples > WARP_THREADS or smem > MAX_SHARED_BYTES:
        raise ValueError(f"warp_tangents: {P} x {V} samples a keypoint (at most "
                         f"{WARP_THREADS}) and {V} poses x {D} knot tangents of {itemsize} "
                         f"bytes ({smem} B of shared memory a CTA, at most "
                         f"{MAX_SHARED_BYTES})")
    return WarpTangentsLayout(kp, samples, WARP_THREADS // samples, smem)


@dataclasses.dataclass(frozen=True)
class NormalEquationsLayout:
    """Launch geometry of K3's cluster design (``normal_equations.cu``'s
    ``cluster_layout`` computes the same bytes): ``per_chunk`` CTAs a chunk
    (1: one cluster of the 16 chunks' CTAs; 8: 16 clusters of a CTA a
    part); a round of ``parts_a_round`` parts at once, a step of
    ``tiles_a_step`` 32-row tiles of each, ``stages`` copy stages; ``items``
    blocks a thread owns, ``threads`` a CTA, CTAs a ``cluster``, whether
    kp_w is staged in shared memory, the dynamic shared memory a CTA, and
    the scratch elements of the chunk sums of the 8-CTA layout
    (``chunk_scratch``)."""
    per_chunk: int
    parts_a_round: int
    tiles_a_step: int
    stages: int
    items: int
    threads: int
    cluster: int
    kw_staged: bool
    smem_bytes: int
    chunk_scratch: int


def _cluster_smem(D: int, G: int, TS: int, stages: int, itemsize: int, kw: int = 0) -> int:
    """``cluster_layout``'s total bytes."""
    dpad = -(-(D + 1) // BLOCK) * BLOCK
    E = (D + 1) * (D + 2) // 2 - 1 if D else 0
    nb = dpad // BLOCK
    nblk = nb * (nb + 1) // 2 if D else 0
    units = G * TS
    rows = units * TILE_ROWS
    stage = G * (_slot(TS * TILE_ROWS * D * itemsize) + _slot(TS * TILE_ROWS * itemsize))
    nbytes = (16 + stages * stage + rows * dpad * itemsize + 3 * rows * itemsize
              + _round16(SPLIT * itemsize) + _round16(units * 16) + _round16(nblk * 4))
    staged = units if units > 1 else 0      # tile sums, then the parts' sums
    nbytes += staged * nblk * BLOCK * BLOCK * itemsize + (_slot(kw * itemsize) if kw else 0)
    return _round16(nbytes + (1 + E) * itemsize)


# K3's cluster design runs one cluster of the 16 chunks' CTAs up to
# CLUSTER_ROWS rows, else a CTA a part
CLUSTER_ROWS = 8192


def normal_equations_layout(D: int, itemsize: int, N: int = 0,
                            M: int = 0) -> NormalEquationsLayout:
    """K3's geometry for D tangents, ``itemsize``-byte floats, N keypoints
    and M rows: one cluster of the 16 chunks' CTAs up to CLUSTER_ROWS rows,
    else 16 clusters of a CTA a part (:func:`_cluster_layout`)."""
    return _cluster_layout(D, itemsize, N, M, 1 if M <= CLUSTER_ROWS else SPLIT)


@functools.lru_cache(maxsize=256)
def _cluster_layout(D: int, itemsize: int, N: int, M: int,
                    per_chunk: int) -> NormalEquationsLayout:
    """K3's geometry with ``per_chunk`` CTAs a chunk (1 or 8; the layout
    sweep of ``experiments/residual_kernels.py`` takes both at any M). A
    round takes the most parts whose whole rows one step covers (two copies
    a step), failing that the most parts and tiles that fit; two stages
    where a CTA takes more than one step."""
    if per_chunk not in (1, SPLIT):
        raise ValueError(f"normal_equations: {per_chunk} CTAs a chunk (1 or {SPLIT})")
    nb = -(-(D + 1) // BLOCK)
    blocks = nb * (nb + 1) // 2 if D else 0
    E = (D + 1) * (D + 2) // 2 - 1 if D else 0
    kw = N if N * itemsize <= KW_STAGE_BYTES else 0
    part_rows = -(-(-(-M // CHUNKS)) // SPLIT)          # ceil(ceil(M / 16) / 8)
    tiles = max(1, -(-part_rows // TILE_ROWS))
    parts = SPLIT // per_chunk
    # a CTA a part: 256 threads (two CTAs an SM, so that the 16 clusters of 8
    # run in one wave)
    threads = CLUSTER_THREADS if per_chunk == 1 or blocks > 2 * PART_THREADS else PART_THREADS
    rounds = [G for G in (8, 4, 2, 1) if G <= parts and G * blocks <= 2 * threads]
    # whole parts a step first, then the most parts, then the most tiles
    for TS_of in (lambda G: [tiles],
                  lambda G: list(range(tiles - 1, 0, -1))):
        for G in rounds:
            for TS in TS_of(G):
                if G * TS > 32:
                    continue
                steps = parts // G * -(-tiles // TS)
                stages = 2 if steps > 1 else 1
                smem = _cluster_smem(D, G, TS, stages, itemsize, kw)
                if smem <= MAX_SHARED_BYTES:
                    return NormalEquationsLayout(
                        per_chunk, G, TS, stages, 1 if G * blocks <= threads else 2, threads,
                        CHUNKS if per_chunk == 1 else SPLIT, bool(kw), smem,
                        CHUNKS * (1 + E) if per_chunk > 1 else 0)
    raise ValueError(f"normal_equations: no cluster layout for D = {D}, M = {M}")


def normal_equations_rows(M: int) -> List[List[Tuple[int, int]]]:
    """The row ranges [begin, end) of each of the 16 chunks' 8 parts, as both
    designs of K3 cut M rows: chunk c is [c L, (c + 1) L) with L =
    ceil(M / 16), its part b ceil(L / 8) rows from c L + b ceil(L / 8), both
    cut at M and at the chunk's end."""
    L = -(-M // CHUNKS)
    Lb = -(-L // SPLIT)
    rows = []
    for c in range(CHUNKS):
        chunk_end = min((c + 1) * L, M)
        parts = []
        for b in range(SPLIT):
            begin = min(c * L + b * Lb, chunk_end)
            parts.append((begin, min(begin + Lb, chunk_end)))
        rows.append(parts)
    return rows

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIGNATURES = {
    # knot t, knot q, t0, dt, capture times, exposure times, kp_z, K, pix,
    # starts, loc, vs, dxy, knots, degree, N, F, P, V, D, H, W, keypoints a
    # CTA, shared bytes, stream
    "warp_tangents": [_P] * 13 + [_I] * 10 + [_L, _P],
    # pose_t, pose_q, dpose, kp_z, K, pix, starts, loc, vs, dxy,
    # N, F, P, V, D, H, W, stream
    "warp_tangents_threads": [_P] * 10 + [_I] * 7 + [_P],
    # val, gx, gy, row_stride, dxy, obs, valid, r, J, N, F, P, V, D, affine,
    # tile, threads, interleaved, shared bytes, stream
    "blur_rows": [_P] * 3 + [_L] + [_P] * 5 + [_I] * 6 + [_I] * 3 + [_L, _P],
    # val, gx, gy, row_stride, dxy, obs, valid, r, J, N, F, P, V, D, affine, stream
    "blur_rows_threads": [_P] * 3 + [_L] + [_P] * 5 + [_I] * 6 + [_P],
    # r, J, kp_w, cost, patch, g, H, chunk sums, ticket, F, N, P, D, huber_a,
    # compensated, parts a round, tiles a step, stages, items, threads, CTAs
    # a chunk, kp_w staged, shared bytes, stream
    "normal_equations": [_P] * 9 + [_I] * 4 + [ctypes.c_double] + [_I] * 8 + [_L, _P],
    # r, J, kp_w, partials, cost, patch, g, H, F, N, P, D, huber_a, compensated, stream
    "normal_equations_split": [_P] * 8 + [_I] * 4 + [ctypes.c_double, _I, _P],
}
_LIBRARY = {"warp_tangents": "residual_rows", "warp_tangents_threads": "residual_rows",
            "blur_rows": "residual_rows",
            "blur_rows_threads": "residual_rows", "normal_equations": "normal_equations",
            "normal_equations_split": "normal_equations"}
_loaded: Dict[str, ctypes.CDLL] = {}
# K3's ticket a device (the 8-CTA layout's), 0 between launches, and the
# stream of its last use outside a CUDA graph capture
_tickets: Dict[torch.device, torch.Tensor] = {}
_ticket_streams: Dict[torch.device, torch.cuda.Stream] = {}


# the kernels of the residual stage that every path of the tracker
# launches, by the name of their dispatcher in ops/residual.py: K2's two
# entries, K3 and the patch layout K5; the direct path also launches K4
# (image_bilinear_lk)
EVERY_PATH = ("warp_tangents", "blur_rows", "normal_equations", "prepare_frame_layout")


def launch_counts() -> Dict[str, int]:
    """The launch counters of the residual stage's designs that the tracker
    launches, by the name of their dispatcher: K2's two entries, K3, and K5
    and K4 (``ops/cuda_layout.py``, ``ops/cuda_image.py``)."""
    from . import cuda_image, cuda_layout

    return {"warp_tangents": LAUNCHES_WARP, "blur_rows": LAUNCHES_BLUR,
            "normal_equations": LAUNCHES_NORMAL,
            "prepare_frame_layout": cuda_layout.LAUNCHES_LAYOUT,
            "image_bilinear_lk": cuda_image.LAUNCHES_IMAGE}


def zero_launch_counts() -> None:
    """Zero the counters of K2, K3 (every design), K5 and K4."""
    global LAUNCHES_WARP, LAUNCHES_BLUR, LAUNCHES_NORMAL
    global LAUNCHES_WARP_THREADS, LAUNCHES_BLUR_THREADS, LAUNCHES_NORMAL_SPLIT
    from . import cuda_image, cuda_layout

    LAUNCHES_WARP = LAUNCHES_BLUR = LAUNCHES_NORMAL = 0
    LAUNCHES_WARP_THREADS = LAUNCHES_BLUR_THREADS = LAUNCHES_NORMAL_SPLIT = 0
    cuda_layout.LAUNCHES_LAYOUT = cuda_image.LAUNCHES_IMAGE = 0


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
            queries += [("normal_equations_chunks", CHUNKS), ("normal_equations_blocks", BLOCKS),
                        ("normal_equations_cluster_threads", CLUSTER_THREADS)]
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


def warp_tangents_cuda(knots, cap_times: torch.Tensor, exp_times: torch.Tensor,
                       num_vir: int, degree: int, tangents: bool, kp_z: torch.Tensor,
                       K: torch.Tensor, pix: torch.Tensor, starts: torch.Tensor, height: int,
                       width: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's first entry: ``ops.residual.warp_tangents_plain`` on the card, in
    one launch of the knots design (:func:`warp_tangents_layout`).

    knots: a ``core.spline.SplineKnots`` (t [K, 3], q [K, 4], 0-dim t0 and
    dt); cap_times and exp_times [F]; kp_z [N], K [4], pix [F, N, P, 2]
    (float, one dtype), starts [N, 2] int64, all contiguous on one device.
    ``degree`` 2 or 4; ``tangents``: D = 6K knot tangents, else 0. Returns
    (loc [N, S, 2], vs [N, S], dxy [2, D, N, S]) with S = F P V in (f, p, v)
    order.
    """
    global LAUNCHES_WARP
    who = "warp_tangents_cuda"
    Kn = knots.t.shape[0] if knots.t.dim() == 2 else None
    F = cap_times.shape[0] if cap_times.dim() == 1 else None
    N = kp_z.shape[0] if kp_z.dim() == 1 else None
    dtype = _check(who, dict(knot_t=knots.t, knot_q=knots.q, t0=knots.t0, dt=knots.dt,
                             cap_times=cap_times, exp_times=exp_times, kp_z=kp_z, K=K,
                             pix=pix, starts=starts),
                   dict(knot_t=(Kn, 3), knot_q=(Kn, 4), t0=(), dt=(), cap_times=(F,),
                        exp_times=(F,), kp_z=(N,), K=(4,), pix=(F, N, None, 2),
                        starts=(N, 2)),
                   int_names=("starts",))
    if degree not in (2, 4) or Kn < degree:
        raise ValueError(f"{who}: spline degree {degree} over {Kn} knots (2 or 4, at most "
                         f"the knots)")
    V = int(num_vir)
    if V < 1 or F > 65535:
        raise ValueError(f"{who}: {V} virtual poses, {F} frames")
    D = 6 * Kn if tangents else 0
    _tangents(who, D)
    P = pix.shape[2]
    S = F * P * V
    if N * S >= 2 ** 31:
        raise ValueError(f"{who}: sizes exceed the kernel's indexing")
    opts = dict(dtype=dtype, device=pix.device)
    loc = torch.empty((N, S, 2), **opts)
    vs = torch.empty((N, S), **opts)
    dxy = torch.empty((2, D, N, S), **opts)
    if N * S:
        lay = warp_tangents_layout(P, V, D, loc.element_size())
        LAUNCHES_WARP += _launch(
            _entry("warp_tangents", dtype), pix.device, *(x.data_ptr() for x in (
                knots.t, knots.q, knots.t0, knots.dt, cap_times, exp_times, kp_z, K, pix,
                starts, loc, vs, dxy)),
            Kn, degree, N, F, P, V, D, int(height), int(width), lay.keypoints, lay.smem_bytes)
    return loc, vs, dxy


def warp_tangents_threads_cuda(pose_t: torch.Tensor, pose_q: torch.Tensor,
                               dpose: torch.Tensor, kp_z: torch.Tensor, K: torch.Tensor,
                               pix: torch.Tensor, starts: torch.Tensor, height: int,
                               width: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's first entry in the earlier thread design (one thread a sample), a
    sweep row: ``ops.residual.warp_tangents_threads_plain`` on the card,
    from poses and pose tangents computed outside.

    pose_t [F, V, 3], pose_q [F, V, 4], dpose [D, F, V, 7], kp_z [N], K [4],
    pix [F, N, P, 2] (float, one dtype), starts [N, 2] int64, all
    contiguous on one device. Returns (loc [N, S, 2], vs [N, S],
    dxy [2, D, N, S]) with S = F P V in (f, p, v) order.
    """
    global LAUNCHES_WARP_THREADS
    who = "warp_tangents_threads_cuda"
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
        LAUNCHES_WARP_THREADS += _launch(
            _entry("warp_tangents_threads", dtype), pix.device, pose_t.data_ptr(),
            pose_q.data_ptr(), dpose.data_ptr(), kp_z.data_ptr(), K.data_ptr(),
            pix.data_ptr(), starts.data_ptr(), loc.data_ptr(), vs.data_ptr(), dxy.data_ptr(),
            N, F, P, V, D, int(height), int(width))
    return loc, vs, dxy


def _blur_rows_check(who, val, gx, gy, dxy, obs, valid, num_vir):
    """The checks of both designs of blur_rows; returns (dtype, F, N, P, V,
    D)."""
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
    return dtype, F, N, P, V, D


def blur_rows_cuda(val: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                   dxy: torch.Tensor, obs: torch.Tensor, valid: torch.Tensor,
                   num_vir: int, affine: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's second entry: ``ops.residual.blur_rows_plain`` on the card, in the
    keypoint design (one CTA a keypoint, :func:`blur_rows_layout`).

    val, gx, gy [N, S]: K1's samples, each with unit stride along S and one
    keypoint stride for all three (the channel views of K1's [N, 3, S]
    output are read in place); dxy [2, D, N, S], obs [F, N, P] and the bool
    patch-pixel mask ``valid`` [F, N, P], contiguous. Returns [F, N, P] and
    [F, N, P, D], contiguous: (r, J), masked by ``valid``; with ``affine``
    (pred, dpred), unmasked, for the gain/bias elimination.
    """
    global LAUNCHES_BLUR
    who = "blur_rows_cuda"
    dtype, F, N, P, V, D = _blur_rows_check(who, val, gx, gy, dxy, obs, valid, num_vir)
    opts = dict(dtype=dtype, device=obs.device)
    r = torch.empty((F, N, P), **opts)
    J = torch.empty((F, N, P, D), **opts)
    if r.numel():
        lay = blur_rows_layout(F, P, V, D, r.element_size())
        S, isz = F * P * V, r.element_size()
        # K1's [N, 3, S] channels are one run a keypoint; any other layout
        # three runs
        interleaved = (val.stride(0) == 3 * S and gx.data_ptr() == val.data_ptr() + S * isz
                       and gy.data_ptr() == val.data_ptr() + 2 * S * isz)
        LAUNCHES_BLUR += _launch(
            _entry("blur_rows", dtype), obs.device, val.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), val.stride(0), dxy.data_ptr(), obs.data_ptr(), valid.data_ptr(),
            r.data_ptr(), J.data_ptr(), N, F, P, V, D, int(bool(affine)), lay.tile,
            lay.threads, int(interleaved), lay.smem_bytes)
    return r, J


def blur_rows_threads_cuda(val: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor,
                           dxy: torch.Tensor, obs: torch.Tensor, valid: torch.Tensor,
                           num_vir: int, affine: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`blur_rows_cuda` in the earlier thread design (one thread a row),
    the same arguments and the same bits."""
    global LAUNCHES_BLUR_THREADS
    who = "blur_rows_threads_cuda"
    dtype, F, N, P, V, D = _blur_rows_check(who, val, gx, gy, dxy, obs, valid, num_vir)
    opts = dict(dtype=dtype, device=obs.device)
    r = torch.empty((F, N, P), **opts)
    J = torch.empty((F, N, P, D), **opts)
    if r.numel():
        LAUNCHES_BLUR_THREADS += _launch(
            _entry("blur_rows_threads", dtype), obs.device, val.data_ptr(), gx.data_ptr(),
            gy.data_ptr(), val.stride(0), dxy.data_ptr(), obs.data_ptr(), valid.data_ptr(),
            r.data_ptr(), J.data_ptr(), N, F, P, V, D, int(bool(affine)))
    return r, J


def _normal_equations_check(who, r, J, kp_w):
    """The checks of both designs of K3; returns (dtype, F, N, P, D) and the
    outputs (cost, patch, g, H), allocated."""
    F, N, P = r.shape if r.dim() == 3 else (None, None, None)
    tensors = dict(r=r, kp_w=kp_w)
    shapes = dict(r=(F, N, P), kp_w=(N,))
    if J is not None:
        tensors["J"], shapes["J"] = J, (F, N, P, None)
    dtype = _check(who, tensors, shapes)
    D = 0 if J is None else J.shape[-1]
    _tangents(who, D)
    if r.numel() >= 2 ** 31 or r.numel() * max(D, 1) >= 2 ** 62:
        raise ValueError(f"{who}: sizes exceed the kernel's indexing")
    opts = dict(dtype=dtype, device=r.device)
    outs = (torch.empty((), **opts), torch.empty((F, N), **opts), torch.empty((D,), **opts),
            torch.empty((D, D), **opts))
    return (dtype, F, N, P, D), outs


def _normal_equations_result(J, outs):
    cost, patch, g, H = outs
    if J is None:
        return cost, patch, None, None
    return cost, patch, g, H


def _ticket(device: torch.device) -> torch.Tensor:
    """The device's ticket for K3's 8-CTA layout. Two launches that share it
    must not overlap: a call on another stream than the last one's first
    makes its stream wait for that one (outside a capture)."""
    capturing = torch.cuda.is_current_stream_capturing()
    stream = torch.cuda.current_stream(device)
    if device not in _tickets:
        if capturing:
            raise RuntimeError("normal_equations_cuda: make one call outside a CUDA "
                               "graph capture first (it allocates the device's ticket)")
        _tickets[device] = torch.zeros((1,), dtype=torch.int32, device=device)
        _ticket_streams[device] = stream
    if not capturing and _ticket_streams[device] != stream:
        stream.wait_stream(_ticket_streams[device])
        _ticket_streams[device] = stream
    return _tickets[device]


def normal_equations_cuda(
    r: torch.Tensor, J: Optional[torch.Tensor], kp_w: torch.Tensor, huber_a: float,
    compensated: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K3: ``ops.residual.normal_equations_plain`` on the card, in the cluster
    design (one launch, :func:`normal_equations_layout`).

    r [F, N, P], J [F, N, P, D] or None (cost only), kp_w [N], one dtype,
    contiguous. Returns the raw per-rank sums (cost, patch [F, N], g [D],
    H [D, D]), g and H None without J. A run repeats bit for bit.

    Past CLUSTER_ROWS rows the launches on a device share one ticket, so
    they run one after another: eager calls on different streams are
    ordered by the wrapper, and a CUDA graph that holds such a call must
    not replay while another one runs on the device.
    """
    return _normal_equations_cluster(r, J, kp_w, huber_a, compensated, None)


def _normal_equations_cluster(r, J, kp_w, huber_a, compensated, per_chunk):
    """:func:`normal_equations_cuda` with ``per_chunk`` CTAs a chunk (None:
    the rule's; the layout sweep of ``experiments/residual_kernels.py``
    takes both)."""
    global LAUNCHES_NORMAL
    (dtype, F, N, P, D), outs = _normal_equations_check("normal_equations_cuda", r, J, kp_w)
    M = r.numel()
    lay = (normal_equations_layout(D, r.element_size(), N, M) if per_chunk is None
           else _cluster_layout(D, r.element_size(), N, M, per_chunk))
    scratch = ticket = None
    if lay.chunk_scratch:
        scratch = torch.empty((lay.chunk_scratch,), dtype=dtype, device=r.device)
        ticket = _ticket(r.device)
    LAUNCHES_NORMAL += _launch(
        _entry("normal_equations", dtype), r.device, r.data_ptr(),
        J.data_ptr() if J is not None else None, kp_w.data_ptr(),
        *(o.data_ptr() for o in outs), None if scratch is None else scratch.data_ptr(),
        None if ticket is None else ticket.data_ptr(), F, N, P, D, float(huber_a),
        int(bool(compensated)), lay.parts_a_round, lay.tiles_a_step, lay.stages, lay.items,
        lay.threads, lay.per_chunk, int(lay.kw_staged), lay.smem_bytes)
    return _normal_equations_result(J, outs)


def normal_equations_split_cuda(
    r: torch.Tensor, J: Optional[torch.Tensor], kp_w: torch.Tensor, huber_a: float,
    compensated: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """:func:`normal_equations_cuda` in the earlier split design (the
    partials of 128 blocks into a scratch buffer, then their combination:
    two launches), the same arguments and the same bits."""
    global LAUNCHES_NORMAL_SPLIT
    (dtype, F, N, P, D), outs = _normal_equations_check("normal_equations_split_cuda", r, J,
                                                        kp_w)
    E = (D + 1) * (D + 2) // 2 - 1 if D else 0
    part = torch.empty((BLOCKS * (1 + E),), dtype=dtype, device=r.device)
    cost, patch, g, H = outs
    LAUNCHES_NORMAL_SPLIT += 2 * _launch(
        _entry("normal_equations_split", dtype), r.device, r.data_ptr(),
        J.data_ptr() if J is not None else None, kp_w.data_ptr(), part.data_ptr(),
        cost.data_ptr(), patch.data_ptr(), g.data_ptr(), H.data_ptr(), F, N, P, D,
        float(huber_a), int(bool(compensated)))
    return _normal_equations_result(J, outs)
