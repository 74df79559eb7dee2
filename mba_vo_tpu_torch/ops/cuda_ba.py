"""Bind and launch the bundle adjustment's LM iteration, kernels K10-K12.

``csrc/bundle_adjust.cu`` replaces the body of the BA's LM
``lax.while_loop`` in ``mba_vo_tpu/backend/ba.py`` (``run_bundle_adjustment``'s
``body``, ``:345-364``), which XLA compiles into one device program (no
Pallas source):

  * K10 ``ba_build``: the robust normal equations U, V, W_blk, g_p, g_x
    and the odometry prior's H and cost (``build_normal_equations``), and
    at the loop's first iteration its initial cost (``evaluate_cost``);
  * K11 ``ba_step``: the damped Schur solve, dx by back-substitution and
    the candidate poses and points (``schur_solve``, ``_apply_step``), in
    one cooperative launch (every CTA resident: :class:`BABinding` checks
    the grid against the occupancy API and raises where it cannot be, with
    no fallback);
  * K12 ``ba_commit``: the candidate's cost, the decision, the select in
    place, lambda, the cost, the iteration count and the done flag, in one
    thread-block cluster of ``min(C, 16)`` CTAs (:func:`commit_cluster`;
    :class:`BABinding` asks the occupancy API whether it can be scheduled
    and raises where it cannot, with no fallback).

An iteration is K10, K11, K12 and one host read of the done flag
(``backend/ba.py::run_bundle_adjustment`` on CUDA tensors without
``group``). Their plain versions are ``backend/ba.py``'s ``ba_build_plain``,
``ba_step_plain`` and ``ba_commit_plain``, which CPU tensors and the
landmark-sharded path take. The kernels take CUDA tensors only and raise on
anything else; nothing falls back to the plain versions.

:class:`BABinding` binds one ``run_bundle_adjustment`` call: the problem's
tensors are checked once for device, dtype, shape and contiguity, and it
owns the state (poses, points and the scalars below, updated in place by
K12), the kernels' outputs and their scratch, so that an iteration pays for
three launches and no checks. :func:`ba_build_cuda`, :func:`ba_step_cuda`
and :func:`ba_commit_cuda` are each kernel alone on given inputs (a binding
made for the call), for the comparisons with the plain versions.

The earlier ticket designs of K10, K11 and K12 stay callable as sweep rows
(:meth:`BABinding.build_ticket`, :meth:`BABinding.step_ticket`,
:meth:`BABinding.commit_ticket`); no path launches them.
``LAUNCHES_BA_BUILD``, ``LAUNCHES_BA_STEP`` and ``LAUNCHES_BA_COMMIT`` count
the launched designs' launches, ``LAUNCHES_BA_BUILD_TICKET``,
``LAUNCHES_BA_STEP_TICKET`` and ``LAUNCHES_BA_COMMIT_TICKET`` the ticket
designs', one a call (a call recorded into a CUDA graph is not a launch).
The library is built and loaded by ``ops/cuda_build.py`` at first use;
nothing here runs when the module is imported.

The state's scalars are one vector of the working dtype indexed by the
``B_*`` constants (``bundle_adjust.cu`` has the same enum): the current
cost, lambda, the iterations made, the done flag, the initial cost, K10's
build cost (the normal equations' cost, as ``build_normal_equations``
returns it), and K12's candidate cost, ok flag and relative decrease.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from . import cuda_build
from .cuda_residual import _check, _launch

LAUNCHES_BA_BUILD = 0
LAUNCHES_BA_STEP = 0
LAUNCHES_BA_COMMIT = 0
LAUNCHES_BA_BUILD_TICKET = 0
LAUNCHES_BA_STEP_TICKET = 0
LAUNCHES_BA_COMMIT_TICKET = 0

B_COST, B_LAM, B_IT, B_DONE, B_COST0, B_BUILD_COST, B_CAND_COST, B_OK, B_REL = range(9)
B_SIZE = 9

# a CTA's threads (bundle_adjust.cu's kThreads) and the most landmarks a
# CTA takes
BA_THREADS = 256
MAX_LANDMARKS_PER_CTA = 32
# K11's first phase (a slice's W_blk and W V^-1, 36 W values a landmark)
# stays under this many bytes, which sets the landmarks a CTA at wide windows
SLICE_SMEM_BUDGET = 96 * 1024
# the shared memory a CTA may opt into (bundle_adjust.cu's kSmemLimit), and
# what an SM holds for its CTAs (1 KiB of it reserved for each) and its threads
SMEM_LIMIT = 232448
SM_SMEM_BYTES = 233472
SM_THREADS = 2048
# K12's cluster design: at most this many CTAs a cluster (H100's
# non-portable size; bundle_adjust.cu's kMaxCluster), each of this many
# threads (the observations' 256 and the prior's warp)
MAX_COMMIT_CLUSTER = 16
COMMIT_THREADS = 288
# the macro of bundle_adjust.cu's harness-only build, whose kernels stamp
# each phase's end (experiments/ba_kernels.py's phase split)
PHASE_CLOCKS = "BA_PHASE_CLOCKS"

_loaded: Dict[str, ctypes.CDLL] = {}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # t, q, X, scalars, obs, obs_mask, point_mask, K, odom t, odom q, odom
    # weight, pose_mask, U, V, W_blk, g_p, g_x, H_o, partials, the prior's
    # scratch [6W + 2], ticket, W, M, MB, huber_a, stream
    "ba_build": [_P] * 21 + [_I, _I, _I, _D, _P],
    # the same without the prior's scratch
    "ba_build_ticket": [_P] * 20 + [_I, _I, _I, _D, _P],
    # t, q, X, scalars, point_mask, pose_mask, U, V, W_blk, g_p, g_x, H_o,
    # dp, dx, cand t, cand q, cand X, V^-1, partials, S [D + 1, D], the grid
    # barrier's count, W, M, MB, S in shared memory, landmark_damping, stream
    "ba_step": [_P] * 21 + [_I, _I, _I, _I, _D, _P],
    # t, q, X, scalars, point_mask, pose_mask, U, V, W_blk, g_p, g_x, H_o,
    # dp, dx, cand t, cand q, cand X, V^-1, partials, S scratch or null,
    # ticket, W, M, MB, landmark_damping, stream
    "ba_step_ticket": [_P] * 21 + [_I, _I, _I, _D, _P],
    # t, q, X, scalars, obs, obs_mask, point_mask, K, odom t, odom q, odom
    # weight, dp, dx, cand t, cand q, cand X, W, M, MB, huber_a, lambda_up,
    # lambda_down, min_lambda, max_lambda, min_rel_decrease, stream
    "ba_commit": [_P] * 16 + [_I, _I, _I] + [_D] * 6 + [_P],
    # the same with partials and the ticket after cand X
    "ba_commit_ticket": [_P] * 18 + [_I, _I, _I] + [_D] * 6 + [_P],
}


def library(clocked: bool = False) -> ctypes.CDLL:
    """``bundle_adjust.cu``'s library, its entries typed; ``clocked``: the
    harness-only build with :data:`PHASE_CLOCKS`, whose kernels stamp their
    phases (never the library the path launches)."""
    key = "clocked" if clocked else "path"
    if key not in _loaded:
        lib = cuda_build.load("bundle_adjust", (PHASE_CLOCKS,) if clocked else ())
        for fn_name, signature in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{fn_name}_{suffix}")
                fn.argtypes, fn.restype = signature, ctypes.c_int
        for fn_name, args, res in (("ba_scalars_size", [], ctypes.c_int),
                                   ("ba_smem_bytes", [ctypes.c_int] * 6, ctypes.c_longlong),
                                   ("ba_step_blocks_per_sm", [ctypes.c_int] * 4, ctypes.c_int),
                                   ("ba_commit_cluster", [ctypes.c_int] * 3, ctypes.c_int),
                                   ("ba_commit_smem_bytes", [ctypes.c_int] * 4,
                                    ctypes.c_longlong),
                                   ("ba_commit_clusters", [ctypes.c_int] * 4, ctypes.c_int),
                                   ("ba_phase_clocks", [ctypes.c_int], ctypes.c_int)):
            fn = getattr(lib, fn_name)
            fn.argtypes, fn.restype = args, res
        if lib.ba_scalars_size() != B_SIZE:
            raise RuntimeError(f"bundle_adjust.cu lays out {lib.ba_scalars_size()} scalars, "
                               f"not {B_SIZE}")
        if lib.ba_phase_clocks(0) != int(clocked):
            raise RuntimeError(f"bundle_adjust.cu's {key} build stamps its phases: "
                               f"{lib.ba_phase_clocks(0)}")
        _loaded[key] = lib
    return _loaded[key]


def _entry(name: str, dtype: torch.dtype, clocked: bool = False):
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(library(clocked), f"{name}_{suffix}")


def launch_counts() -> Dict[str, int]:
    """The launches of K10-K12 by kernel name."""
    return {"ba_build": LAUNCHES_BA_BUILD, "ba_step": LAUNCHES_BA_STEP,
            "ba_commit": LAUNCHES_BA_COMMIT}


def earlier_launch_counts() -> Dict[str, int]:
    """The launches of K10's, K11's and K12's earlier ticket designs, by the
    kernel's name: no path launches them."""
    return {"ba_build": LAUNCHES_BA_BUILD_TICKET, "ba_step": LAUNCHES_BA_STEP_TICKET,
            "ba_commit": LAUNCHES_BA_COMMIT_TICKET}


def zero_launch_counts() -> None:
    global LAUNCHES_BA_BUILD, LAUNCHES_BA_STEP, LAUNCHES_BA_COMMIT
    global LAUNCHES_BA_BUILD_TICKET, LAUNCHES_BA_STEP_TICKET, LAUNCHES_BA_COMMIT_TICKET
    LAUNCHES_BA_BUILD = LAUNCHES_BA_STEP = LAUNCHES_BA_COMMIT = 0
    LAUNCHES_BA_BUILD_TICKET = LAUNCHES_BA_STEP_TICKET = LAUNCHES_BA_COMMIT_TICKET = 0
LAUNCHES_BA_COMMIT_TICKET = 0


class BALayout(NamedTuple):
    landmarks_per_cta: int   # MB
    ctas: int                # C = ceil(M / MB), the slices (K10 adds a CTA for the prior)
    s_shared: bool           # K11's S [6W + 1, 6W] in shared memory, else its global scratch


def step_smem_bytes(W: int, MB: int, itemsize: int, s_shared: bool) -> int:
    """K11's shared memory, the cooperative design (``bundle_adjust.cu``'s
    ``step_smem_elems``): a slice's gauged W_blk [W MB, 18], V^-1 [MB, 9]
    and g_x [MB, 3], kept to the end, beside the larger of W V^-1 [W MB, 18]
    and the solve's room (S with its right-hand side [6W + 1, 6W] where it
    lives there, the pivots and the solution [6W] each, the gauge [W])."""
    D = 6 * W
    keep = 18 * W * MB + 12 * MB
    solve = ((D + 1) * D if s_shared else 0) + 2 * D + W
    return (keep + max(18 * W * MB, solve)) * itemsize


def ticket_step_smem_bytes(W: int, MB: int, itemsize: int, s_shared: bool) -> int:
    """K11's shared memory, the ticket design (the earlier design; ``bundle_adjust.cu``'s
    ``step_ticket_smem_elems``): the larger of its first phase (a slice's
    W_blk and W V^-1 [W MB, 18] each, V^-1 [MB, 9] and g_x [MB, 3]) and the
    last CTA's (S [6W, 6W] where it lives there, five vectors [6W] and the
    gauge [W])."""
    D = 6 * W
    first = 36 * W * MB + 12 * MB
    last = (D * D if s_shared else 0) + 5 * D + W + 2
    return max(first, last) * itemsize


def ba_layout(W: int, M: int, itemsize: int) -> BALayout:
    """The kernels' split of M landmarks over CTAs at window W: at most
    :data:`MAX_LANDMARKS_PER_CTA` landmarks a CTA, fewer where K11's slice
    would pass :data:`SLICE_SMEM_BUDGET`; S in shared memory while K11's
    shared memory fits :data:`SMEM_LIMIT` with it."""
    per = (36 * W + 12) * itemsize
    MB = max(1, min(MAX_LANDMARKS_PER_CTA, SLICE_SMEM_BUDGET // per))
    s_shared = step_smem_bytes(W, MB, itemsize, True) <= SMEM_LIMIT
    return BALayout(MB, -(-M // MB), s_shared)


def ticket_s_shared(W: int, MB: int, itemsize: int) -> bool:
    """Whether the ticket design's last CTA holds S in shared memory."""
    return ticket_step_smem_bytes(W, MB, itemsize, True) <= SMEM_LIMIT


def commit_cluster(C: int) -> int:
    """K12's cluster design: its CTAs, one cluster of G = min(C, 16)
    (``bundle_adjust.cu``'s ``commit_cluster``) for C slices."""
    return min(C, MAX_COMMIT_CLUSTER)


def commit_slices(rank: int, C: int) -> range:
    """The slices rank ``rank`` of K12's cluster takes, in order: rank,
    rank + G, ... below C (its shared memory holds their sums in that
    order)."""
    return range(rank, C, commit_cluster(C))


def commit_smem_bytes(W: int, MB: int, C: int, itemsize: int) -> int:
    """K12's shared memory, the cluster design (``bundle_adjust.cu``'s
    ``commit_smem_elems``): a slice's rho mask and mask [W MB] each, the
    prior's terms [W - 1, 6], the candidate points of the rank's slices
    [ceil(C / G), 3 MB], the candidate poses [7W] and every slice's sums
    [C, 3]."""
    G = commit_cluster(C)
    return (2 * W * MB + 6 * max(W - 1, 0) + 3 * MB * -(-C // G) + 7 * W + 3 * C) * itemsize


def smem_bytes(kernel: int, W: int, MB: int, itemsize: int, s_shared: bool,
               ticket: bool = False) -> int:
    """The dynamic shared memory the library gives kernel 10, 11 or 12
    (``ticket``: the earlier design of K10, K11 or K12; for K12 only that
    one, :func:`commit_smem_bytes` the cluster design's) at window W, MB
    landmarks a CTA and the dtype's size (``bundle_adjust.cu``'s
    ``ba_smem_bytes``; loads the library)."""
    return int(library().ba_smem_bytes(kernel, int(ticket), W, MB, itemsize, int(s_shared)))


def smem_blocks_per_sm(smem: int) -> int:
    """The CTAs of :data:`BA_THREADS` threads with ``smem`` bytes of dynamic
    shared memory an SM holds by its shared memory and its threads alone
    (the occupancy API's answer, which counts registers too, is at most
    this)."""
    return min(SM_SMEM_BYTES // (smem + 1024), SM_THREADS // BA_THREADS)


def check_co_resident(ctas: int, blocks_per_sm: int, sms: int) -> int:
    """K11's cooperative launch needs its ``ctas`` CTAs resident at once:
    returns how many can be (``blocks_per_sm`` on each of ``sms`` SMs) and
    raises ``ValueError`` where that is fewer."""
    most = max(blocks_per_sm, 0) * sms
    if ctas > most:
        raise ValueError(f"K11's grid of {ctas} CTAs cannot be resident at once: {sms} SMs "
                         f"hold {blocks_per_sm} each")
    return most


_blocks_per_sm: Dict[tuple, int] = {}


def step_blocks_per_sm(W: int, MB: int, itemsize: int, s_shared: bool,
                       device: torch.device) -> int:
    """K11's CTAs one SM of ``device`` holds at once (the occupancy API with
    the kernel's dynamic shared memory), asked once a shape and device."""
    key = (W, MB, itemsize, s_shared, device)
    if key not in _blocks_per_sm:
        with torch.cuda.device(device):
            n = library().ba_step_blocks_per_sm(W, MB, itemsize, int(s_shared))
        if n < 0:
            raise RuntimeError(f"the occupancy of K11 failed: CUDA error {-n}")
        _blocks_per_sm[key] = n
    return _blocks_per_sm[key]


_clusters: Dict[tuple, int] = {}


def commit_clusters(W: int, M: int, MB: int, itemsize: int, device: torch.device) -> int:
    """The clusters of K12's cluster design that ``device`` holds at once
    (``cudaOccupancyMaxActiveClusters`` with the kernel's shared memory),
    asked once a shape and device; raises ``ValueError`` where that is 0
    (the cluster cannot be scheduled) and ``RuntimeError`` on a CUDA
    error."""
    key = (W, M, MB, itemsize, device)
    if key not in _clusters:
        with torch.cuda.device(device):
            lib = library()
            n = lib.ba_commit_clusters(W, M, MB, itemsize)
            G = lib.ba_commit_cluster(W, M, MB)
        if n < 0:
            raise RuntimeError(f"the occupancy of K12's cluster failed: CUDA error {-n}")
        if G != commit_cluster(-(-M // MB)) or G > MAX_COMMIT_CLUSTER:
            raise RuntimeError(f"K12's cluster of {G} CTAs is not ba_layout's")
        if n < 1:
            raise ValueError(f"K12's cluster of {G} CTAs cannot be scheduled on {device}")
        _clusters[key] = n
    return _clusters[key]


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


class BABinding:
    """K10-K12 bound to one bundle-adjustment problem.

    ``problem``: a ``backend.ba.BAProblem`` of CUDA tensors of one float
    dtype, contiguous, on one device: poses t [W, 3] and q [W, 4], the map's
    points [M, 3], point_mask [M], obs_xy [W, M, 2], obs_mask [W, M], K [4],
    the odometry prior (t [W-1, 3], q [W-1, 4], weight [W-1]) or None, and
    pose_mask [W] or None; checked here, raising on the first tensor that
    fails. ``opts``: the ``backend.ba.BAOptions``.

    The state is :attr:`t`, :attr:`q`, :attr:`X` and :attr:`scalars`: with
    ``own`` (the LM's call) copies of the problem's poses and points and new
    scalars (lambda at ``opts.initial_lambda``, every other entry 0), else the
    problem's own tensors and ``scalars`` as given (updated in place). Each
    of :meth:`build`, :meth:`step` and :meth:`commit` is one launch into the
    binding's buffers: :attr:`built` (K10's outputs, K11's inputs) and
    :attr:`candidate` (K11's outputs, K12's inputs), which
    :meth:`use_built` and :meth:`use_candidate` replace by given tensors
    (checked). :meth:`build_ticket`, :meth:`step_ticket` and
    :meth:`commit_ticket` launch the earlier ticket designs into the same
    buffers (sweep rows; no path calls them).

    K11's grid and K12's cluster are checked here against the occupancy
    API, once a shape: a grid that cannot be resident at once, or a cluster
    that cannot be scheduled, raises ``ValueError``.
    ``clocked``: the harness-only build that stamps the kernels' phases
    (``experiments/ba_kernels.py``)."""

    def __init__(self, problem, opts, scalars: Optional[torch.Tensor] = None,
                 own: bool = True, clocked: bool = False):
        poses, m = problem.poses, problem.map
        W = poses.t.shape[0] if poses.t.dim() == 2 else None
        M = m.points.shape[0] if m.points.dim() == 2 else None
        E = None if W is None else W - 1
        tensors = dict(t=poses.t, q=poses.q, points=m.points, point_mask=m.point_mask,
                       obs_xy=m.obs_xy, obs_mask=m.obs_mask, K=problem.K)
        shapes = dict(t=(W, 3), q=(W, 4), points=(M, 3), point_mask=(M,), obs_xy=(W, M, 2),
                      obs_mask=(W, M), K=(4,))
        if problem.odom is not None:
            tensors.update(odom_t=problem.odom.t, odom_q=problem.odom.q,
                           odom_weight=problem.odom.weight)
            shapes.update(odom_t=(E, 3), odom_q=(E, 4), odom_weight=(E,))
        if problem.pose_mask is not None:
            tensors["pose_mask"], shapes["pose_mask"] = problem.pose_mask, (W,)
        if scalars is not None:
            tensors["scalars"], shapes["scalars"] = scalars, (B_SIZE,)
        dtype = _check("BABinding", tensors, shapes)
        if W < 1 or M < 1:
            raise ValueError(f"BABinding: {W} poses, {M} landmark slots")
        self.problem, self.opts, self.dtype = problem, opts, dtype
        self.W, self.M, self.device = W, M, poses.t.device
        itemsize = poses.t.element_size()
        self.layout = lay = ba_layout(W, M, itemsize)
        check_co_resident(lay.ctas, step_blocks_per_sm(W, lay.landmarks_per_cta, itemsize,
                                                       lay.s_shared, self.device),
                          torch.cuda.get_device_properties(self.device).multi_processor_count)
        commit_clusters(W, M, lay.landmarks_per_cta, itemsize, self.device)
        like = poses.t
        if own:
            self.t, self.q, self.X = poses.t.clone(), poses.q.clone(), m.points.clone()
        else:
            self.t, self.q, self.X = poses.t, poses.q, m.points
        if scalars is None:
            scalars = like.new_zeros(B_SIZE)
            scalars[B_LAM] = opts.initial_lambda
        self.scalars = scalars
        D = 6 * W
        # H_o's blocks off the band stay zero: K10 writes only the band
        self.built = (scalars[B_BUILD_COST], like.new_empty((W, 6, 6)),
                      like.new_empty((M, 3, 3)), like.new_empty((W, M, 6, 3)),
                      like.new_empty((W, 6)), like.new_empty((M, 3)), like.new_zeros((D, D)))
        self.candidate = (like.new_empty((W, 6)), like.new_empty((M, 3)), like.new_empty((W, 3)),
                          like.new_empty((W, 4)), like.new_empty((M, 3)))
        C = self.layout.ctas
        part = max(42 * W + 2, D * (D + 1) // 2 + D, 3)
        self._partials = like.new_empty(C * part)
        self._vinv = like.new_empty((M, 3, 3))
        self._prior = like.new_empty(D + 2)     # K10's g_o and the prior's two costs
        self._s = like.new_empty((D + 1) * D)
        self._s_ticket = (None if ticket_s_shared(W, lay.landmarks_per_cta, itemsize)
                          else like.new_empty((D, D)))
        # K10's, the ticket designs' of K11 and K12 tickets, then K11's grid
        # barrier's count of arrivals
        self._tickets = torch.zeros(4, dtype=torch.int32, device=self.device)
        odom = problem.odom
        self._inputs = (_ptr(m.obs_xy), _ptr(m.obs_mask), _ptr(m.point_mask), _ptr(problem.K),
                        None if odom is None else odom.t.data_ptr(),
                        None if odom is None else odom.q.data_ptr(),
                        None if odom is None else odom.weight.data_ptr())
        self._pose_mask = _ptr(problem.pose_mask)
        self._state = tuple(x.data_ptr() for x in (self.t, self.q, self.X, self.scalars))
        self._dims = (W, M, self.layout.landmarks_per_cta)
        self._fns = {k: _entry(k, dtype, clocked) for k in _SIGNATURES}
        self._set_ptrs()

    def _set_ptrs(self):
        self._built_ptrs = tuple(x.data_ptr() for x in self.built[1:])
        self._cand_ptrs = tuple(x.data_ptr() for x in self.candidate)

    def _use(self, who: str, names, tensors, shapes):
        tensors = tuple(tensors)
        if len(tensors) != len(names):
            raise ValueError(f"BABinding.{who}: {len(tensors)} tensors, not {len(names)}")
        # checked with the state's t, for its device and dtype
        _check(f"BABinding.{who}", dict(state_t=self.t, **dict(zip(names, tensors))),
               dict(state_t=(self.W, 3), **dict(zip(names, shapes))))
        return tensors

    def use_built(self, built) -> None:
        """K11's inputs from ``built`` = (cost, U [W,6,6], V [M,3,3], W_blk
        [W,M,6,3], g_p [W,6], g_x [M,3], H_o [6W,6W]) (``ba_build_plain``'s
        outputs; the cost is not read), checked."""
        W, M, D = self.W, self.M, 6 * self.W
        got = self._use("use_built", ("U", "V", "W_blk", "g_p", "g_x", "H_o"), tuple(built)[1:],
                        ((W, 6, 6), (M, 3, 3), (W, M, 6, 3), (W, 6), (M, 3), (D, D)))
        self.built = (self.built[0],) + got
        self._set_ptrs()

    def use_candidate(self, candidate) -> None:
        """K12's inputs from ``candidate`` = (dp [W,6], dx [M,3], cand t
        [W,3], cand q [W,4], cand X [M,3]) (``ba_step_plain``'s outputs),
        checked."""
        W, M = self.W, self.M
        self.candidate = self._use("use_candidate", ("dp", "dx", "cand_t", "cand_q", "cand_X"),
                                   candidate, ((W, 6), (M, 3), (W, 3), (W, 4), (M, 3)))
        self._set_ptrs()

    def build(self) -> None:
        """K10 (the band design): :attr:`built` at the state; the build's
        cost into the scalars and, where they count no iteration yet, the
        initial cost."""
        global LAUNCHES_BA_BUILD
        LAUNCHES_BA_BUILD += _launch(
            self._fns["ba_build"], self.device, *self._state, *self._inputs, self._pose_mask,
            *self._built_ptrs, self._partials.data_ptr(), self._prior.data_ptr(),
            self._tickets[0:1].data_ptr(), *self._dims, float(self.opts.huber_a))

    def build_ticket(self) -> None:
        """K10's earlier ticket design, as :meth:`build`."""
        global LAUNCHES_BA_BUILD_TICKET
        LAUNCHES_BA_BUILD_TICKET += _launch(
            self._fns["ba_build_ticket"], self.device, *self._state, *self._inputs,
            self._pose_mask, *self._built_ptrs, self._partials.data_ptr(),
            self._tickets[0:1].data_ptr(), *self._dims, float(self.opts.huber_a))

    def step(self) -> None:
        """K11 (the cooperative design): :attr:`candidate` from :attr:`built`
        and the scalars' lambda."""
        global LAUNCHES_BA_STEP
        LAUNCHES_BA_STEP += _launch(
            self._fns["ba_step"], self.device, *self._state, self._inputs[2], self._pose_mask,
            *self._built_ptrs, *self._cand_ptrs, self._vinv.data_ptr(),
            self._partials.data_ptr(), self._s.data_ptr(), self._tickets[3:4].data_ptr(),
            *self._dims, int(self.layout.s_shared), float(self.opts.landmark_damping))

    def step_ticket(self) -> None:
        """K11's earlier ticket design, as :meth:`step`."""
        global LAUNCHES_BA_STEP_TICKET
        LAUNCHES_BA_STEP_TICKET += _launch(
            self._fns["ba_step_ticket"], self.device, *self._state, self._inputs[2],
            self._pose_mask, *self._built_ptrs, *self._cand_ptrs, self._vinv.data_ptr(),
            self._partials.data_ptr(), _ptr(self._s_ticket), self._tickets[1:2].data_ptr(),
            *self._dims, float(self.opts.landmark_damping))

    def _options(self):
        o = self.opts
        return (float(o.huber_a), float(o.lambda_up), float(o.lambda_down),
                float(o.min_lambda), float(o.max_lambda), float(o.min_rel_decrease))

    def commit(self) -> None:
        """K12 (the cluster design): the candidate's cost, the decision and
        the next state, in place."""
        global LAUNCHES_BA_COMMIT
        LAUNCHES_BA_COMMIT += _launch(
            self._fns["ba_commit"], self.device, *self._state, *self._inputs,
            *self._cand_ptrs, *self._dims, *self._options())

    def commit_ticket(self) -> None:
        """K12's earlier ticket design, as :meth:`commit`."""
        global LAUNCHES_BA_COMMIT_TICKET
        LAUNCHES_BA_COMMIT_TICKET += _launch(
            self._fns["ba_commit_ticket"], self.device, *self._state, *self._inputs,
            *self._cand_ptrs, self._partials.data_ptr(), self._tickets[2:3].data_ptr(),
            *self._dims, *self._options())

    def state_problem(self):
        """The problem at the binding's state (poses and points)."""
        from ..core.transform import Pose

        p = self.problem
        return p._replace(poses=Pose(t=self.t, q=self.q), map=p.map._replace(points=self.X))


def ba_build_cuda(problem, scalars: torch.Tensor, opts):
    """K10 alone: ``backend.ba.ba_build_plain`` at ``problem``'s state, in
    one launch. Returns (cost, U, V, W_blk, g_p, g_x, H_o) with the cost a
    view of ``scalars`` (written in place, as are the initial cost and the
    cost where ``scalars`` count no iteration yet)."""
    b = BABinding(problem, opts, scalars, own=False)
    b.build()
    return b.built


def ba_step_cuda(problem, scalars: torch.Tensor, built, opts):
    """K11 alone: ``backend.ba.ba_step_plain`` on ``built`` (K10's or
    ``ba_build_plain``'s outputs) at ``problem``'s state and the scalars'
    lambda, in one launch. Returns (dp, dx, cand t, cand q, cand X)."""
    b = BABinding(problem, opts, scalars, own=False)
    b.use_built(built)
    b.step()
    return b.candidate


def ba_commit_cuda(problem, scalars: torch.Tensor, candidate, opts) -> None:
    """K12 alone: ``backend.ba.ba_commit_plain`` on ``candidate`` (K11's
    outputs), writing the next state into ``problem``'s poses and points
    and into ``scalars`` in place, in one launch."""
    b = BABinding(problem, opts, scalars, own=False)
    b.use_candidate(candidate)
    b.commit()
