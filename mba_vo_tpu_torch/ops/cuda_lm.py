"""Bind and launch the LM iteration's kernels K6-K8.

``csrc/lm_step.cu`` replaces the body of the LM ``lax.while_loop`` in
``mba_vo_tpu/solver/lm.py`` (``optimize_level``'s ``body``, ``:373-465``),
which XLA fuses with its two ``lax.cond``s into one device program (no
Pallas source). The residual evaluation between the stages stays K5, K2,
K1 or K4 and K3:

  * K6 :func:`lm_step_cuda`: damp H, solve H1 x = g by Cholesky, step =
    -x, the model cost change and the invalid flag, the candidate knots
    (the knots retracted by the step; the knots themselves when the step is
    invalid);
  * K7 :func:`lm_decide_cuda`: assemble's scaling of K3's cost sums at the
    candidate, the step quality, success, the cost decrease and the
    re-detected outlier mask;
  * K8 :func:`lm_commit_cuda`: the next state (accepted, rejected or
    invalid, chosen by selects) and the loop's continue flag, in place.

Each has two designs. The LM launches the shuffle design of K6
(:func:`lm_step_cuda`: no round trip through one thread, the sweeps by
shuffles in one warp up to D = 64, :func:`step_layout`), the keypoint
design of K7 (:func:`lm_decide_cuda`: a thread a keypoint,
:func:`decide_threads`) and the staged design of K8 (:func:`lm_commit_cuda`:
every load in one first batch, each warp's own residual count, no
barrier, :data:`LM_THREADS` threads); the earlier block designs,
:func:`lm_step_block_cuda`, :func:`lm_decide_block_cuda` and
:func:`lm_commit_block_cuda`, are launched by the harness only, to be
compared and timed beside them. Both K6 designs and both K8 designs give
the same bits.

K8's host call: :func:`lm_commit_cuda` checks its 17 to 20 tensors on
every call. The LM binds each level's state once instead
(:class:`CommitBinding`, made by ``solver/lm.py``'s ``optimize_level``):
the 8 tensors of the state, which K8 updates in place, are checked when
bound and kept, and each call checks only the 9 to 12 tensors that are new
in the iteration.

Their plain versions are ``solver/lm.py``'s ``lm_step_plain``,
``lm_decide_plain`` and ``lm_commit_plain``, which CPU tensors take;
``solver/lm.py``'s ``lm_step``, ``lm_decide`` and ``lm_commit`` choose by
the tensors' device. The wrappers take CUDA tensors only and raise on
anything else; they never fall back to the plain versions. The library is
built and loaded by ``ops/cuda_build.py`` at first use; nothing here runs
when the module is imported. ``LAUNCHES_LM_STEP``, ``LAUNCHES_LM_DECIDE``
and ``LAUNCHES_LM_COMMIT`` count launches, one a call
(``LAUNCHES_LM_STEP_BLOCK``, ``LAUNCHES_LM_DECIDE_BLOCK`` and
``LAUNCHES_LM_COMMIT_BLOCK`` those of the block designs); a call recorded into a CUDA graph is not a launch and is
not counted.

K9, :func:`knot_prior_cuda` (``csrc/knot_prior.cu``, its own library):
the joint path's knot prior, its cost, g [6K] and H [6K, 6K] at the
candidate knots in one launch of one CTA (``solver/lm.py``'s
``knot_prior_plain``, in closed form, is its plain version), counted in
``LAUNCHES_KNOT_PRIOR``. A :class:`CommitBinding` made with ``prior=True``
owns three buffers for it: the LM's K9 writes them every iteration
(:meth:`CommitBinding.knot_prior`, the knots checked) and K8 reads them
unchecked.

The state's scalars are one vector of the working dtype, indexed by the
``S_*`` constants below (``lm_step.cu`` has the same enum): the cost, the
step evaluator's six costs and its non-monotonic count, the radius, the
decrease factor and the last cost decrease (carried from one iteration to
the next), then what K6, K7 and K8 write in an iteration.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import torch

from . import cuda_build
from .cuda_residual import _check, _launch

LAUNCHES_LM_STEP = 0
LAUNCHES_LM_DECIDE = 0
LAUNCHES_LM_COMMIT = 0
LAUNCHES_LM_STEP_BLOCK = 0
LAUNCHES_LM_DECIDE_BLOCK = 0
LAUNCHES_LM_COMMIT_BLOCK = 0
LAUNCHES_KNOT_PRIOR = 0

# the scalars vector: carried state
S_COST, S_MIN, S_CUR, S_REF, S_CAND, S_ACC_REF, S_ACC_CAND, S_NONMONO = range(8)
S_RADIUS, S_DECREASE, S_ACD = 8, 9, 10
# written by K6
S_MCC, S_INVALID = 11, 12
# written by K7
S_CAND_COST, S_QUALITY, S_SUCCESS, S_ACD_NEW, S_MU, S_SIGMA = 13, 14, 15, 16, 17, 18
# written by K8
S_CONTINUE = 19
S_SIZE = 20

# K6 keeps the factor in shared memory up to this many bytes (with the
# right-hand side and the other vectors): the 227 KiB a block may opt into,
# less room for the kernel's static shared memory; beyond it the factor
# lives in a global scratch matrix the wrapper allocates, in the same
# kernel
STEP_SMEM_LIMIT = 232448 - 1024
# the threads of K6's and K8's designs and of K7's block design
LM_THREADS = 256
# the width of the tree both K6 designs sum the model change over
# (lm_step.cu's kTree; residual_kernels.block_sum transcribes it)
LM_TREE = 256
# K6's shuffle design runs its sweeps in one warp, two rows a lane, up to
# this many unknowns (lm_step.cu's kWarpStepMaxD), on all LM_THREADS
# threads above
WARP_STEP_MAX_D = 64
# K7's keypoint design: a thread a keypoint up to this many
DECIDE_MAX_THREADS = 512

_loaded: Dict[str, ctypes.CDLL] = {}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # H, g, scalars, knot t, knot q, H1, step, cand t, cand q, scratch, D, K,
    # H1 copied to shared memory (0 or 1), shared bytes, stream
    "lm_step": [_P] * 10 + [_I, _I, _I, _I, _P],
    # the block design: the same without the H1 flag
    "lm_step_block": [_P] * 10 + [_I, _I, _I, _P],
    # cost, patch, kp_w, kp_mask, scalars, prior cost, mask out, kp_w out,
    # F, N, P, chi_k, min_step_quality, threads, stream
    "lm_decide": [_P] * 8 + [_I, _I, _I, _D, _D, _I, _P],
    # the block design: the same without the threads
    "lm_decide_block": [_P] * 8 + [_I, _I, _I, _D, _D, _P],
    # t, q, H, g, scalars, mask, kp_w, patch_costs, H1, cand t, cand q, cost,
    # g_raw, H_raw, patch, new mask, new kp_w, prior cost, prior g, prior H,
    # D, K, F, N, P, max_nonmono, retry, more, min_radius, max_radius,
    # min_acd, stream (both designs)
    "lm_commit": [_P] * 20 + [_I] * 8 + [_D, _D, _D, _P],
    "lm_commit_block": [_P] * 20 + [_I] * 8 + [_D, _D, _D, _P],
}


def step_rest_bytes(D: int, itemsize: int) -> int:
    """K6's block design's shared memory besides the factor: the
    right-hand side and the refinement's residual [D] each and a reduction
    slot a thread."""
    return (2 * D + LM_THREADS) * itemsize


def step_smem_bytes(D: int, itemsize: int) -> int:
    """K6's block design's shared memory at D unknowns: the factor [D, D],
    two vectors [D] and a reduction slot a thread; 0 when that exceeds
    :data:`STEP_SMEM_LIMIT` (the factor then lives in global memory, and
    shared memory holds the rest, :func:`step_rest_bytes`)."""
    rest = step_rest_bytes(D, itemsize)
    full = D * D * itemsize + rest
    return full if full <= STEP_SMEM_LIMIT else 0


def step_ld(D: int) -> int:
    """The row stride of K6's shuffle design's factor: D rounded up to an odd
    count, so that a warp's lanes on consecutive rows of one column hit
    distinct shared-memory banks (``lm_step.cu``'s ``factor_ld``)."""
    return D | 1


class StepLayout(NamedTuple):
    smem: int         # dynamic shared bytes
    shared: bool      # the factor [D, step_ld(D)] in shared memory, else a global scratch
    shared_h1: bool   # a copy of H1 [D, step_ld(D)] in shared memory, else H1 read back


def step_layout(D: int, itemsize: int) -> StepLayout:
    """K6's shuffle design's shared memory at D unknowns (LM_THREADS
    threads): four vectors [D] (the right-hand side, the forward sweeps'
    results, the solution and the pivots' square roots), the factor [D,
    :func:`step_ld`] where it fits :data:`STEP_SMEM_LIMIT` with them, and
    a copy of H1 of the same shape where that fits too (the refinement's
    residual and the model change read it; else they read H1 back from
    global memory). The kernel refuses any other."""
    vectors = 4 * D * itemsize
    matrix = D * step_ld(D) * itemsize
    if 2 * matrix + vectors <= STEP_SMEM_LIMIT:
        return StepLayout(2 * matrix + vectors, True, True)
    if matrix + vectors <= STEP_SMEM_LIMIT:
        return StepLayout(matrix + vectors, True, False)
    return StepLayout(vectors, False, False)


def decide_threads(N: int) -> int:
    """K7's keypoint design's threads at N keypoints: a keypoint a thread,
    in whole warps, up to :data:`DECIDE_MAX_THREADS` (more keypoints loop)."""
    return min(DECIDE_MAX_THREADS, 32 * max(1, -(-N // 32)))


def _entry(name: str, dtype: torch.dtype):
    if "lm_step" not in _loaded:
        lib = cuda_build.load("lm_step")
        for fn_name, signature in _SIGNATURES.items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{fn_name}_{suffix}")
                fn.argtypes, fn.restype = signature, ctypes.c_int
        query = lib.lm_scalars_size
        query.argtypes, query.restype = [], ctypes.c_int
        if query() != S_SIZE:
            raise RuntimeError(f"lm_step.cu lays out {query()} scalars, not {S_SIZE}")
        _loaded["lm_step"] = lib
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(_loaded["lm_step"], f"{name}_{suffix}")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def launch_counts() -> Dict[str, int]:
    """The launches of K6-K8 by the name of their dispatcher in
    ``solver/lm.py``."""
    return {"lm_step": LAUNCHES_LM_STEP, "lm_decide": LAUNCHES_LM_DECIDE,
            "lm_commit": LAUNCHES_LM_COMMIT}


def earlier_launch_counts() -> Dict[str, int]:
    """The launches of the earlier block designs of K6-K8, which no path of the
    tracker launches, keyed as :func:`launch_counts` keys the designs it
    launches."""
    return {"lm_step": LAUNCHES_LM_STEP_BLOCK, "lm_decide": LAUNCHES_LM_DECIDE_BLOCK,
            "lm_commit": LAUNCHES_LM_COMMIT_BLOCK}


def zero_launch_counts() -> None:
    global LAUNCHES_LM_STEP, LAUNCHES_LM_DECIDE, LAUNCHES_LM_COMMIT, LAUNCHES_KNOT_PRIOR
    global LAUNCHES_LM_STEP_BLOCK, LAUNCHES_LM_DECIDE_BLOCK, LAUNCHES_LM_COMMIT_BLOCK
    LAUNCHES_LM_STEP = LAUNCHES_LM_DECIDE = LAUNCHES_LM_COMMIT = LAUNCHES_KNOT_PRIOR = 0
    LAUNCHES_LM_STEP_BLOCK = LAUNCHES_LM_DECIDE_BLOCK = LAUNCHES_LM_COMMIT_BLOCK = 0


def _step_check(who, H, g, scalars, t, q):
    K = t.shape[0] if t.dim() == 2 else None
    D = 6 * K if K is not None else None
    dtype = _check(who, dict(H=H, g=g, scalars=scalars, t=t, q=q),
                   dict(H=(D, D), g=(D,), scalars=(S_SIZE,), t=(K, 3), q=(K, 4)))
    if K < 1:
        raise ValueError(f"{who}: no knots")
    return dtype, D, K


def lm_step_cuda(H: torch.Tensor, g: torch.Tensor, scalars: torch.Tensor, t: torch.Tensor,
                 q: torch.Tensor):
    """K6: ``solver.lm.lm_step_plain`` with the Cholesky solve, in one launch
    of one CTA (the shuffle design, :func:`step_layout`). H [D, D], g [D],
    scalars [S_SIZE], t [K, 3], q [K, 4] with D = 6K, one float dtype,
    contiguous, on one device. Returns (H1, step, candidate t, candidate q,
    scalars); MCC and INVALID are written into ``scalars`` in place."""
    global LAUNCHES_LM_STEP
    dtype, D, K = _step_check("lm_step_cuda", H, g, scalars, t, q)
    H1, step = torch.empty_like(H), torch.empty_like(g)
    cand_t, cand_q = torch.empty_like(t), torch.empty_like(q)
    layout = step_layout(D, H.element_size())
    scratch = None if layout.shared else H.new_empty(D * step_ld(D))
    LAUNCHES_LM_STEP += _launch(
        _entry("lm_step", dtype), H.device, H.data_ptr(), g.data_ptr(), scalars.data_ptr(),
        t.data_ptr(), q.data_ptr(), H1.data_ptr(), step.data_ptr(), cand_t.data_ptr(),
        cand_q.data_ptr(), _ptr(scratch), D, K, int(layout.shared_h1), layout.smem)
    return H1, step, cand_t, cand_q, scalars


def lm_step_block_cuda(H: torch.Tensor, g: torch.Tensor, scalars: torch.Tensor,
                       t: torch.Tensor, q: torch.Tensor):
    """K6's block design (PR 12's): :func:`lm_step_cuda`'s arguments and
    results, the same bits; 256 threads, thread 0 taking each pivot and
    row. Launched by the harness only."""
    global LAUNCHES_LM_STEP_BLOCK
    dtype, D, K = _step_check("lm_step_block_cuda", H, g, scalars, t, q)
    H1, step = torch.empty_like(H), torch.empty_like(g)
    cand_t, cand_q = torch.empty_like(t), torch.empty_like(q)
    smem = step_smem_bytes(D, H.element_size())
    scratch = None if smem else torch.empty_like(H)
    if not smem:
        smem = step_rest_bytes(D, H.element_size())
    LAUNCHES_LM_STEP_BLOCK += _launch(
        _entry("lm_step_block", dtype), H.device, H.data_ptr(), g.data_ptr(),
        scalars.data_ptr(), t.data_ptr(), q.data_ptr(), H1.data_ptr(), step.data_ptr(),
        cand_t.data_ptr(), cand_q.data_ptr(), _ptr(scratch), D, K, smem)
    return H1, step, cand_t, cand_q, scalars


def _decide_check(who, cost, patch, kp_w, kp_mask, scalars, P, prior_cost):
    F, N = patch.shape if patch.dim() == 2 else (None, None)
    tensors = dict(cost=cost, patch=patch, kp_w=kp_w, kp_mask=kp_mask, scalars=scalars)
    shapes = dict(cost=(), patch=(F, N), kp_w=(N,), kp_mask=(N,), scalars=(S_SIZE,))
    if prior_cost is not None:
        tensors["prior_cost"], shapes["prior_cost"] = prior_cost, ()
    dtype = _check(who, tensors, shapes)
    if P < 1 or F < 1:
        raise ValueError(f"{who}: {F} frames, {P} pattern pixels")
    return dtype, F, N


def lm_decide_cuda(cost: torch.Tensor, patch: torch.Tensor, kp_w: torch.Tensor,
                   kp_mask: torch.Tensor, scalars: torch.Tensor, P: int, chi_k: float,
                   min_step_quality: float, prior_cost: Optional[torch.Tensor] = None):
    """K7: ``solver.lm.lm_decide_plain`` in one launch of one CTA (the
    keypoint design, :func:`decide_threads`). cost (0-dim, K3's raw sum at
    the candidate under ``kp_w``), patch [F, N], kp_w and kp_mask [N],
    scalars [S_SIZE], the prior's cost (0-dim) or None. Returns (scalars,
    new mask [N], new kp_w [N]); CAND_COST, QUALITY, SUCCESS, ACD_NEW, MU
    and SIGMA are written into ``scalars``."""
    global LAUNCHES_LM_DECIDE
    dtype, F, N = _decide_check("lm_decide_cuda", cost, patch, kp_w, kp_mask, scalars, P,
                                prior_cost)
    mask, new_w = torch.empty_like(kp_w), torch.empty_like(kp_w)
    LAUNCHES_LM_DECIDE += _launch(
        _entry("lm_decide", dtype), cost.device, cost.data_ptr(), patch.data_ptr(),
        kp_w.data_ptr(), kp_mask.data_ptr(), scalars.data_ptr(), _ptr(prior_cost),
        mask.data_ptr(), new_w.data_ptr(), F, N, int(P), float(chi_k),
        float(min_step_quality), decide_threads(N))
    return scalars, mask, new_w


def lm_decide_block_cuda(cost: torch.Tensor, patch: torch.Tensor, kp_w: torch.Tensor,
                         kp_mask: torch.Tensor, scalars: torch.Tensor, P: int, chi_k: float,
                         min_step_quality: float, prior_cost: Optional[torch.Tensor] = None):
    """K7's block design (PR 12's): :func:`lm_decide_cuda`'s arguments and
    results; 256 threads. Launched by the harness only."""
    global LAUNCHES_LM_DECIDE_BLOCK
    dtype, F, N = _decide_check("lm_decide_block_cuda", cost, patch, kp_w, kp_mask, scalars,
                                P, prior_cost)
    mask, new_w = torch.empty_like(kp_w), torch.empty_like(kp_w)
    LAUNCHES_LM_DECIDE_BLOCK += _launch(
        _entry("lm_decide_block", dtype), cost.device, cost.data_ptr(), patch.data_ptr(),
        kp_w.data_ptr(), kp_mask.data_ptr(), scalars.data_ptr(), _ptr(prior_cost),
        mask.data_ptr(), new_w.data_ptr(), F, N, int(P), float(chi_k),
        float(min_step_quality))
    return scalars, mask, new_w


# K9's entries: t, q, cost, g, H, K, weight, shared bytes, stream
_PRIOR_SIGNATURE = [_P] * 5 + [_I, _D, _I, _P]
# the threads of K9's one CTA (knot_prior.cu's kThreads)
PRIOR_THREADS = 512


def _prior_entry(dtype: torch.dtype):
    if "knot_prior" not in _loaded:
        lib = cuda_build.load("knot_prior")
        for suffix in ("f32", "f64"):
            fn = getattr(lib, f"knot_prior_{suffix}")
            fn.argtypes, fn.restype = _PRIOR_SIGNATURE, ctypes.c_int
        _loaded["knot_prior"] = lib
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(_loaded["knot_prior"], f"knot_prior_{suffix}")


def prior_smem_bytes(K: int, itemsize: int) -> int:
    """K9's dynamic shared memory at K knots: the translations [K, 3]; for
    each of the K - 1 consecutive knot pairs the relative rotation's log w
    [3], Jr^-1(w) [3, 3] and Jr^-1(w) R^T [3, 3]; for each of the K - 2
    prior blocks its three 3 x 3 Jacobian blocks and its 6 residuals
    (``knot_prior.cu``'s layout; the kernel refuses any other size)."""
    return (3 * K + 21 * (K - 1) + 33 * (K - 2)) * itemsize


def _knots_check(who, t, q):
    K = t.shape[0] if t.dim() == 2 else None
    dtype = _check(who, dict(t=t, q=q), dict(t=(K, 3), q=(K, 4)))
    if K < 3:
        raise ValueError(f"{who}: {K} knots; the prior needs at least 3")
    return dtype, K


def _launch_prior(device, dtype, t, q, out, K: int, weight: float) -> int:
    # K9 writes 0 off the prior's band, the plain version weight * 0: one
    # sign of zero at a positive weight, where the prior is on
    if not weight > 0.0:
        raise ValueError(f"knot prior: weight {weight}; K9 runs where the prior is on, at a "
                         f"positive weight")
    cost, g, H = out
    return _launch(_prior_entry(dtype), device, t.data_ptr(), q.data_ptr(), cost.data_ptr(),
                   g.data_ptr(), H.data_ptr(), K, float(weight),
                   prior_smem_bytes(K, t.element_size()))


def prior_buffers(t: torch.Tensor):
    """K9's outputs at the knots ``t`` [K, 3]'s count, dtype and device:
    (cost [], g [6K], H [6K, 6K]), uninitialised."""
    D = 6 * t.shape[0]
    return t.new_empty(()), t.new_empty(D), t.new_empty((D, D))


def knot_prior_cuda(t: torch.Tensor, q: torch.Tensor, weight: float):
    """K9: ``solver.lm.knot_prior_plain`` in one launch of one CTA. t [K, 3]
    and q [K, 4] (K >= 3), one float dtype, contiguous, on one device; the
    weight positive; returns new tensors (cost [], g [6K], H [6K, 6K])."""
    global LAUNCHES_KNOT_PRIOR
    dtype, K = _knots_check("knot_prior_cuda", t, q)
    out = prior_buffers(t)
    LAUNCHES_KNOT_PRIOR += _launch_prior(t.device, dtype, t, q, out, K, weight)
    return out


_STATE = ("t", "q", "H", "g", "scalars", "mask", "kp_w", "patch_costs")
_CALL = ("H1", "cand_t", "cand_q", "cost", "g_raw", "H_raw", "patch", "new_mask", "new_kp_w")
_PRIOR = ("prior_cost", "prior_g", "prior_H")


def _commit_shapes(K, F, N) -> Dict[str, tuple]:
    """K8's tensors' shapes at K knots (D = 6K), F frames and N keypoints
    (None: not known, any size there)."""
    D = None if K is None else 6 * K
    return dict(t=(K, 3), q=(K, 4), H=(D, D), g=(D,), scalars=(S_SIZE,), mask=(N,),
                kp_w=(N,), patch_costs=(F, N), H1=(D, D), cand_t=(K, 3), cand_q=(K, 4),
                cost=(), g_raw=(D,), H_raw=(D, D), patch=(F, N), new_mask=(N,), new_kp_w=(N,),
                prior_cost=(), prior_g=(D,), prior_H=(D, D))


def _commit_check(who, state, call, prior):
    """Every tensor of a K8 call checked (:func:`_check`); returns (dtype,
    D, K, F, N)."""
    t, patch = state[0], call[6]
    K = t.shape[0] if t.dim() == 2 else None
    F, N = patch.shape if patch.dim() == 2 else (None, None)
    tensors = dict(zip(_STATE + _CALL, tuple(state) + tuple(call)))
    if prior is not None:
        tensors.update(zip(_PRIOR, prior))
    shapes = _commit_shapes(K, F, N)
    dtype = _check(who, tensors, {k: shapes[k] for k in tensors})
    return dtype, 6 * K, K, F, N


def _commit_options(P, max_nonmono, retry, more, min_radius, max_radius, min_acd):
    return (int(P), int(max_nonmono), int(bool(retry)), int(bool(more)), float(min_radius),
            float(max_radius), float(min_acd))


def lm_commit_cuda(t, q, H, g, scalars, mask, kp_w, patch_costs, H1, cand_t, cand_q,
                   cost, g_raw, H_raw, patch, new_mask, new_kp_w, P: int, *,
                   min_radius: float, max_radius: float, max_nonmono: int, retry: bool,
                   min_acd: float, more: bool, prior=None) -> None:
    """K8: ``solver.lm.lm_commit_plain`` in one launch of one CTA (the
    staged design), writing the next state into t [K, 3], q [K, 4], H [D,
    D], g [D], scalars, mask [N], kp_w [N] and patch_costs [F, N] in place.
    From K6:
    H1 and the candidate knots; from K3 under the new weights: cost
    (0-dim), g_raw, H_raw, patch [F, N]; from K7: new_mask, new_kp_w;
    ``prior``: the prior's (cost, g, H) at the candidate or None. Checks
    every tensor on every call; the LM's calls go through a
    :class:`CommitBinding` instead (``solver.lm.lm_commit``'s ``binding``)."""
    global LAUNCHES_LM_COMMIT
    state = (t, q, H, g, scalars, mask, kp_w, patch_costs)
    call = (H1, cand_t, cand_q, cost, g_raw, H_raw, patch, new_mask, new_kp_w)
    dtype, D, K, F, N = _commit_check("lm_commit_cuda", state, call, prior)
    pc, pg, pH = (None, None, None) if prior is None else prior
    LAUNCHES_LM_COMMIT += _launch(
        _entry("lm_commit", dtype), H.device, *(x.data_ptr() for x in state + call),
        _ptr(pc), _ptr(pg), _ptr(pH), D, K, F, N,
        *_commit_options(P, max_nonmono, retry, more, min_radius, max_radius, min_acd))


def lm_commit_block_cuda(t, q, H, g, scalars, mask, kp_w, patch_costs, H1, cand_t, cand_q,
                         cost, g_raw, H_raw, patch, new_mask, new_kp_w, P: int, *,
                         min_radius: float, max_radius: float, max_nonmono: int, retry: bool,
                         min_acd: float, more: bool, prior=None) -> None:
    """K8's earlier block design: :func:`lm_commit_cuda`'s arguments and
    results, the same bits; 256 threads, three dependent trips to memory.
    Launched by the harness only."""
    global LAUNCHES_LM_COMMIT_BLOCK
    state = (t, q, H, g, scalars, mask, kp_w, patch_costs)
    call = (H1, cand_t, cand_q, cost, g_raw, H_raw, patch, new_mask, new_kp_w)
    dtype, D, K, F, N = _commit_check("lm_commit_block_cuda", state, call, prior)
    pc, pg, pH = (None, None, None) if prior is None else prior
    LAUNCHES_LM_COMMIT_BLOCK += _launch(
        _entry("lm_commit_block", dtype), H.device, *(x.data_ptr() for x in state + call),
        _ptr(pc), _ptr(pg), _ptr(pH), D, K, F, N,
        *_commit_options(P, max_nonmono, retry, more, min_radius, max_radius, min_acd))


class CommitBinding:
    """K8's host call bound to one LM level's state: :func:`lm_commit_cuda`
    with the state's checks made once.

    ``state``: the level's ``LMState`` (t, q, H, g, scalars, mask, kp_w,
    patch_costs), which K8 updates in place; checked here for device,
    dtype, contiguity and shape (:func:`_check`, raising as it raises) and
    kept, references and pointers, with D, K, F, N, ``P``, the options
    (:func:`lm_commit_cuda`'s keywords) and the library's entry. A call
    takes the state again and the iteration's new tensors, checks each of
    those for the state's device and dtype, contiguity and its shape, and
    raises on the first that fails, before anything launches; a state
    whose tensors are not the bound ones (replaced, not updated in place)
    is bound again first. One launch a call, counted in
    ``LAUNCHES_LM_COMMIT``.

    With ``prior`` the binding also owns K9's outputs, ``prior_out`` (cost
    [], g [D], H [D, D], :func:`prior_buffers`), allocated when it binds:
    :meth:`knot_prior` launches K9 into them, and a call given them as its
    ``prior`` (the very tuple) passes them to K8 without a check."""

    def __init__(self, state, P: int, *, min_radius: float, max_radius: float,
                 max_nonmono: int, retry: bool, min_acd: float, prior: bool = False):
        self._options = (int(P), int(max_nonmono), int(bool(retry)))
        self._radii = (float(min_radius), float(max_radius), float(min_acd))
        self._with_prior = bool(prior)
        self.bind(state)

    def bind(self, state) -> None:
        """Check the state's 8 tensors and keep them (and, with the prior,
        allocate its buffers for them)."""
        state = tuple(state)
        t, patch_costs = state[0], state[7]
        K = t.shape[0] if t.dim() == 2 else None
        F, N = patch_costs.shape if patch_costs.dim() == 2 else (None, None)
        shapes = _commit_shapes(K, F, N)
        dtype = _check("CommitBinding", dict(zip(_STATE, state)),
                       {k: shapes[k] for k in _STATE})
        self.state = state
        self._ptrs = tuple(x.data_ptr() for x in state)
        self._device, self._index, self._dtype = t.device, t.get_device(), dtype
        self._dims = (6 * K, K, F, N)
        self._shapes = tuple(shapes[k] for k in _CALL + _PRIOR)
        self._fn = _entry("lm_commit", dtype)
        self.prior_out = prior_buffers(t) if self._with_prior else None
        if self._with_prior:
            self._prior_ptrs = tuple(x.data_ptr() for x in self.prior_out)

    def knot_prior(self, t: torch.Tensor, q: torch.Tensor, weight: float):
        """K9 at the knots t [K, 3], q [K, 4] (the state's K, device and
        dtype, contiguous; checked, raising before anything launches) into
        :attr:`prior_out`, which it returns. One launch, counted in
        ``LAUNCHES_KNOT_PRIOR``."""
        global LAUNCHES_KNOT_PRIOR
        if self.prior_out is None:
            raise ValueError("CommitBinding: bound without the prior's buffers")
        K = self._dims[1]
        for name, x, shape in (("t", t, (K, 3)), ("q", q, (K, 4))):
            if (x.get_device() != self._index or x.dtype is not self._dtype
                    or x.shape != shape or not x.is_contiguous()):
                # raises for x, with the state's t as the reference
                _check("CommitBinding.knot_prior", {"state t": self.state[0], name: x},
                       {"state t": (K, 3), name: shape})
                raise AssertionError("CommitBinding.knot_prior: no tensor refused")
        LAUNCHES_KNOT_PRIOR += _launch_prior(self._device, self._dtype, t, q, self.prior_out,
                                             K, weight)
        return self.prior_out

    def holds(self, state) -> bool:
        """Whether ``state``'s tensors are the bound ones."""
        return all(a is b for a, b in zip(state, self.state))

    def _refuse(self, tensors) -> None:
        """Raise for the first of ``tensors`` (:data:`_CALL`, then
        :data:`_PRIOR`) that the bound call does not take."""
        who = "CommitBinding"
        for name, x, shape in zip(_CALL + _PRIOR, tensors, self._shapes):
            if not x.is_cuda:
                raise ValueError(f"{who}: {name} is on {x.device}, not CUDA")
            if x.get_device() != self._index:
                raise ValueError(f"{who}: {name} is on {x.device}, the state on {self._device}")
            if x.dtype is not self._dtype:
                raise ValueError(f"{who}: {name} is {x.dtype}, the state {self._dtype}")
            if x.shape != shape:
                raise ValueError(f"{who}: {name} must be {list(shape)}, got {list(x.shape)}")
            if not x.is_contiguous():
                raise ValueError(f"{who}: {name} is not contiguous")
        raise AssertionError(f"{who}: no tensor refused")

    def __call__(self, state, H1, cand_t, cand_q, cost, g_raw, H_raw, patch, new_mask,
                 new_kp_w, more: bool, prior=None):
        """K8 on ``state`` (updated in place and returned) with the
        iteration's tensors: :func:`lm_commit_cuda`'s after ``patch_costs``
        but ``P`` and the options, which are bound."""
        global LAUNCHES_LM_COMMIT
        if not self.holds(state):
            self.bind(state)
        tensors = (H1, cand_t, cand_q, cost, g_raw, H_raw, patch, new_mask, new_kp_w)
        bound_prior = prior is not None and prior is self.prior_out
        if prior is not None and not bound_prior:
            tensors += tuple(prior)
            if len(tensors) != len(self._shapes):
                raise ValueError("CommitBinding: the prior is (cost, g, H)")
        index, dtype = self._index, self._dtype
        ptrs = []
        for x, shape in zip(tensors, self._shapes):
            if (x.get_device() != index or x.dtype is not dtype or x.shape != shape
                    or not x.is_contiguous()):
                self._refuse(tensors)
            ptrs.append(x.data_ptr())
        if prior is None:
            ptrs += (None, None, None)
        elif bound_prior:
            ptrs += self._prior_ptrs
        LAUNCHES_LM_COMMIT += _launch(
            self._fn, self._device, *self._ptrs, *ptrs, *self._dims, *self._options,
            int(bool(more)), *self._radii)
        return state
