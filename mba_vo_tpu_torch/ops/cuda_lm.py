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

Their plain versions are ``solver/lm.py``'s ``lm_step_plain``,
``lm_decide_plain`` and ``lm_commit_plain``, which CPU tensors take;
``solver/lm.py``'s ``lm_step``, ``lm_decide`` and ``lm_commit`` choose by
the tensors' device. The wrappers take CUDA tensors only and raise on
anything else; they never fall back to the plain versions. The library is
built and loaded by ``ops/cuda_build.py`` at first use; nothing here runs
when the module is imported. ``LAUNCHES_LM_STEP``, ``LAUNCHES_LM_DECIDE``
and ``LAUNCHES_LM_COMMIT`` count launches, one a call; a call recorded
into a CUDA graph is not a launch and is not counted.

The state's scalars are one vector of the working dtype, indexed by the
``S_*`` constants below (``lm_step.cu`` has the same enum): the cost, the
step evaluator's six costs and its non-monotonic count, the radius, the
decrease factor and the last cost decrease (carried from one iteration to
the next), then what K6, K7 and K8 write in an iteration.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from . import cuda_build
from .cuda_residual import _check, _launch

LAUNCHES_LM_STEP = 0
LAUNCHES_LM_DECIDE = 0
LAUNCHES_LM_COMMIT = 0

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
# right-hand side and a reduction slot a thread): the 227 KiB a block may
# opt into, less room for the kernel's static shared memory; beyond it the
# factor lives in a global scratch matrix the wrapper allocates, in the same
# kernel
STEP_SMEM_LIMIT = 232448 - 1024
LM_THREADS = 256

_loaded: Dict[str, ctypes.CDLL] = {}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # H, g, scalars, knot t, knot q, H1, step, cand t, cand q, scratch, D, K,
    # shared bytes, stream
    "lm_step": [_P] * 10 + [_I, _I, _I, _P],
    # cost, patch, kp_w, kp_mask, scalars, prior cost, mask out, kp_w out,
    # F, N, P, chi_k, min_step_quality, stream
    "lm_decide": [_P] * 8 + [_I, _I, _I, _D, _D, _P],
    # t, q, H, g, scalars, mask, kp_w, patch_costs, H1, cand t, cand q, cost,
    # g_raw, H_raw, patch, new mask, new kp_w, prior cost, prior g, prior H,
    # D, K, F, N, P, max_nonmono, retry, more, min_radius, max_radius,
    # min_acd, stream
    "lm_commit": [_P] * 20 + [_I] * 8 + [_D, _D, _D, _P],
}


def step_rest_bytes(D: int, itemsize: int) -> int:
    """K6's shared memory besides the factor: the right-hand side and the
    refinement's residual [D] each and a reduction slot a thread."""
    return (2 * D + LM_THREADS) * itemsize


def step_smem_bytes(D: int, itemsize: int) -> int:
    """K6's shared memory at D unknowns: the factor [D, D], two vectors [D]
    and a reduction slot a thread; 0 when that exceeds
    :data:`STEP_SMEM_LIMIT` (the factor then lives in global memory, and
    shared memory holds the rest, :func:`step_rest_bytes`)."""
    rest = step_rest_bytes(D, itemsize)
    full = D * D * itemsize + rest
    return full if full <= STEP_SMEM_LIMIT else 0


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


def zero_launch_counts() -> None:
    global LAUNCHES_LM_STEP, LAUNCHES_LM_DECIDE, LAUNCHES_LM_COMMIT
    LAUNCHES_LM_STEP = LAUNCHES_LM_DECIDE = LAUNCHES_LM_COMMIT = 0


def lm_step_cuda(H: torch.Tensor, g: torch.Tensor, scalars: torch.Tensor, t: torch.Tensor,
                 q: torch.Tensor):
    """K6: ``solver.lm.lm_step_plain`` with the Cholesky solve, in one launch
    of one CTA. H [D, D], g [D], scalars [S_SIZE], t [K, 3], q [K, 4] with
    D = 6K, one float dtype, contiguous, on one device. Returns (H1, step,
    candidate t, candidate q, scalars); MCC and INVALID are written into
    ``scalars`` in place."""
    global LAUNCHES_LM_STEP
    who = "lm_step_cuda"
    K = t.shape[0] if t.dim() == 2 else None
    D = 6 * K if K is not None else None
    dtype = _check(who, dict(H=H, g=g, scalars=scalars, t=t, q=q),
                   dict(H=(D, D), g=(D,), scalars=(S_SIZE,), t=(K, 3), q=(K, 4)))
    if K < 1:
        raise ValueError(f"{who}: no knots")
    H1, step = torch.empty_like(H), torch.empty_like(g)
    cand_t, cand_q = torch.empty_like(t), torch.empty_like(q)
    smem = step_smem_bytes(D, H.element_size())
    scratch = None if smem else torch.empty_like(H)
    if not smem:
        smem = step_rest_bytes(D, H.element_size())
    LAUNCHES_LM_STEP += _launch(
        _entry("lm_step", dtype), H.device, H.data_ptr(), g.data_ptr(), scalars.data_ptr(),
        t.data_ptr(), q.data_ptr(), H1.data_ptr(), step.data_ptr(), cand_t.data_ptr(),
        cand_q.data_ptr(), _ptr(scratch), D, K, smem)
    return H1, step, cand_t, cand_q, scalars


def lm_decide_cuda(cost: torch.Tensor, patch: torch.Tensor, kp_w: torch.Tensor,
                   kp_mask: torch.Tensor, scalars: torch.Tensor, P: int, chi_k: float,
                   min_step_quality: float, prior_cost: Optional[torch.Tensor] = None):
    """K7: ``solver.lm.lm_decide_plain`` in one launch of one CTA. cost
    (0-dim, K3's raw sum at the candidate under ``kp_w``), patch [F, N],
    kp_w and kp_mask [N], scalars [S_SIZE], the prior's cost (0-dim) or
    None. Returns (scalars, new mask [N], new kp_w [N]); CAND_COST,
    QUALITY, SUCCESS, ACD_NEW, MU and SIGMA are written into ``scalars``."""
    global LAUNCHES_LM_DECIDE
    who = "lm_decide_cuda"
    F, N = patch.shape if patch.dim() == 2 else (None, None)
    tensors = dict(cost=cost, patch=patch, kp_w=kp_w, kp_mask=kp_mask, scalars=scalars)
    shapes = dict(cost=(), patch=(F, N), kp_w=(N,), kp_mask=(N,), scalars=(S_SIZE,))
    if prior_cost is not None:
        tensors["prior_cost"], shapes["prior_cost"] = prior_cost, ()
    dtype = _check(who, tensors, shapes)
    if P < 1 or F < 1:
        raise ValueError(f"{who}: {F} frames, {P} pattern pixels")
    mask, new_w = torch.empty_like(kp_w), torch.empty_like(kp_w)
    LAUNCHES_LM_DECIDE += _launch(
        _entry("lm_decide", dtype), cost.device, cost.data_ptr(), patch.data_ptr(),
        kp_w.data_ptr(), kp_mask.data_ptr(), scalars.data_ptr(), _ptr(prior_cost),
        mask.data_ptr(), new_w.data_ptr(), F, N, int(P), float(chi_k),
        float(min_step_quality))
    return scalars, mask, new_w


def lm_commit_cuda(t, q, H, g, scalars, mask, kp_w, patch_costs, H1, cand_t, cand_q,
                   cost, g_raw, H_raw, patch, new_mask, new_kp_w, P: int, *,
                   min_radius: float, max_radius: float, max_nonmono: int, retry: bool,
                   min_acd: float, more: bool, prior=None) -> None:
    """K8: ``solver.lm.lm_commit_plain`` in one launch of one CTA, writing
    the next state into t [K, 3], q [K, 4], H [D, D], g [D], scalars, mask
    [N], kp_w [N] and patch_costs [F, N] in place. From K6: H1 and the
    candidate knots; from K3 under the new weights: cost (0-dim), g_raw,
    H_raw, patch [F, N]; from K7: new_mask, new_kp_w; ``prior``: the
    prior's (cost, g, H) at the candidate or None."""
    global LAUNCHES_LM_COMMIT
    who = "lm_commit_cuda"
    K = t.shape[0] if t.dim() == 2 else None
    D = 6 * K if K is not None else None
    F, N = patch.shape if patch.dim() == 2 else (None, None)
    tensors = dict(t=t, q=q, H=H, g=g, scalars=scalars, mask=mask, kp_w=kp_w,
                   patch_costs=patch_costs, H1=H1, cand_t=cand_t, cand_q=cand_q, cost=cost,
                   g_raw=g_raw, H_raw=H_raw, patch=patch, new_mask=new_mask,
                   new_kp_w=new_kp_w)
    shapes = dict(t=(K, 3), q=(K, 4), H=(D, D), g=(D,), scalars=(S_SIZE,), mask=(N,),
                  kp_w=(N,), patch_costs=(F, N), H1=(D, D), cand_t=(K, 3), cand_q=(K, 4),
                  cost=(), g_raw=(D,), H_raw=(D, D), patch=(F, N), new_mask=(N,),
                  new_kp_w=(N,))
    if prior is not None:
        tensors.update(prior_cost=prior[0], prior_g=prior[1], prior_H=prior[2])
        shapes.update(prior_cost=(), prior_g=(D,), prior_H=(D, D))
    dtype = _check(who, tensors, shapes)
    pc, pg, pH = (None, None, None) if prior is None else prior
    LAUNCHES_LM_COMMIT += _launch(
        _entry("lm_commit", dtype), H.device,
        *(x.data_ptr() for x in (t, q, H, g, scalars, mask, kp_w, patch_costs, H1, cand_t,
                                 cand_q, cost, g_raw, H_raw, patch, new_mask, new_kp_w)),
        _ptr(pc), _ptr(pg), _ptr(pH), D, K, F, N, int(P), int(max_nonmono), int(bool(retry)),
        int(bool(more)), float(min_radius), float(max_radius), float(min_acd))
