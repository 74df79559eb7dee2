"""Trust-region Levenberg-Marquardt over spline control knots, as a host loop
of a fixed sequence of device stages.

Counterpart of ``mba_vo_tpu/solver/lm.py``, whose loop is one
``lax.while_loop`` with two ``lax.cond``s in its body. Here every iteration
issues the same stages in the same order, whatever the step turns out to
be, and the host reads one flag an iteration (whether to go on):

  1. :func:`lm_step` (K6): damp, solve, model cost change, invalid flag and
     the candidate knots (the current knots when the step is invalid);
  2. the residuals and the Jacobian at the candidate (``compute_rjv``) and
     K3's cost sums under the old outlier mask;
  3. the knot prior at the candidate, when on;
  4. :func:`lm_decide` (K7): the candidate's scaled cost, the step quality,
     success, the cost decrease and the re-detected outlier mask;
  5. K3's sums with J under the new mask (used only on success);
  6. :func:`lm_commit` (K8): the accepted, rejected or invalid state chosen
     by selects, and the continue flag.

An invalid step thus evaluates once at the current knots and a rejected
step runs K3 once more than the reference's branches would; both results
are discarded by the selects, as the reference never computes them. On a
CUDA tensor each stage is its kernel (``ops/cuda_lm.py``); on a CPU tensor
its plain version here (``lm_step_plain``, ``lm_decide_plain``,
``lm_commit_plain``: the same data flow as tensor ops). On the card
``optimize_level`` binds each level's state to K8 once
(``cuda_lm.CommitBinding``: the state's tensors checked when bound, each
iteration's new ones at each call). The scalars of the
state live in one vector of the working dtype, laid out by
``ops/cuda_lm.py`` (``S_*``).

Kept reference semantics, documented quirks included:
  * the damped Hessian *replaces* the carried Hessian, so consecutive
    rejected or invalid steps accumulate damping;
  * a *valid but unsuccessful* step leaves ``abs_cost_decrease`` negative,
    which ends the level at the next check (unless ``retry_rejected_steps``);
    only model-invalid steps (negative predicted decrease, or a failed
    factorisation) retry with a smaller radius;
  * on success, outliers are re-detected from the candidate's patch costs
    and the candidate's (r, J) are re-assembled under the new mask;
  * LM radius policy: init 1e4 in [10, 1e32]; accept divides by
    ``max(1/3, 1-(2q-1)^3)`` and resets the decrease factor to 2; reject
    divides by the doubling decrease factor;
  * step quality is the Conn-Gould-Toint non-monotonic relative decrease.

With ``group`` (keypoint shards, ``parallel.sharded``) every evaluation's
cost, g and H and the outlier statistics are all-reduced over the ranks
inside the stages, so the plain stages run there, on the card too; the
12x12 solve and every decision are the same on every rank, and the outlier
mask and the patch costs stay shard-local. ``solver="lu"`` and ``"svd"``
keep their eager solve (the plain step stage) on every device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch.func import jacfwd

from ..core.lie import quat_conjugate, quat_log, quat_multiply
from ..core.spline import SplineKnots, spline_retract_flat
from ..ops import cuda_lm, residual
# the state's scalars layout, used here and by the stages' callers
from ..ops.cuda_lm import (
    S_ACC_CAND, S_ACC_REF, S_ACD, S_ACD_NEW, S_CAND, S_CAND_COST, S_CONTINUE, S_COST, S_CUR,
    S_DECREASE, S_INVALID, S_MCC, S_MIN, S_MU, S_NONMONO, S_QUALITY, S_RADIUS, S_REF,
    S_SIGMA, S_SIZE, S_SUCCESS,
)
from ..ops.residual import (
    TrackingLevelData,
    compute_rjv,
    evaluate,
    inverse_residual_count,
    prepare_frame_layout,
    prepare_window_cache,
)
from ..utils.collectives import allreduce

SOLVERS = ("cholesky", "lu", "svd")


@dataclasses.dataclass(frozen=True)
class LMOptions:
    """Solver options; the fields and defaults of the reference's LMOptions.

    ``hoist_layout`` is the only switch for the per-level patch layout: the
    reference's ``MBA_VO_NO_LAYOUT_HOIST`` environment override is this
    field set to False, and the port reads no environment.
    """

    max_iterations: int = 50
    min_step_quality: float = 0.5
    min_abs_cost_decrease: float = 1e-3
    max_consecutive_nonmonotonic_steps: int = 5
    initial_radius: float = 1e4
    min_radius: float = 10.0
    max_radius: float = 1e32
    huber_a: float = 20.0
    max_chi_square_error: float = 3.0
    solver: str = "cholesky"  # "cholesky" | "lu" | "svd"
    sampling: str = "direct"  # "direct" | "windowed" (see ops.residual)
    window: int = 32
    # True = standard trust-region retry of a rejected step instead of the
    # reference's terminate-on-reject (the per-frame tracker keeps False)
    retry_rejected_steps: bool = False
    precision: str = "default"  # "default" | "highest" (see ops.residual.assemble)
    compensated_sum: bool = False
    # constant-velocity knot prior weight (0 = off; needs > 2 knots)
    knot_prior_weight: float = 0.0
    # per-frame closed-form gain/bias elimination (ops.residual.affine_correct)
    affine_brightness: bool = False
    # evaluate every iteration of a level against the level-entry patch layout
    hoist_layout: bool = False


class LMSummary(NamedTuple):
    final_cost: torch.Tensor
    num_iterations: int
    outlier_mask: torch.Tensor
    patch_costs: torch.Tensor  # [F, N] at the final accepted state


class _EvaluatorState(NamedTuple):
    """Ceres TrustRegionStepEvaluator state (0-dim tensors)."""

    minimum_cost: torch.Tensor
    current_cost: torch.Tensor
    reference_cost: torch.Tensor
    candidate_cost: torch.Tensor
    acc_reference_mcc: torch.Tensor
    acc_candidate_mcc: torch.Tensor
    num_nonmonotonic: torch.Tensor


def _evaluator_reset(cost: torch.Tensor) -> _EvaluatorState:
    z = torch.zeros_like(cost)
    n = torch.zeros((), dtype=torch.int64, device=cost.device)
    return _EvaluatorState(cost, cost, cost, cost, z, z, n)


def _step_quality(ev: _EvaluatorState, cost, model_cost_change):
    relative = (ev.current_cost - cost) / model_cost_change
    historical = (ev.reference_cost - cost) / (
        ev.acc_reference_mcc + model_cost_change
    )
    return torch.maximum(relative, historical)


def _step_accepted(ev: _EvaluatorState, cost, model_cost_change,
                   max_nonmono: int) -> _EvaluatorState:
    """Conn-Gould-Toint Algorithm 10.1.2 with Ceres' always-check step 3d."""
    zero = torch.zeros_like(cost)
    current = cost
    acc_cand = ev.acc_candidate_mcc + model_cost_change
    acc_ref = ev.acc_reference_mcc + model_cost_change

    improved = current < ev.minimum_cost
    minimum = torch.where(improved, current, ev.minimum_cost)
    nonmono = torch.where(improved, torch.zeros_like(ev.num_nonmonotonic),
                          ev.num_nonmonotonic + 1)
    worse_than_cand = current > ev.candidate_cost
    candidate = torch.where(
        improved, current, torch.where(worse_than_cand, current, ev.candidate_cost)
    )
    acc_cand = torch.where(improved | worse_than_cand, zero, acc_cand)

    hit_limit = nonmono == max_nonmono
    reference = torch.where(hit_limit, candidate, ev.reference_cost)
    acc_ref = torch.where(hit_limit, acc_cand, acc_ref)
    return _EvaluatorState(minimum, current, reference, candidate, acc_ref,
                           acc_cand, nonmono)


def _solve(H: torch.Tensor, g: torch.Tensor, kind: str) -> torch.Tensor:
    """step = -H^-1 g. A failed Cholesky factorisation gives a NaN step, as
    ``jnp.linalg.cholesky`` does (``torch.linalg.cholesky`` would raise), so
    the step is invalid."""
    if kind == "cholesky":
        L, info = torch.linalg.cholesky_ex(H)
        x = torch.cholesky_solve(g[:, None], L)[:, 0]
        x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
    elif kind == "lu":
        x = torch.linalg.solve(H, g)
    elif kind == "svd":
        x = torch.linalg.pinv(H) @ g
    else:
        raise ValueError(f"unknown solver {kind!r}")
    return -x


def _outlier_statistics(patch_costs: torch.Tensor, kp_mask: torch.Tensor, chi_k: float,
                        group=None):
    """detect_outliers' statistics: (inlier mask [N], outlier flags [N], mu,
    sigma)."""
    c = patch_costs.sum(dim=0)  # [N]
    live = ((c >= 1e-8) & (kp_mask > 0)).to(c.dtype)
    n_live = torch.clamp(allreduce(live.sum(), group), min=1.0)
    mu = allreduce(torch.sum(c * live), group) / n_live
    var = allreduce(torch.sum(live * (c - mu) ** 2), group) / n_live
    sigma = torch.sqrt(var)
    outlier = (torch.abs(c - mu) > chi_k * sigma) & (kp_mask > 0)
    inlier_mask = torch.where(outlier, torch.zeros_like(c), torch.ones_like(c))
    return inlier_mask, outlier, mu, sigma


def detect_outliers(
    patch_costs: torch.Tensor, kp_mask: torch.Tensor, chi_k: float, group=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chi-square-style outlier flags from per-patch Huber costs: (mu, sigma)
    over keypoints with summed cost >= 1e-8, flag |cost - mu| > k*sigma.
    Returns (inlier mask [N] float, number of outliers). With ``group`` the
    statistics and the count are global and the mask is shard-local."""
    inlier_mask, outlier, _, _ = _outlier_statistics(patch_costs, kp_mask, chi_k, group)
    return inlier_mask, allreduce(outlier.sum(), group)


def _knot_prior_residual(knots: SplineKnots) -> torch.Tensor:
    """[(K-2)*6] constant-velocity violation: second differences of knot
    translations and of consecutive relative-rotation tangents."""
    d2t = knots.t[2:] - 2.0 * knots.t[1:-1] + knots.t[:-2]          # [K-2, 3]
    w_rel = quat_log(quat_multiply(quat_conjugate(knots.q[:-1]), knots.q[1:]))
    d2w = w_rel[1:] - w_rel[:-1]                                     # [K-2, 3]
    return torch.cat([d2t.reshape(-1), d2w.reshape(-1)])


def _prior_terms(knots: SplineKnots, weight: float):
    """(cost, g [6K], H [6K,6K]) of the Gauss-Newton-linearised knot prior
    at the current knots."""
    zero = torch.zeros(6 * knots.num_knots, dtype=knots.t.dtype,
                       device=knots.t.device)

    def prior_of(delta):
        return _knot_prior_residual(spline_retract_flat(knots, delta))

    p0 = prior_of(zero)
    Jp = jacfwd(prior_of)(zero)   # [P, 6K]
    cost = 0.5 * weight * torch.sum(p0 * p0)
    return cost, weight * (Jp.T @ p0), weight * (Jp.T @ Jp)


def _prior(k: SplineKnots, opts: LMOptions):
    """The knot prior's (cost, g, H) at ``k``, or None when it is off."""
    if opts.knot_prior_weight > 0.0 and k.num_knots > 2:
        return _prior_terms(k, opts.knot_prior_weight)
    return None


# ------------------------------------------------------------ the stages


class LMState(NamedTuple):
    """What an LM iteration carries: the knots' translations [K, 3] and
    rotations [K, 4], H [D, D], g [D], the scalars (``ops/cuda_lm.py``'s
    ``S_*`` layout), the outlier mask [N], the keypoint weights [N] (the
    keypoint mask times the outlier mask, K3's input) and the patch costs
    [F, N] at the last accepted state. The kernels update it in place."""

    t: torch.Tensor
    q: torch.Tensor
    H: torch.Tensor
    g: torch.Tensor
    scalars: torch.Tensor
    mask: torch.Tensor
    kp_w: torch.Tensor
    patch_costs: torch.Tensor


def _with(scalars: torch.Tensor, **values) -> torch.Tensor:
    """A copy of the scalars vector with the entries named by ``S_<NAME>``
    (a trailing underscore dropped) set to the given 0-dim tensors."""
    out = scalars.clone()
    for name, v in values.items():
        out[getattr(cuda_lm, f"S_{name.rstrip('_').upper()}")] = v
    return out


def _evaluator(sc: torch.Tensor) -> _EvaluatorState:
    return _EvaluatorState(sc[S_MIN], sc[S_CUR], sc[S_REF], sc[S_CAND], sc[S_ACC_REF],
                           sc[S_ACC_CAND], sc[S_NONMONO])


def lm_step_plain(H: torch.Tensor, g: torch.Tensor, scalars: torch.Tensor, t: torch.Tensor,
                  q: torch.Tensor, solver: str = "cholesky"):
    """K6's plain version: H1 = H + diag(diag(H)) / radius, step = -H1^-1 g,
    the model cost change and the invalid flag (a negative model change or a
    non-finite step), and the candidate knots: the knots retracted by the
    step, or the knots themselves when the step is invalid. Returns (H1,
    step, candidate t, candidate q, scalars with MCC and INVALID). The solve
    is the library's (``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``
    for "cholesky") on every device."""
    H1 = H + torch.diag(torch.diag(H)) / scalars[S_RADIUS]
    step = _solve(H1, g, solver)
    mcc = -(g @ step + 0.5 * step @ (H1 @ step))
    invalid = (mcc < 0) | ~torch.all(torch.isfinite(step))
    cand = spline_retract_flat(SplineKnots(t, q, None, None), step)
    cand_t = torch.where(invalid, t, cand.t)
    cand_q = torch.where(invalid, q, cand.q)
    return H1, step, cand_t, cand_q, _with(scalars, mcc=mcc, invalid=invalid.to(H.dtype))


def lm_decide_plain(cost: torch.Tensor, patch: torch.Tensor, kp_w: torch.Tensor,
                    kp_mask: torch.Tensor, scalars: torch.Tensor, P: int, opts: LMOptions,
                    prior_cost: Optional[torch.Tensor] = None, group=None):
    """K7's plain version. From K3's raw sums at the candidate under the old
    keypoint weights ``kp_w`` (``cost``, ``patch`` [F, N]): assemble's
    scaling, the candidate cost (plus the prior's), the step quality,
    success, the cost decrease, and the outlier mask re-detected from the
    candidate's scaled patch costs. Returns (scalars with CAND_COST,
    QUALITY, SUCCESS, ACD_NEW, MU and SIGMA, the new mask [N], the new
    keypoint weights [N])."""
    F = patch.shape[0]
    inv_n = inverse_residual_count(kp_w, F, P, group)
    cand_cost = allreduce(cost, group) * inv_n
    if prior_cost is not None:
        cand_cost = cand_cost + prior_cost
    quality = _step_quality(_evaluator(scalars), cand_cost, scalars[S_MCC])
    success = (quality > opts.min_step_quality) & (cand_cost < scalars[S_COST])
    acd = scalars[S_COST] - cand_cost
    mask, _, mu, sigma = _outlier_statistics(patch * inv_n, kp_mask,
                                             opts.max_chi_square_error, group)
    out = _with(scalars, cand_cost=cand_cost, quality=quality, success=success.to(cost.dtype),
                acd_new=acd, mu=mu, sigma=sigma)
    return out, mask, kp_mask * mask


def lm_commit_plain(s: LMState, H1: torch.Tensor, cand_t: torch.Tensor, cand_q: torch.Tensor,
                    cost: torch.Tensor, g: torch.Tensor, H: torch.Tensor, patch: torch.Tensor,
                    mask: torch.Tensor, kp_w: torch.Tensor, P: int, opts: LMOptions,
                    more: bool, prior=None, group=None) -> LMState:
    """K8's plain version. From K3's raw sums at the candidate under the new
    keypoint weights ``kp_w`` (``cost``, ``g``, ``H``, ``patch``), the
    prior's (cost, g, H) at the candidate or None, and the flags of K6 and
    K7 in ``s.scalars``: the next state, accepted (the candidate with the
    scaled sums, the radius divided by max(1/3, 1 - (2q - 1)^3), the
    evaluator advanced, the new mask), rejected or invalid (H1 carried, the
    radius divided by the decrease factor, which doubles; a rejected step's
    decrease replaces the last unless ``retry_rejected_steps``), chosen by
    selects; then CONTINUE = ``more`` and the decrease >= the minimum.
    ``more``: whether the iteration count is still under the limit."""
    sc = s.scalars
    F = patch.shape[0]
    inv_n = inverse_residual_count(kp_w, F, P, group)
    cost_f = allreduce(cost, group) * inv_n
    g_f = allreduce(g, group) * inv_n
    H_f = allreduce(H, group) * inv_n
    if prior is not None:
        cost_f, g_f, H_f = cost_f + prior[0], g_f + prior[1], H_f + prior[2]
    invalid = sc[S_INVALID] != 0
    success = (sc[S_SUCCESS] != 0) & ~invalid

    def clip_radius(r):
        return torch.clamp(r, opts.min_radius, opts.max_radius)

    radius, decrease = sc[S_RADIUS], sc[S_DECREASE]
    grown = clip_radius(radius / torch.clamp(1.0 - (2.0 * sc[S_QUALITY] - 1.0) ** 3,
                                             min=1.0 / 3.0))
    ev = _step_accepted(_evaluator(sc), cost_f, sc[S_MCC],
                        opts.max_consecutive_nonmonotonic_steps)
    kept_acd = sc[S_ACD] if opts.retry_rejected_steps else sc[S_ACD_NEW]
    acd = torch.where(success, sc[S_ACD_NEW], torch.where(invalid, sc[S_ACD], kept_acd))
    scalars = _with(
        sc,
        cost=torch.where(success, cost_f, sc[S_COST]),
        radius=torch.where(success, grown, clip_radius(radius / decrease)),
        decrease=torch.where(success, torch.full_like(decrease, 2.0), decrease * 2.0),
        min=torch.where(success, ev.minimum_cost, sc[S_MIN]),
        cur=torch.where(success, ev.current_cost, sc[S_CUR]),
        ref=torch.where(success, ev.reference_cost, sc[S_REF]),
        cand=torch.where(success, ev.candidate_cost, sc[S_CAND]),
        acc_ref=torch.where(success, ev.acc_reference_mcc, sc[S_ACC_REF]),
        acc_cand=torch.where(success, ev.acc_candidate_mcc, sc[S_ACC_CAND]),
        nonmono=torch.where(success, ev.num_nonmonotonic, sc[S_NONMONO]),
        acd=acd,
        continue_=(acd >= opts.min_abs_cost_decrease) & more,
    )
    return LMState(
        t=torch.where(success, cand_t, s.t),
        q=torch.where(success, cand_q, s.q),
        H=torch.where(success, H_f, H1),
        g=torch.where(success, g_f, s.g),
        scalars=scalars,
        mask=torch.where(success, mask, s.mask),
        kp_w=torch.where(success, kp_w, s.kp_w),
        patch_costs=torch.where(success, patch * inv_n, s.patch_costs),
    )


def lm_step(H, g, scalars, t, q, solver: str = "cholesky"):
    """K6 (:func:`lm_step_plain`): the kernel on CUDA tensors with the
    Cholesky solve, the plain version on CPU tensors and for ``solver``
    "lu" and "svd"."""
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}")
    if H.is_cuda and solver == "cholesky":
        return cuda_lm.lm_step_cuda(H, g, scalars, t, q)
    return lm_step_plain(H, g, scalars, t, q, solver)


def lm_decide(cost, patch, kp_w, kp_mask, scalars, P: int, opts: LMOptions, prior_cost=None):
    """K7 (:func:`lm_decide_plain`): kernel on CUDA tensors, plain version on
    CPU tensors."""
    if cost.is_cuda:
        return cuda_lm.lm_decide_cuda(cost, patch, kp_w, kp_mask, scalars, P,
                                      opts.max_chi_square_error, opts.min_step_quality,
                                      prior_cost)
    return lm_decide_plain(cost, patch, kp_w, kp_mask, scalars, P, opts, prior_cost)


def commit_options(opts: LMOptions) -> dict:
    """K8's options from ``opts``: the keywords of ``cuda_lm.lm_commit_cuda``
    and ``cuda_lm.CommitBinding`` besides ``more`` and ``prior``."""
    return dict(min_radius=opts.min_radius, max_radius=opts.max_radius,
                max_nonmono=opts.max_consecutive_nonmonotonic_steps,
                retry=opts.retry_rejected_steps, min_acd=opts.min_abs_cost_decrease)


def lm_commit(s: LMState, H1, cand_t, cand_q, cost, g, H, patch, mask, kp_w, P: int,
              opts: LMOptions, more: bool, prior=None, binding=None) -> LMState:
    """K8 (:func:`lm_commit_plain`): the kernel, ``s`` updated in place,
    through ``binding`` where given (``optimize_level``'s
    ``cuda_lm.CommitBinding`` of the level's state, made with ``P`` and
    ``opts``: the iteration's tensors checked), else on CUDA tensors through
    ``cuda_lm.lm_commit_cuda`` (every tensor checked); the plain version on
    CPU tensors."""
    if binding is not None:
        return binding(s, H1, cand_t, cand_q, cost, g, H, patch, mask, kp_w, more, prior)
    if cost.is_cuda:
        cuda_lm.lm_commit_cuda(*s, H1, cand_t, cand_q, cost, g, H, patch, mask, kp_w, P,
                               more=more, prior=prior, **commit_options(opts))
        return s
    return lm_commit_plain(s, H1, cand_t, cand_q, cost, g, H, patch, mask, kp_w, P, opts,
                           more, prior)


class _Level(NamedTuple):
    """What every iteration of one level evaluates against."""

    data: TrackingLevelData
    num_vir: int
    degree: int
    opts: LMOptions
    cache: tuple
    layout: tuple
    t0: torch.Tensor
    dt: torch.Tensor
    group: object = None   # the keypoint shards' process group
    # K8's binding of the level's state (cuda_lm.CommitBinding) on the
    # unsharded CUDA path, else None
    commit: object = None


def lm_iteration(s: LMState, lv: _Level, more: bool) -> LMState:
    """One LM iteration: the fixed sequence of stages (module docstring),
    with no read of the device. ``more``: whether another iteration may
    follow under ``max_iterations``. With ``lv.group`` the plain stages run,
    whatever the device."""
    opts, data, group = lv.opts, lv.data, lv.group
    P = data.pattern.shape[0]
    if group is None:
        step, decide = lm_step, lm_decide
    else:
        step = lm_step_plain
        decide = lambda *a: lm_decide_plain(*a, group=group)    # noqa: E731
    H1, _step, cand_t, cand_q, scalars = step(s.H, s.g, s.scalars, s.t, s.q, opts.solver)
    s = s._replace(scalars=scalars)
    cand = SplineKnots(cand_t, cand_q, lv.t0, lv.dt)
    # one residual + Jacobian pass, summed under the old mask (the candidate
    # cost) and under the re-detected mask (the state on success)
    r, J, _valid = compute_rjv(
        cand, data, lv.num_vir, lv.degree, True, sampling=opts.sampling,
        window=opts.window, cache=lv.cache, layout=lv.layout,
        affine=opts.affine_brightness, group=group,
    )
    # K3 looked up in ops.residual when called, as assemble looks it up
    cost_c, patch_c, _, _ = residual.normal_equations(r, None, s.kp_w, opts.huber_a,
                                                      opts.compensated_sum)
    prior = _prior(cand, opts)
    scalars, mask, kp_w = decide(cost_c, patch_c, s.kp_w, data.kp_mask, s.scalars, P, opts,
                                 None if prior is None else prior[0])
    s = s._replace(scalars=scalars)
    cost_f, patch_f, g_f, H_f = residual.normal_equations(r, J, kp_w, opts.huber_a,
                                                          opts.compensated_sum)
    if group is not None:
        return lm_commit_plain(s, H1, cand_t, cand_q, cost_f, g_f, H_f, patch_f, mask, kp_w, P,
                               opts, more, prior, group=group)
    return lm_commit(s, H1, cand_t, cand_q, cost_f, g_f, H_f, patch_f, mask, kp_w, P, opts,
                     more, prior, binding=lv.commit)


def optimize_level(
    knots: SplineKnots,
    data: TrackingLevelData,
    num_vir: int,
    degree: int,
    opts: LMOptions,
    cache=None,
    group=None,
) -> Tuple[SplineKnots, LMSummary]:
    """Run the LM loop for one pyramid level.

    ``cache``: the level's keyframe window cache (extracted here when None).
    ``group``: the process group of the keypoint shards when ``data`` and
    ``cache`` hold this rank's slice (``parallel.sharded``); the summary's
    outlier mask and patch costs then cover that slice.

    The host reads the device once an iteration: the continue flag that
    :func:`lm_commit` writes. Every iteration counts one, so the host
    counts them itself. On the card without ``group`` the level's state is
    bound to K8 once (``cuda_lm.CommitBinding``).
    """
    if opts.solver not in SOLVERS:
        raise ValueError(f"unknown solver {opts.solver!r}")
    dtype = knots.t.dtype
    N = data.kp_mask.shape[0]
    mask0 = torch.ones((N,), dtype=dtype, device=knots.t.device)

    if cache is None and opts.sampling == "windowed":
        cache = prepare_window_cache(data, opts.window)
    layout = None
    if opts.sampling == "windowed" and opts.hoist_layout:
        layout = prepare_frame_layout(knots, data, num_vir, degree)
    lv = _Level(data, num_vir, degree, opts, cache, layout, knots.t0, knots.dt, group)

    ev0 = evaluate(knots, data, num_vir, degree, opts.huber_a, mask0, True,
                   sampling=opts.sampling, window=opts.window,
                   precision=opts.precision, compensated=opts.compensated_sum,
                   cache=cache, layout=layout, affine=opts.affine_brightness,
                   group=group)
    H0, g0, cost0 = ev0.hessian, ev0.gradient, ev0.cost
    prior0 = _prior(knots, opts)
    if prior0 is not None:
        cost0, g0, H0 = cost0 + prior0[0], g0 + prior0[1], H0 + prior0[2]
    scalars = cost0.new_zeros(S_SIZE)
    scalars[S_COST:S_CAND + 1] = cost0        # the cost and the evaluator's four costs
    scalars[S_RADIUS] = opts.initial_radius
    scalars[S_DECREASE] = 2.0
    scalars[S_ACD] = 1e10
    # the knots are updated in place on the card: the caller's stay as given
    s = LMState(knots.t.clone(), knots.q.clone(), H0.contiguous(), g0.contiguous(), scalars,
                mask0, data.kp_mask * mask0, ev0.patch_costs.contiguous())
    if group is None and s.H.is_cuda:
        lv = lv._replace(commit=cuda_lm.CommitBinding(s, data.pattern.shape[0],
                                                      **commit_options(opts)))
    iterations = 0
    go = opts.max_iterations > 0 and 1e10 >= opts.min_abs_cost_decrease
    while go:
        iterations += 1
        s = lm_iteration(s, lv, iterations < opts.max_iterations)
        go = bool(s.scalars[S_CONTINUE])
    return knots._replace(t=s.t, q=s.q), LMSummary(
        final_cost=s.scalars[S_COST],
        num_iterations=iterations,
        outlier_mask=s.mask,
        patch_costs=s.patch_costs,
    )
