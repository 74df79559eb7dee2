"""Trust-region Levenberg-Marquardt over spline control knots, as a host loop.

Counterpart of ``mba_vo_tpu/solver/lm.py``, whose loop is one
``lax.while_loop``; here it is a Python loop over tensor steps with one host
sync per branch decision. Kept reference semantics, documented quirks
included:
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
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
from torch.func import jacfwd

from ..core.lie import quat_conjugate, quat_log, quat_multiply
from ..core.spline import SplineKnots, spline_retract_flat
from ..ops.residual import (
    TrackingLevelData,
    assemble,
    compute_rjv,
    evaluate,
    prepare_frame_layout,
    prepare_window_cache,
)


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
    the caller takes the invalid-step branch."""
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


def detect_outliers(
    patch_costs: torch.Tensor, kp_mask: torch.Tensor, chi_k: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chi-square-style outlier flags from per-patch Huber costs: (mu, sigma)
    over keypoints with summed cost >= 1e-8, flag |cost - mu| > k*sigma.
    Returns (inlier mask [N] float, number of outliers)."""
    c = patch_costs.sum(dim=0)  # [N]
    live = ((c >= 1e-8) & (kp_mask > 0)).to(c.dtype)
    n_live = torch.clamp(live.sum(), min=1.0)
    mu = torch.sum(c * live) / n_live
    var = torch.sum(live * (c - mu) ** 2) / n_live
    thresh = chi_k * torch.sqrt(var)
    outlier = (torch.abs(c - mu) > thresh) & (kp_mask > 0)
    inlier_mask = torch.where(outlier, torch.zeros_like(c), torch.ones_like(c))
    return inlier_mask, outlier.sum()


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


class _LMState(NamedTuple):
    knots: SplineKnots
    H: torch.Tensor
    g: torch.Tensor
    cost: torch.Tensor
    radius: torch.Tensor
    decrease_factor: torch.Tensor
    ev: _EvaluatorState
    outlier_mask: torch.Tensor
    num_iterations: int
    abs_cost_decrease: torch.Tensor
    patch_costs: torch.Tensor


class _Level(NamedTuple):
    """What every iteration of one level evaluates against."""

    data: TrackingLevelData
    num_vir: int
    degree: int
    opts: LMOptions
    cache: tuple
    layout: tuple


def _prior(k: SplineKnots, opts: LMOptions):
    if opts.knot_prior_weight > 0.0 and k.num_knots > 2:
        return _prior_terms(k, opts.knot_prior_weight)
    D = 6 * k.num_knots
    z = k.t.new_zeros(())
    return z, k.t.new_zeros(D), k.t.new_zeros((D, D))


def lm_iteration(s: _LMState, lv: _Level) -> _LMState:
    """One LM iteration: damped solve, then an invalid, accepted or rejected
    step."""
    opts = lv.opts

    def clip_radius(r):
        return torch.clamp(r, opts.min_radius, opts.max_radius)

    H1 = s.H + torch.diag(torch.diag(s.H)) / s.radius
    step = _solve(H1, s.g, opts.solver)
    model_cost_change = -(s.g @ step + 0.5 * step @ (H1 @ step))
    invalid = (model_cost_change < 0) | ~torch.all(torch.isfinite(step))
    # rejected or invalid: the damped H replaces the carried H
    shrink = dict(
        H=H1,
        radius=clip_radius(s.radius / s.decrease_factor),
        decrease_factor=s.decrease_factor * 2.0,
        num_iterations=s.num_iterations + 1,
    )
    if bool(invalid):
        return s._replace(**shrink)

    cand = spline_retract_flat(s.knots, step)
    # one residual + Jacobian pass per iteration, re-assembled under the old
    # mask (candidate cost) and, on success, under the re-detected mask
    r, J, _valid = compute_rjv(
        cand, lv.data, lv.num_vir, lv.degree, True, sampling=opts.sampling,
        window=opts.window, cache=lv.cache, layout=lv.layout,
        affine=opts.affine_brightness,
    )
    ev_c = assemble(r, None, lv.data, opts.huber_a, s.outlier_mask,
                    precision=opts.precision, compensated=opts.compensated_sum)
    cp_c, gp_c, Hp_c = _prior(cand, opts)
    cand_cost = ev_c.cost + cp_c
    quality = _step_quality(s.ev, cand_cost, model_cost_change)
    success = (quality > opts.min_step_quality) & (cand_cost < s.cost)
    acd = s.cost - cand_cost

    if not bool(success):
        if not opts.retry_rejected_steps:
            # the negative decrease ends the level at the next check
            shrink["abs_cost_decrease"] = acd
        return s._replace(**shrink)

    new_mask, _ = detect_outliers(ev_c.patch_costs, lv.data.kp_mask,
                                  opts.max_chi_square_error)
    ev_f = assemble(r, J, lv.data, opts.huber_a, new_mask,
                    precision=opts.precision, compensated=opts.compensated_sum)
    new_radius = s.radius / torch.clamp(1.0 - (2.0 * quality - 1.0) ** 3,
                                        min=1.0 / 3.0)
    return s._replace(
        knots=cand,
        H=ev_f.hessian + Hp_c,
        g=ev_f.gradient + gp_c,
        cost=ev_f.cost + cp_c,
        radius=clip_radius(new_radius),
        decrease_factor=torch.full_like(s.decrease_factor, 2.0),
        ev=_step_accepted(s.ev, ev_f.cost + cp_c, model_cost_change,
                          opts.max_consecutive_nonmonotonic_steps),
        outlier_mask=new_mask,
        num_iterations=s.num_iterations + 1,
        abs_cost_decrease=acd,
        patch_costs=ev_f.patch_costs,
    )


def optimize_level(
    knots: SplineKnots,
    data: TrackingLevelData,
    num_vir: int,
    degree: int,
    opts: LMOptions,
    cache=None,
) -> Tuple[SplineKnots, LMSummary]:
    """Run the LM loop for one pyramid level.

    ``cache``: the level's keyframe window cache (extracted here when None).
    """
    dtype = knots.t.dtype
    N = data.kp_mask.shape[0]
    mask0 = torch.ones((N,), dtype=dtype, device=knots.t.device)

    if cache is None and opts.sampling == "windowed":
        cache = prepare_window_cache(data, opts.window)
    layout = None
    if opts.sampling == "windowed" and opts.hoist_layout:
        layout = prepare_frame_layout(knots, data, num_vir, degree)
    lv = _Level(data, num_vir, degree, opts, cache, layout)

    ev0 = evaluate(knots, data, num_vir, degree, opts.huber_a, mask0, True,
                   sampling=opts.sampling, window=opts.window,
                   precision=opts.precision, compensated=opts.compensated_sum,
                   cache=cache, layout=layout, affine=opts.affine_brightness)
    cp0, gp0, Hp0 = _prior(knots, opts)
    s = _LMState(
        knots=knots,
        H=ev0.hessian + Hp0,
        g=ev0.gradient + gp0,
        cost=ev0.cost + cp0,
        radius=torch.full((), opts.initial_radius, dtype=dtype, device=knots.t.device),
        decrease_factor=torch.full((), 2.0, dtype=dtype, device=knots.t.device),
        ev=_evaluator_reset(ev0.cost + cp0),
        outlier_mask=mask0,
        num_iterations=0,
        abs_cost_decrease=torch.full((), 1e10, dtype=dtype, device=knots.t.device),
        patch_costs=ev0.patch_costs,
    )
    while (s.num_iterations < opts.max_iterations
           and bool(s.abs_cost_decrease >= opts.min_abs_cost_decrease)):
        s = lm_iteration(s, lv)
    return s.knots, LMSummary(
        final_cost=s.cost,
        num_iterations=s.num_iterations,
        outlier_mask=s.outlier_mask,
        patch_costs=s.patch_costs,
    )
