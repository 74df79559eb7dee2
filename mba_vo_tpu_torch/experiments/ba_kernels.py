"""The bundle adjustment's kernels K10-K12 on the backend's own inputs, on
one NVIDIA GPU: record, hold against the plain versions, time.

K10 ``ba_build``, K11 ``ba_step`` and K12 ``ba_commit`` are
``csrc/bundle_adjust.cu`` (``ops/cuda_ba.py``); their plain versions are
``backend/ba.py``'s ``ba_build_plain``, ``ba_step_plain`` and
``ba_commit_plain``. On the card, ``python -m
mba_vo_tpu_torch.experiments.ba_kernels`` runs :func:`main` on
``chip_smoke.py`` 8a's window (:func:`window_arrays`).

:func:`record_ba_calls` records every LM iteration that
``run_bundle_adjustment`` runs on the kernels: the problem it was bound to
and a copy of its state (poses, points, scalars) at the iteration's start.
That state determines the iteration's three calls: every sum of the
kernels has one fixed order, so K10 replayed on it gives the run's K10
outputs bit for bit, K11 on those the run's K11 outputs, and so on.

:func:`hold_ba` replays an iteration: K10 against ``ba_build_plain`` on the
state (and, at a loop's first iteration, K10's initial cost against
``evaluate_cost``), K11 against ``ba_step_plain`` on K10's outputs, K12
against ``ba_commit_plain`` on K11's outputs; each output within
:data:`TOLERANCE` of its largest magnitude (NaN where the other is NaN), and
K12's decisions (ok, done, lambda, the iteration count) equal, or differing at
a knife edge (the two candidate costs, equal within the bound, on the two
sides of the cost, or the relative decreases on the two sides of
``min_rel_decrease``), which is counted and reported. K11's
outputs are held to the larger of that and what roundoff in K11's sums can
move them by (:func:`step_bounds`): the reduced camera system S and its
right-hand side are small differences of large terms near the optimum, S
is ill-conditioned (kappa_2 up to 1e15 on the windows the tests make), a
landmark seen from a short baseline has an ill-conditioned V, and two
implementations that sum in different orders, the library's on the CPU and
on the card included, differ by about that; where S's definiteness is
within its roundoff the call is counted and left unchecked. A difference
past the bounds raises.

:func:`time_ba_rows` times each kernel on recorded iterations as
``residual_kernels.time_rows`` times K2-K5: ``ms`` a call through the
binding (the loop's host call), ``device_ms`` warm in a replayed CUDA graph
of the calls, ``device_cold_ms`` after an L2 flush, the plain version's call
(``plain_ms``), the bound (:func:`ba_bound`) and, for K11, the library's
Cholesky (``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``) on the
same reduced camera system S, a yardstick the port never calls. Each
kernel is timed in both designs, the launched one and the earlier ticket
design, in turn (launched, ticket, ticket, launched). K12 writes the state
in place, so its launches after a binding's first take the branch of a
rejected step (or of a done state): no copy of the candidate.

:func:`hold_designs` holds the ticket designs against the launched ones on a
recorded iteration (K10's and K12's bit for bit: each pair takes every sum
in one order; K11's within its roundoff bound);
:func:`phase_split` times each design's phases from the stamps of
``bundle_adjust.cu``'s harness-only build (``BA_PHASE_CLOCKS``, a library of
its own; the path never loads it); :func:`cholesky_solve_ordered` is K11's
Cholesky solve in its order of operations, in torch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import re
import statistics
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from . import kernel_variants as kv
from .residual_kernels import F64_FLOPS_PER_S

BA_KERNELS = ("ba_build", "ba_step", "ba_commit")
# each kernel's designs by BABinding method: the launched one first, then
# the earlier ticket design where the kernel was redesigned
DESIGNS = {"ba_build": ("build", "build_ticket"), "ba_step": ("step", "step_ticket"),
           "ba_commit": ("commit", "commit_ticket")}
# of each output's largest magnitude (chip_smoke.py's bounds)
TOLERANCE = {torch.float32: 1e-5, torch.float64: 1e-12}


@dataclasses.dataclass
class BACall:
    """One recorded LM iteration: the bound problem with the state's poses
    and points at the iteration's start (copies), the scalars (a copy),
    the options, and which ``run_bundle_adjustment`` call it belongs to."""
    problem: object
    scalars: torch.Tensor
    opts: object
    run: int

    @property
    def dtype(self) -> torch.dtype:
        return self.scalars.dtype

    @property
    def W(self) -> int:
        return self.problem.poses.t.shape[0]

    @property
    def M(self) -> int:
        return self.problem.map.points.shape[0]

    def fresh(self):
        """(problem, scalars) with copies of the state, for a call that
        writes it in place."""
        from ..core.transform import Pose

        p = self.problem
        return (p._replace(poses=Pose(t=p.poses.t.clone(), q=p.poses.q.clone()),
                           map=p.map._replace(points=p.map.points.clone())),
                self.scalars.clone())


@contextlib.contextmanager
def record_ba_calls() -> Iterator[List[BACall]]:
    """Record every ``ops.cuda_ba.BABinding.build`` call made inside the
    block (an iteration's start on the kernels), in order; the calls still
    run. Restored on leaving."""
    from ..ops import cuda_ba

    calls: List[BACall] = []
    original = cuda_ba.BABinding.build
    runs = [0]

    def build(self):
        # a run's number kept on its binding (an object's id() is reused once
        # it is freed, which would join two runs)
        if not hasattr(self, "_recorded_run"):
            self._recorded_run = runs[0]
            runs[0] += 1
        call = BACall(self.state_problem(), self.scalars, self.opts, self._recorded_run)
        call.problem, call.scalars = call.fresh()
        calls.append(call)
        return original(self)

    cuda_ba.BABinding.build = build
    try:
        yield calls
    finally:
        cuda_ba.BABinding.build = original


def _scale(ref: torch.Tensor) -> float:
    finite = ref[torch.isfinite(ref)]
    return float(finite.abs().max()) if finite.numel() else 0.0


def rel_diff(out: torch.Tensor, ref: torch.Tensor, terms: float = 0.0) -> float:
    """max |out - ref| over the finite entries, over the larger of ref's
    largest finite magnitude and ``terms`` (the largest magnitude of the
    terms an entry sums, where the sum cancels; an absolute difference
    where both are 0); inf where the NaN or infinite entries differ."""
    if not torch.equal(torch.isfinite(out), torch.isfinite(ref)):
        return math.inf
    both = torch.isfinite(ref)
    if not bool(both.any()):
        return 0.0
    d = float((out[both] - ref[both]).abs().max())
    s = max(_scale(ref), terms)
    return d / s if s > 0 else d


def build_term_scales(problem, huber_a: float) -> Dict[str, float]:
    """The largest magnitude of the terms each of K10's sums adds, by
    output: U, V, W_blk, g_p and g_x sum products of the Jacobians, the
    weights and the residuals over the observations (and g_p and H_o the
    prior's over its edges) that cancel where the window has converged
    (its gradient near 0); their roundoff is relative to these terms, not
    to the sums. The sums of the terms' magnitudes, in float64."""
    from ..backend import ba

    p = problem
    r, Jp, Jx = (x.double() for x in ba._residuals_and_jacobians(p))
    mask = (p.map.obs_mask * p.map.point_mask[None, :]).double()
    _, w2 = ba._huber_weight(torch.sum(r * r, dim=-1), huber_a)
    wgt = w2 * mask
    aJp, aJx, ar = Jp.abs(), Jx.abs(), r.abs()
    out = dict(U=torch.einsum("wmia,wm,wmib->wab", aJp, wgt, aJp),
               V=torch.einsum("wmia,wm,wmib->mab", aJx, wgt, aJx),
               W_blk=torch.einsum("wmia,wm,wmib->wmab", aJp, wgt, aJx),
               g_p=torch.einsum("wmia,wm,wmi->wa", aJp, wgt, ar),
               g_x=torch.einsum("wmia,wm,wmi->ma", aJx, wgt, ar),
               H_o=torch.zeros(()))
    if p.odom is not None:
        t, q = p.poses.t.double(), p.poses.q.double()
        ro, J_i, J_j = ba.relative_pose_jacobians(t[:-1], q[:-1], t[1:], q[1:],
                                                  p.odom.t.double(), p.odom.q.double())
        Wn, E = t.shape[0], t.shape[0] - 1
        e = torch.arange(E, device=t.device)
        J = torch.zeros((E, 6, Wn, 6), dtype=torch.float64, device=t.device)
        J[e, :, e] = J_i.abs()
        J[e, :, e + 1] = J_j.abs()
        J = J.reshape(E * 6, Wn * 6)
        wrow = torch.repeat_interleave(p.odom.weight.double(), 6)
        out["H_o"] = (J.T * wrow[None, :]) @ J
        out["g_p"] = out["g_p"] + (J.T @ (wrow * ro.abs().reshape(-1))).reshape(Wn, 6)
    return {k: float(v.abs().max()) for k, v in out.items()}


def _held(label: str, names, outs, refs, bound: float, terms=None) -> float:
    worst = 0.0
    for name, a, b in zip(names, outs, refs):
        d = rel_diff(a, b, (terms or {}).get(name, 0.0))
        if not d <= bound:
            raise AssertionError(f"{label}: {name} differs from the plain version by {d:.3e} "
                                 f"of its magnitude (bound {bound:.0e})")
        worst = max(worst, d)
    return worst


UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.float64: 2.0 ** -53}


def step_bounds(call: BACall, built, scalars: torch.Tensor, ref) -> dict:
    """What roundoff alone can move K11's outputs by, computed from the
    plain version's intermediates (``backend.ba.reduced_camera_system``) on
    ``built`` at the scalars' lambda, and ``ref`` (its outputs).

    K11 sums S = blockdiag(U) + He - sum_m W_m V_m^-1 W_m^T and its
    right-hand side b = g_p - sum_m W_m V_m^-1 g_x m by m; near the optimum
    both are small differences of large terms. Two implementations that
    round each term once but sum in different orders (K11; cuBLAS and
    cuSOLVER) differ in S and b by up to e = c u times the magnitudes of
    the terms (E_S, E_b), c = 2 D (D = 6W), so to first order their steps
    differ by ||S^-1|| (||E_b|| + ||E_S|| ||dp||) + c u ||dp||; dx_m =
    -V_m^-1 (g_x + W_m^T dp) moves by |V_m^-1| |W_m|^T that and by the
    inverse's own c u kappa_2(V_m) |V_m^-1| |v_m|. Returns "status":
    "definite" (S's least eigenvalue over the live poses above its
    roundoff, so both factorisations succeed), "indefinite" (below minus
    it: both fail, a NaN step), else "edge" (either may); the absolute
    bounds "dp" (a number) and "dx" ([M, 3]); and kappa_2(S) and the V
    blocks' largest kappa_2 for the record."""
    from ..backend import ba
    from ..ops import cuda_ba

    dt = torch.float64
    S, rhs, Vinv, Wbg, gauge = ba.reduced_camera_system(
        *built[1:6], scalars[cuda_ba.B_LAM], call.opts, H_pose=built[6],
        pose_mask=call.problem.pose_mask)
    S, rhs, Vinv, Wbg = S.to(dt), rhs.to(dt), Vinv.to(dt), Wbg.to(dt)
    g_x = built[5].to(dt)
    c = 2.0 * 6 * call.W * UNIT_ROUNDOFF[call.dtype]
    out = dict(status="edge", dp=math.inf, dx=None, kappa=math.inf, kappa_V=math.inf)
    if not (bool(torch.isfinite(S).all()) and bool(torch.isfinite(Vinv).all())):
        return out
    aWV = torch.einsum("wmab,mbc->wmac", Wbg.abs(), Vinv.abs())
    Wn = call.W
    E_S = S.abs() + 2.0 * torch.einsum("wmac,vmbc->wavb", aWV, Wbg.abs()).reshape(6 * Wn, 6 * Wn)
    E_b = rhs.abs() + 2.0 * torch.einsum("wmac,mc->wa", aWV, g_x.abs()).reshape(-1)
    live = torch.repeat_interleave(gauge != 0, 6)
    S_l, E_Sl, E_bl = S[live][:, live], E_S[live][:, live], E_b[live]
    out["kappa_V"] = float(torch.linalg.cond(Vinv).max())
    if S_l.numel() == 0:
        out.update(status="definite", dp=0.0, kappa=1.0)
    else:
        lam = torch.linalg.eigvalsh(0.5 * (S_l + S_l.T))
        margin = c * float(torch.linalg.matrix_norm(E_Sl, 2))
        lo, hi = float(lam[0]), float(lam[-1])
        out["kappa"] = hi / lo if lo > 0 else math.inf
        if lo < -margin:
            out["status"] = "indefinite"
            return out
        if lo <= margin:
            return out
        dp = ref[0].to(dt).reshape(-1)
        n_dp = float(torch.linalg.vector_norm(dp))
        out.update(status="definite", dp=(c / (lo - margin)) * (
            float(torch.linalg.vector_norm(E_bl))
            + float(torch.linalg.matrix_norm(E_Sl, 2)) * n_dp) + c * n_dp)
    dp = ref[0].to(dt)
    v_abs = g_x.abs() + torch.einsum("wmab,wa->mb", Wbg.abs(), dp.abs())
    dv = out["dp"] * torch.einsum("wmab->mb", Wbg.abs()) + c * v_abs
    kV = torch.linalg.cond(Vinv)[:, None]
    out["dx"] = (torch.einsum("mab,mb->ma", Vinv.abs(), dv)
                 + c * kV * torch.einsum("mab,mb->ma", Vinv.abs(), v_abs))
    return out


def _held_within(label: str, name: str, out: torch.Tensor, ref: torch.Tensor, bound,
                 floor: float) -> float:
    """``out`` against ``ref`` entry by entry within the larger of the
    absolute ``bound`` (a number or a tensor of ref's shape) and ``floor``
    of ref's magnitude; NaN where the other is NaN. Returns the largest
    difference's share of its bound."""
    if not torch.equal(torch.isnan(out), torch.isnan(ref)):
        raise AssertionError(f"{label}: {name}'s NaN entries differ from the plain version's")
    ok = ~torch.isnan(ref)
    d = (out - ref).abs().to(torch.float64)[ok]
    b = torch.as_tensor(bound, dtype=torch.float64, device=ref.device)
    b = (b.expand(ref.shape)[ok] if b.dim() else b).clamp(min=floor * _scale(ref))
    if d.numel() == 0:
        return 0.0
    share = float((d / b).max()) if bool((b > 0).all()) else float(d.max() > 0) * math.inf
    if not share <= 1.0:
        raise AssertionError(f"{label}: {name} differs from the plain version by "
                             f"{float(d.max()):.3e}, past its roundoff bound ({share:.3e} of it)")
    return share


def _hold_step(label: str, call: BACall, built, sk: torch.Tensor, cand, ref) -> dict:
    """K11's outputs ``cand`` against ``ref`` (the plain version's, or another
    design's) on ``built`` at the scalars ``sk``: within the bound of each
    output's magnitude, else within what roundoff in K11's sums can move them
    by (:func:`step_bounds`) where S is definite beyond its roundoff; where S
    is indefinite beyond it both steps are NaN; at the edge unchecked.
    Returns ba_step (the largest difference of each output's magnitude),
    ba_step_share, ba_step_checked, step_status, kappa and kappa_V."""
    bound = TOLERANCE[call.dtype]
    out = dict(ba_step=max(rel_diff(a, r) for a, r in zip(cand, ref)), ba_step_share=0.0,
               ba_step_checked=True, step_status="within the bound", kappa=None, kappa_V=None)
    if out["ba_step"] <= bound:
        sb = {"status": "within the bound"}
    else:
        sb = step_bounds(call, built, sk, ref)
        out.update(kappa=sb["kappa"], kappa_V=sb["kappa_V"], step_status=sb["status"],
                   ba_step_checked=sb["status"] != "edge")
    if sb["status"] == "indefinite":
        for name, a, r in zip(("dp", "dx", "cand t", "cand q", "cand X"), cand, ref):
            if not torch.equal(torch.isnan(a), torch.isnan(r)):
                raise AssertionError(f"{label}: S is indefinite; {name}'s NaN entries "
                                     f"differ from the reference's")
        out["ba_step"] = 0.0
    elif sb["status"] == "definite":
        kind = f"{label} (kappa_2(S) {sb['kappa']:.3e})"
        t_abs = call.problem.poses.t.abs().to(torch.float64)
        X_abs = call.problem.map.points.abs().to(torch.float64)
        c = 2.0 * 6 * call.W * UNIT_ROUNDOFF[call.dtype]
        for name, i, b in (("dp", 0, sb["dp"]), ("cand t", 2, sb["dp"] + c * t_abs),
                           ("cand q", 3, sb["dp"] + c), ("dx", 1, sb["dx"]),
                           ("cand X", 4, sb["dx"] + c * X_abs)):
            out["ba_step_share"] = max(out["ba_step_share"],
                                       _held_within(kind, name, cand[i], ref[i], b, bound))
    return out


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two float tensors are equal bit for bit (NaN payloads too)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    as_int = {torch.float64: torch.int64, torch.float32: torch.int32}[a.dtype]
    return torch.equal(a.contiguous().view(as_int), b.contiguous().view(as_int))


def hold_ba(call: BACall) -> dict:
    """Replay one iteration through K10-K12 and their plain versions on the
    same inputs (module docstring; K10's term magnitudes and K11's
    :func:`step_bounds` computed only where an output misses the bound of
    its own magnitude). Returns the largest difference by kernel (relative
    to each output's magnitude), K11's status, whether it was checked and
    its largest share of its roundoff bound (kappa_2(S) and the V blocks'
    where that was computed), and the iteration's ok, done and whether its
    step was NaN."""
    from ..backend import ba
    from ..ops import cuda_ba

    bound = TOLERANCE[call.dtype]
    opts = call.opts
    label = f"BA iteration (run {call.run}, W {call.W}, M {call.M})"
    p, sk = call.fresh()
    built = cuda_ba.ba_build_cuda(p, sk, opts)
    ref = ba.ba_build_plain(call.problem, opts.huber_a)
    names = ("cost", "U", "V", "W_blk", "g_p", "g_x", "H_o")
    # the terms' magnitudes only where an output misses the bound of its own
    diffs = [rel_diff(a, r) for a, r in zip(built, ref)]
    terms = (build_term_scales(call.problem, opts.huber_a)
             if not all(d <= bound for d in diffs) else None)
    out = {"ba_build": max(diffs) if terms is None else
           _held(label + " K10", names, built, ref, bound, terms)}
    if float(call.scalars[cuda_ba.B_IT]) == 0.0:
        cost0 = ba.evaluate_cost(call.problem, opts.huber_a)
        out["ba_build"] = max(out["ba_build"], _held(
            label + " K10's initial cost", ("cost0", "cost"),
            (sk[cuda_ba.B_COST0], sk[cuda_ba.B_COST]), (cost0, cost0), bound))
    cand = cuda_ba.ba_step_cuda(p, sk.clone(), built, opts)
    ref = ba.ba_step_plain(call.problem, sk, built, opts)
    out.update(_hold_step(label + " K11", call, built, sk, cand, ref))
    pk, sck = p, sk.clone()
    cuda_ba.ba_commit_cuda(pk, sck, cand, opts)
    pp, scp = ba.ba_commit_plain(call.problem, sk, cand, opts)
    # the candidate cost (and the relative decrease, which moves by its
    # difference over the cost: held to the bound times candidate / cost,
    # absolutely) before the decisions that follow from them
    out["ba_commit"] = _held(label + " K12", ("candidate cost",), (sck[cuda_ba.B_CAND_COST],),
                             (scp[cuda_ba.B_CAND_COST],), bound)
    cost = float(sk[cuda_ba.B_COST])
    cand_k, cand_p = float(sck[cuda_ba.B_CAND_COST]), float(scp[cuda_ba.B_CAND_COST])
    ratio = max(1.0, abs(cand_p) / max(abs(cost), 1e-300))
    rel_k, rel_p = float(sck[cuda_ba.B_REL]), float(scp[cuda_ba.B_REL])
    d_rel = abs(rel_k - rel_p)
    if not (d_rel <= bound * ratio or (math.isnan(rel_k) and math.isnan(rel_p))):
        raise AssertionError(f"{label} K12: the relative decrease differs by {d_rel:.3e} "
                             f"(bound {bound * ratio:.1e})")
    # a knife edge: the two candidate costs, equal within the bound, on the
    # two sides of the cost (ok), or the two relative decreases on the two
    # sides of min_rel_decrease (done); the decisions then differ by the
    # sums' order alone and the states are not compared
    edge_ok = min(cand_k, cand_p) < cost <= max(cand_k, cand_p)
    m = opts.min_rel_decrease
    edge_done = min(rel_k, rel_p) < m <= max(rel_k, rel_p)
    same = all(torch.equal(sck[i], scp[i]) for i in (cuda_ba.B_OK, cuda_ba.B_DONE, cuda_ba.B_IT,
                                                     cuda_ba.B_LAM))
    out["flip"] = not same
    if not same:
        if not (edge_ok or edge_done):
            raise AssertionError(f"{label} K12: ok / done {float(sck[cuda_ba.B_OK])} / "
                                 f"{float(sck[cuda_ba.B_DONE])} against the plain version's "
                                 f"{float(scp[cuda_ba.B_OK])} / {float(scp[cuda_ba.B_DONE])} "
                                 f"(candidate cost {cand_k!r} / {cand_p!r}, cost {cost!r})")
        out["flip_detail"] = (f"{label}: ok {float(sck[cuda_ba.B_OK]):g} / "
                              f"{float(scp[cuda_ba.B_OK]):g}, done {float(sck[cuda_ba.B_DONE]):g} "
                              f"/ {float(scp[cuda_ba.B_DONE]):g}: candidate cost {cand_k!r} / "
                              f"{cand_p!r}, cost {cost!r}, relative decrease {rel_k!r} / "
                              f"{rel_p!r}")
    else:
        out["ba_commit"] = max(out["ba_commit"], _held(
            label + " K12", ("t", "q", "X", "cost"),
            (pk.poses.t, pk.poses.q, pk.map.points, sck[cuda_ba.B_COST]),
            (pp.poses.t, pp.poses.q, pp.map.points, scp[cuda_ba.B_COST]), bound))
    out.update(ok=bool(sck[cuda_ba.B_OK]), done=bool(sck[cuda_ba.B_DONE]),
               nan_step=not bool(torch.isfinite(cand[0]).all()),
               state=(pk.poses.t, pk.poses.q, pk.map.points, sck))
    return out


def hold_ba_calls(calls: List[BACall]) -> dict:
    """:func:`hold_ba` on every recorded iteration; each iteration's K12
    state against the next recorded iteration's start in the same run (bit
    for bit: the replay reproduces the run). Returns the largest difference
    by kernel, the iterations held, accepted, done and with a NaN step, the
    transitions compared and those equal bit for bit, K11's calls within
    the bound of each output's magnitude, those checked (with those within
    their roundoff bound) and its largest share of that bound, kappa_2(S)'s
    range and the V blocks' largest kappa_2 where the roundoff bound was
    computed, and the knife edges' flips (each described)."""
    from ..ops import cuda_ba

    worst = {k: 0.0 for k in BA_KERNELS}
    n = dict(iterations=0, accepted=0, done=0, nan_steps=0, transitions=0, replayed_equal=0,
             step_within=0, step_checked=0, step_share=0.0, kappa=[math.inf, 0.0],
             kappa_V=0.0, flips=[])
    for i, call in enumerate(calls):
        got = hold_ba(call)
        for k in BA_KERNELS:
            worst[k] = max(worst[k], got[k])
        n["step_checked"] += got["ba_step_checked"]
        if got["flip"]:
            n["flips"].append(got["flip_detail"])
        n["step_share"] = max(n["step_share"], got["ba_step_share"])
        n["step_within"] += got["step_status"] == "within the bound"
        if got["kappa"] is not None:
            n["kappa"] = [min(n["kappa"][0], got["kappa"]), max(n["kappa"][1], got["kappa"])]
            n["kappa_V"] = max(n["kappa_V"], got["kappa_V"])
        n["iterations"] += 1
        n["accepted"] += got["ok"]
        n["done"] += got["done"]
        n["nan_steps"] += got["nan_step"]
        nxt = calls[i + 1] if i + 1 < len(calls) else None
        if nxt is not None and nxt.run == call.run:
            t, q, X, sc = got["state"]
            n["transitions"] += 1
            n["replayed_equal"] += int(
                torch.equal(t, nxt.problem.poses.t) and torch.equal(q, nxt.problem.poses.q)
                and torch.equal(X, nxt.problem.map.points)
                and torch.equal(sc[:cuda_ba.B_COST0 + 1], nxt.scalars[:cuda_ba.B_COST0 + 1]))
    return dict(worst=worst, **n)


def ba_bound(kernel: str, W: int, M: int, itemsize: int, prior: bool,
             rate: float) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of one call, the larger
    of each input read once and each output written once at 3.35 TB/s and
    its floating-point operations at ``rate``. K10 reads the poses, points,
    observations and masks and writes U, V, W_blk, g_p, g_x and H_o (~400
    operations an observation: the residual, the Jacobians, the weighted
    products; ~2,000 an edge of the prior); K11 reads those and the state
    and writes dp, dx and the candidate (the inverses, W V^-1, the Schur
    sums 36 W^2 M 3 2 / 2 over the lower triangle, the Cholesky D^3 / 3,
    the solves and the back-substitution); K12 reads the candidate, dp, dx,
    the observations and masks and writes the state (~60 operations an
    observation)."""
    D, E, obs = 6 * W, max(W - 1, 0), W * M
    inputs = 2 * obs + obs + M + 4 + (8 * E if prior else 0)   # obs_xy, obs_mask, point_mask, K
    state = 7 * W + 3 * M
    built = 36 * W + 9 * M + 18 * obs + 6 * W + 3 * M + D * D
    if kernel == "ba_build":
        words = inputs + state + built
        ops = 400 * obs + 2000 * E
    elif kernel == "ba_step":
        words = built + state + M + W + (D + 3 * M) + state
        ops = 60 * M + 108 * obs + 3 * D * (D + 1) * M + D ** 3 / 3 + 2 * D * D + 36 * obs
    else:
        words = state + D + 3 * M + inputs + state
        ops = 60 * obs + 300 * E
    b_ms = 1e3 * words * itemsize / kv.HBM_BYTES_PER_S
    o_ms = 1e3 * ops / rate
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _bindings(kernel: str, calls: List[BACall], method: str = "", clocked: bool = False):
    """A binding per call with its inputs in place (K11's from a K10 launch,
    K12's from K10 and K11); returns each binding's ``method`` (by default
    the launched design's) that launches ``kernel``."""
    from ..ops import cuda_ba

    out = []
    for c in calls:
        p, sc = c.fresh()
        b = cuda_ba.BABinding(p, c.opts, sc, own=False, clocked=clocked)
        if kernel != "ba_build":
            b.build()
            if kernel == "ba_commit":
                b.step()
        out.append(b)
    torch.cuda.synchronize()
    return [getattr(b, method or DESIGNS[kernel][0]) for b in out]


def _plain_fns(kernel: str, calls: List[BACall]):
    from ..backend import ba
    from ..ops import cuda_ba

    fns = []
    for c in calls:
        p, sc = c.fresh()
        built = cuda_ba.ba_build_cuda(p, sc, c.opts)     # sc as K10 leaves it
        if kernel == "ba_build":
            fns.append(lambda p=p, c=c: ba.ba_build_plain(p, c.opts.huber_a))
        elif kernel == "ba_step":
            fns.append(lambda p=p, sc=sc, b=built, c=c: ba.ba_step_plain(p, sc, b, c.opts))
        else:
            cand = cuda_ba.ba_step_cuda(p, sc.clone(), built, c.opts)
            fns.append(lambda p=p, sc=sc, cand=cand, c=c: ba.ba_commit_plain(p, sc, cand,
                                                                             c.opts))
    return fns


def _cholesky_yardstick(call: BACall):
    """The library's solve of K11's reduced camera system: two PyTorch
    calls, ``torch.linalg.cholesky_ex`` of S and ``torch.cholesky_solve``,
    on the S and right-hand side of the call (formed once, outside)."""
    from ..backend import ba
    from ..ops import cuda_ba

    p, sc = call.fresh()
    _, U, V, Wb, g_p, g_x, H_o = cuda_ba.ba_build_cuda(p, sc, call.opts)
    S, rhs, *_ = ba.reduced_camera_system(U, V, Wb, g_p, g_x, sc[cuda_ba.B_LAM], call.opts,
                                          H_pose=H_o, pose_mask=p.pose_mask)
    rhs = rhs[:, None].clone()

    def solve():
        L, _ = torch.linalg.cholesky_ex(S)
        return torch.cholesky_solve(rhs, L)
    return solve


def time_ba_rows(label: str, calls: List[BACall], reps: int = 10, inner: int = 10,
                 out=print) -> Dict[str, dict]:
    """Each of K10-K12 on (at most 50 of) the recorded ``calls``, timed as the
    module docstring says; returns a row by kernel with ``ms``,
    ``device_ms``, ``device_cold_ms`` (the launched design's; each the mean
    of its two turns), ``ticket`` (the same of the earlier ticket design),
    ``plain_ms``, ``bound_ms``, ``bound_by`` and ``library_ms`` (with
    ``library_device_ms`` and ``library_device_cold_ms``; None but for
    K11)."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing the BA's kernels needs a CUDA device")
    warm = calls[:50]
    c0 = warm[0]
    rate = F64_FLOPS_PER_S if c0.dtype == torch.float64 else kv.F32_FLOPS_PER_S
    prior = c0.problem.odom is not None
    w_inner = len(warm) * math.ceil(50 / len(warm))
    rows = {}
    for kernel in BA_KERNELS:
        # the designs in turn: launched, ticket, ticket, launched
        methods = DESIGNS[kernel]
        fns = {m: _bindings(kernel, warm, m) for m in methods}
        got = {m: [] for m in methods}
        for m in methods + methods[::-1]:
            got[m].append((kv.time_ms(fns[m][0], reps, inner), kv.device_ms(fns[m], reps, w_inner),
                           kv.device_flushed_ms(fns[m][0], reps, 20)))
        times = {m: dict(zip(("ms", "device_ms", "device_cold_ms"),
                             (statistics.fmean(x) for x in zip(*got[m]))))
                 for m in methods}
        plain = _plain_fns(kernel, warm[:1])[0]
        bounds = [ba_bound(kernel, c.W, c.M, c.scalars.element_size(), prior, rate)
                  for c in warm]
        row = dict(inputs=label, kernel=kernel, calls=len(calls), W=c0.W, M=c0.M,
                   dtype=str(c0.dtype).split(".")[-1], **times[methods[0]],
                   ticket=times[methods[1]] if len(methods) > 1 else None,
                   plain_ms=kv.time_ms(plain, reps, 2),
                   bound_ms=statistics.fmean(b for b, _ in bounds),
                   bound_by=max(("bytes", "operations"), key=[by for _, by in bounds].count),
                   library_ms=None, library_device_ms=None, library_device_cold_ms=None)
        if kernel == "ba_step":
            lib = [_cholesky_yardstick(c) for c in warm]
            row.update(library_ms=kv.time_ms(lib[0], reps, inner),
                       library_device_ms=kv.device_ms(lib, reps, w_inner),
                       library_device_cold_ms=kv.device_flushed_ms(lib[0], reps, 20))
        rows[kernel] = row
        lib_txt = ("" if row["library_ms"] is None else
                   f"; cholesky_ex + cholesky_solve on the same S {1e3 * row['library_ms']:.2f} "
                   f"us a call / {1e3 * row['library_device_ms']:.2f} warm / "
                   f"{1e3 * row['library_device_cold_ms']:.2f} cold")
        t = row["ticket"]
        ticket_txt = ("" if t is None else
                      f"; the earlier ticket design {1e3 * t['ms']:.2f} / "
                      f"{1e3 * t['device_ms']:.2f} / {1e3 * t['device_cold_ms']:.2f}")
        out(f"{label} {kernel} ({len(calls)} iterations, W {c0.W}, M {c0.M}, {row['dtype']}): "
            f"kernel {1e3 * row['ms']:.2f} us a call through the binding / "
            f"{1e3 * row['device_ms']:.2f} warm / {1e3 * row['device_cold_ms']:.2f} cold"
            f"{ticket_txt}; plain "
            f"{1e3 * row['plain_ms']:.2f} us a call; bound {1e3 * row['bound_ms']:.4f} us "
            f"({row['bound_by']}){lib_txt}")
    return rows


def hold_designs(call: BACall) -> dict:
    """The earlier ticket designs of K10, K11 and K12 against the launched
    ones on one recorded iteration, on the same inputs (K11's both from the
    launched K10's outputs, K12's both from the launched K11's outputs at
    one state). K10's and K12's two designs sum in one order: held bit for
    bit (K12's t, q, X and every scalar), K10's also, for the report,
    within :data:`TOLERANCE` of each output's magnitude. K11's build S and
    its right-hand side in one order but factor S with other pivot
    scalings: held as :func:`hold_ba` holds the plain version
    (:func:`_hold_step`). Returns whether each kernel's outputs were
    bit-equal, the largest difference relative to each output's magnitude,
    and K11's status and share of its roundoff bound."""
    from ..ops import cuda_ba

    label = f"BA iteration (run {call.run}, W {call.W}, M {call.M})"
    (pa, sa), (pb, sb) = call.fresh(), call.fresh()
    a = cuda_ba.BABinding(pa, call.opts, sa, own=False)
    b = cuda_ba.BABinding(pb, call.opts, sb, own=False)
    a.build()
    b.build_ticket()
    out_a, out_b = (a.built[1:] + (sa,)), (b.built[1:] + (sb,))
    out = dict(ba_build_equal=all(same_bits(x, y) for x, y in zip(out_a, out_b)))
    out["ba_build"] = _held(label + " K10's ticket design", ("U", "V", "W_blk", "g_p", "g_x",
                                                             "H_o", "scalars"),
                            out_b, out_a, TOLERANCE[call.dtype])
    b.use_built(a.built)
    a.step()
    b.step_ticket()
    cand_a, cand_b = a.candidate + (a._vinv,), b.candidate + (b._vinv,)
    out["ba_step_equal"] = all(same_bits(x, y) for x, y in zip(cand_a, cand_b))
    out.update(_hold_step(label + " K11's ticket design", call, a.built, sa, b.candidate,
                          a.candidate))
    out.update(hold_commit_designs(a, b))
    return out


def hold_commit_designs(a, b) -> dict:
    """K12's two designs on one candidate: ``b`` (a ``BABinding``) takes
    ``a``'s candidate and state, then ``a`` launches the cluster design and
    ``b`` the ticket design. Returns whether t, q, X and every scalar are
    equal bit for bit (``ba_commit_equal``) and the largest difference
    relative to each output's magnitude (``ba_commit``)."""
    b.use_candidate(a.candidate)
    for x, y in zip((b.t, b.q, b.X, b.scalars), (a.t, a.q, a.X, a.scalars)):
        x.copy_(y)
    a.commit()
    b.commit_ticket()
    outs, refs = (b.t, b.q, b.X, b.scalars), (a.t, a.q, a.X, a.scalars)
    return dict(ba_commit_equal=all(same_bits(x, y) for x, y in zip(outs, refs)),
                ba_commit=max(rel_diff(x, y) for x, y in zip(outs, refs)))


def hold_commit_designs_calls(calls: List[BACall]) -> dict:
    """K12's two designs alone on every recorded iteration
    (:func:`hold_commit_designs` on the launched K10's and K11's outputs at
    the iteration's state): the iterations, those bit-equal and the largest
    difference relative to each output's magnitude."""
    from ..ops import cuda_ba

    n = dict(iterations=0, ba_commit_equal=0, ba_commit=0.0)
    for call in calls:
        (pa, sa), (pb, sb) = call.fresh(), call.fresh()
        a = cuda_ba.BABinding(pa, call.opts, sa, own=False)
        b = cuda_ba.BABinding(pb, call.opts, sb, own=False)
        a.build()
        a.step()
        got = hold_commit_designs(a, b)
        n["iterations"] += 1
        n["ba_commit_equal"] += got["ba_commit_equal"]
        n["ba_commit"] = max(n["ba_commit"], got["ba_commit"])
    return n


def hold_designs_calls(calls: List[BACall]) -> dict:
    """:func:`hold_designs` on every recorded iteration: the iterations, how
    many were bit-equal by kernel, K11's within the bound of each output's
    magnitude and checked against its roundoff bound (its largest share),
    and the largest difference by kernel."""
    n = dict(iterations=0, ba_build_equal=0, ba_step_equal=0, ba_commit_equal=0, ba_build=0.0,
             ba_step=0.0, ba_commit=0.0, step_within=0, step_checked=0, step_share=0.0)
    for call in calls:
        got = hold_designs(call)
        n["iterations"] += 1
        for k in BA_KERNELS:
            n[k + "_equal"] += got[k + "_equal"]
            n[k] = max(n[k], got[k])
        n["step_within"] += got["step_status"] == "within the bound"
        n["step_checked"] += got["ba_step_checked"]
        n["step_share"] = max(n["step_share"], got["ba_step_share"])
    return n


# each design's stamp id and its phases, by the stamp slots that end them
# (bundle_adjust.cu's kStamp* and its stamp() calls); "last" phases are the
# last CTA's (after the ticket), "each" the mean over the slices' CTAs
_STAMPS = {
    ("ba_build", "build_ticket"): 2, ("ba_step", "step_ticket"): 3,
    ("ba_build", "build"): 0, ("ba_step", "step"): 1,
    ("ba_commit", "commit"): 4, ("ba_commit", "commit_ticket"): 5}


def _split_one(kernel: str, method: str, st: np.ndarray, C: int) -> Dict[str, float]:
    """One launch's phases in microseconds from its stamps ``st`` [CTAs,
    slots] (ns; 0 where a CTA did not stamp that slot)."""
    us = lambda a, b: (float(b) - float(a)) * 1e-3   # noqa: E731
    sl = st[:C].astype(np.float64)
    t0 = sl[:, 0].min()
    each = lambda i, j: float(np.mean(sl[:, j] - sl[:, i])) * 1e-3   # noqa: E731
    if method == "step":
        solver = sl[:, 7] > 0
        return {"phase 1 (V^-1, W_blk gauged), each CTA": each(0, 1),
                "phase 2 (W V^-1), each CTA": each(1, 2),
                "phase 3 (S's slice partials), each CTA": each(2, 3),
                "first start to the last CTA's phase 3": us(t0, sl[:, 3].max()),
                "grid barrier 1": us(sl[:, 3].max(), np.median(sl[:, 4])),
                "partial sums, a share each": each(4, 5),
                "grid barrier 2": us(sl[:, 5].max(), np.median(sl[:, 6])),
                "S into shared memory": float(np.mean(sl[solver, 7] - sl[solver, 6])) * 1e-3,
                "factorisation and solves": float(np.mean(sl[solver, 8] - sl[solver, 7])) * 1e-3,
                "dp to every CTA": float(np.mean(sl[:, 9] - np.where(solver, sl[:, 8],
                                                                    sl[:, 6]))) * 1e-3,
                "back-substitution, each CTA": each(9, 10),
                "total": us(t0, sl[:, 10].max()),
                # CTA 0's clock64 cycles in the factorisation's sub-phases
                "factorisation cycles: diagonal blocks": float(st[0, 12]),
                "factorisation cycles: panels": float(st[0, 13]),
                "factorisation cycles: trailing updates": float(st[0, 14]),
                "factorisation cycles: L^T x = z": float(st[0, 15]),
                "phase 3 cycles (thread 0)": float(st[0, 16])}
    if method == "commit":
        # without a barrier: thread 0 at the observations' end and at its
        # stores of the slice sums (its arrival), the prior's lane 0 at the
        # edges' end (its arrival) and at its sum's; the rest after one
        arrive = max(sl[:, 2].max(), sl[:, 3].max())
        return {"observations, each CTA": each(0, 1),
                "slice sums and their stores to every rank, each CTA": each(1, 2),
                "the prior's edges and dp's check, its warp": each(0, 3),
                "the prior's sum, its lane 0": each(3, 4),
                "first start to the last arrival": us(t0, arrive),
                "cluster barrier": us(arrive, np.median(sl[:, 5])),
                "partial sums and decision": each(5, 6), "commit, each CTA": each(6, 7),
                "total": us(t0, sl[:, 7].max())}
    if method == "build":
        last = int(np.argmax(st[:C + 1, 3]))
        e = st[C] if st.shape[0] > C and st[C, 0] else None
        return {"observations, each CTA": each(0, 1), "slice sums, each CTA": each(1, 2),
                "the prior, its own CTA": 0.0 if e is None else us(e[0], e[2]),
                "first start to the last slice's end": us(t0, sl[:, 2].max()),
                "ticket": us(max(sl[:, 2].max(), 0 if e is None else float(e[2])),
                             st[last, 3]),
                "partial sums": us(st[last, 3], st[last, 4]),
                "g_p and the scalars": us(st[last, 4], st[last, 5]),
                "total": us(t0, st[last, 5]),
                # CTA 0's thread 0, clock64 cycles
                "cycles: the poses' setup": float(st[0, 16]),
                "cycles: thread 0's observations": float(st[0, 17])}
    if method == "commit_ticket":
        last = int(np.argmax(sl[:, 3]))
        L = sl[last]
        return {"observations, each CTA": each(0, 1), "slice sums, each CTA": each(1, 2),
                "first start to the last CTA's slice sums": us(t0, L[2]),
                "ticket": us(L[2], L[3]), "partial sums": us(L[3], L[4]),
                "edges and the dp check": us(L[4], L[5]), "prior sum": us(L[5], L[6]),
                "decision": us(L[6], L[7]), "copy": us(L[7], L[8]), "total": us(t0, L[8])}
    last = int(np.argmax(sl[:, 4]))
    L = sl[last]
    if method == "step_ticket":
        return {"phase 1 (V^-1, W_blk gauged), each CTA": each(0, 1),
                "phase 2 (W V^-1), each CTA": each(1, 2),
                "phase 3 (S's slice partials), each CTA": each(2, 3),
                "first start to the last CTA's phase 3": us(t0, L[3]),
                "ticket": us(L[3], L[4]), "partial sums (S assembled)": us(L[4], L[5]),
                "factorisation": us(L[5], L[6]), "solves": us(L[6], L[7]),
                "back-substitution and candidate": us(L[7], L[8]), "total": us(t0, L[8])}
    return {"observations, each CTA": each(0, 1), "slice sums, each CTA": each(1, 2),
            "first start to the last CTA's slice sums": us(t0, L[2]),
            "ticket": us(L[2], L[3]), "partial sums": us(L[3], L[4]), "edges": us(L[4], L[5]),
            "H_o dense and g_p": us(L[5], L[6]), "costs": us(L[6], L[7]),
            "total": us(t0, L[7])}


def phase_split(kernel: str, method: str, calls: List[BACall], n: int = 20) -> Dict[str, float]:
    """The median over (at most ``n`` of) the recorded ``calls`` of each
    phase's microseconds in one launch of ``kernel``'s design ``method``,
    from the stamps of ``bundle_adjust.cu``'s harness-only build (thread 0
    of each CTA reading %globaltimer at a phase's end, after a barrier of
    its CTA; the barriers the stamps add make this build a little slower
    than the path's). Launches one at a time, each alone on the stream."""
    import ctypes

    from ..ops import cuda_ba

    if not torch.cuda.is_available():
        raise RuntimeError("the phase split needs a CUDA device")
    lib = cuda_ba.library(clocked=True)
    dims = tuple(lib.ba_phase_clocks(i) for i in (1, 2, 3))
    stamps = lib.ba_stamps
    stamps.argtypes, stamps.restype = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    buf = np.zeros(dims, dtype=np.uint64)
    kid = _STAMPS[kernel, method]
    rows = []
    for call in calls[:n]:
        launch = _bindings(kernel, [call], method, clocked=True)[0]
        C = cuda_ba.ba_layout(call.W, call.M, call.scalars.element_size()).ctas
        stream = torch.cuda.current_stream().cuda_stream
        for reset in (1, 0):
            if reset:
                err = stamps(None, 1, stream)
                launch()
            else:
                err = stamps(buf.ctypes.data, 0, stream)
            if err:
                raise RuntimeError(f"ba_stamps failed: CUDA error {err}")
        rows.append(_split_one(kernel, method, buf[kid], C))
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def cholesky_solve_ordered(S: torch.Tensor, rhs: torch.Tensor):
    """K11's Cholesky solve of S x = rhs in its order of operations (the
    cooperative design's ``factor_solve``): S's lower triangle with rhs as
    row D, right-looking, each entry updated once a pivot in pivot order (a
    rounded product, then a rounded difference) and scaled by its pivot's
    reciprocal square root r_j, the forward sweep z the last row; then x_j =
    z_j r_j for j from the last, each z_i taking x_j L_ji in descending j.
    K11's 6 x 6 blocks do not change this order (torch's rsqrt may round
    otherwise than the card's). Returns (x, ok); x is NaN where a pivot is
    not > 0 (cholesky_ex's info != 0)."""
    D = S.shape[0]
    A = torch.cat([S, rhs[None, :]], 0).clone()
    rp = S.new_empty(D)
    for j in range(D):
        d = A[j, j]
        if not bool(d > 0):
            return torch.full_like(rhs, float("nan")), False
        rp[j] = torch.rsqrt(d)
        A[j + 1:, j] = A[j + 1:, j] * rp[j]
        A[j + 1:, j + 1:] = A[j + 1:, j + 1:] - A[j + 1:, j, None] * A[None, j + 1:D, j]
    z = A[D].clone()
    x = torch.empty_like(z)
    for j in range(D - 1, -1, -1):
        x[j] = z[j] * rp[j]
        z[:j] = z[:j] - A[j, :j] * x[j]
    return x, True


def window_arrays(W: int = 7, M: int = 512, live: int = 300, seed: int = 0) -> dict:
    """``chip_smoke.py`` 8a's BA window: W cameras along a line over M
    landmark slots (``live`` of them observed, the rest padding), noisy and
    partly missing observations, odometry priors of weight 1e6, perturbed
    starts; the arrays of ``interop.ba_problem_from_arrays``."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M), rng.uniform(3, 6, M)], -1)
    ts = np.stack([[0.15 * w, 0.02 * w, 0.05 * w] for w in range(W)])
    K = np.array([480.0, 480.0, 319.5, 239.5])
    obs = np.stack([np.stack([(X[:, 0] - t[0]) / (X[:, 2] - t[2]) * K[0] + K[2],
                              (X[:, 1] - t[1]) / (X[:, 2] - t[2]) * K[1] + K[3]], -1)
                    for t in ts]) + rng.normal(0, 0.5, (W, M, 2))
    point_mask = (np.arange(M) < live).astype(np.float64)
    obs_mask = (rng.random((W, M)) > 0.2) * point_mask[None]
    odom = (np.diff(ts, axis=0) + rng.normal(0, 1e-3, (W - 1, 3)),
            np.tile([0.0, 0.0, 0.0, 1.0], (W - 1, 1)), np.full(W - 1, 1e6))
    return dict(pose_t=ts + rng.normal(0, 0.02, ts.shape) * (np.arange(W) > 0)[:, None],
                pose_q=np.tile([0.0, 0.0, 0.0, 1.0], (W, 1)),
                points=X + rng.normal(0, 0.05, X.shape), obs_xy=obs, obs_mask=obs_mask, K=K,
                point_mask=point_mask, odom=odom, pose_mask=np.ones(W))


def main() -> int:
    """On the card: 8a's window through run_bundle_adjustment on the
    kernels, its iterations recorded; each held against the plain versions
    and the ticket designs against the launched ones; the phase split of
    both designs of K10, K11 and K12; and K10-K12 timed (both designs in
    turn).
    Prints the card, each result and the kernels' registers and spills."""
    import json

    from .. import interop
    from ..backend import ba
    from ..ops import cuda_ba, cuda_build

    if not torch.cuda.is_available():
        raise RuntimeError("ba_kernels needs a CUDA device")
    print(kv.card_line())
    cuda_ba.zero_launch_counts()
    with record_ba_calls() as calls:
        _, summary = ba.run_bundle_adjustment(
            interop.ba_problem_from_arrays(**window_arrays(), device="cuda"), ba.BAOptions())
    torch.cuda.synchronize()
    print(f"8a: {summary.num_iterations} iterations, launches {cuda_ba.launch_counts()}, "
          f"the ticket designs' {cuda_ba.earlier_launch_counts()}")
    name = None
    for line in cuda_build.BUILD_LOG.get("bundle_adjust", "").splitlines():
        found = re.search(r"Compiling entry function '_Z\w*?(ba_\w+?_kernel)I([fd])", line)
        if found:
            name = f"{found.group(1)}<{'float' if found.group(2) == 'f' else 'double'}>"
        elif name and ("registers" in line or "stack frame" in line):
            print(f"  {name}: {line.split(':', 1)[-1].strip() if 'Used' in line else line.strip()}")
    got = hold_ba_calls(calls)
    print("held against the plain versions:", {k: v for k, v in got.items() if k != "flips"})
    print("the ticket designs against the launched ones:", hold_designs_calls(calls))
    for kernel, methods in DESIGNS.items():
        for method in methods:
            print(f"phases {kernel} {method} (us):",
                  json.dumps(phase_split(kernel, method, calls)))
    time_ba_rows("8a window 7", calls)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
