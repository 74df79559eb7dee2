"""The loop closure's kernels K13-K15 on the backend's own inputs, on one
NVIDIA GPU: record, hold against the plain versions, time.

K13 ``pnp_solve`` is ``csrc/pnp.cu``, K14 ``pg_build`` and K15 ``pg_step``
``csrc/pose_graph.cu`` (``ops/cuda_backend.py``); their plain versions are
``backend/geometry.py``'s ``solve_pnp_plain`` with ``pnp_residual_norms``
and ``backend/pose_graph.py``'s ``pg_build_plain`` and ``pg_step_plain``.
On the card, ``python -m mba_vo_tpu_torch.experiments.backend_kernels``
runs :func:`main` on ``chip_smoke.py`` 8a's problems.

:func:`record_pnp_calls` records every K13 call of a run (its inputs and
its row); :func:`record_pg_calls` every pose-graph iteration on the
kernels (the graph and a copy of the state at the iteration's start: every
sum of K14 and K15 has one fixed order, so that state determines the
iteration's two launches bit for bit).

:func:`hold_pnp` holds K13 against the plain version on the same inputs:
the final pose within :data:`POSE_TOL` or, where that is larger, within what
roundoff in the sums can move it by (:func:`pnp_pose_bound`), the cost within :data:`COST_RTOL`
of its magnitude and the residual norms within :data:`NORM_TOL` px of the
plain version's at the kernel's pose, the two final costs within
:data:`COST_RTOL` of each other (but where a point is seen through the
depth clamp), and the loop stage's gates on the
norms (each problem's inlier count against ``loop_min_matches``) equal, a
point whose two norms lie on the two sides of the inlier threshold counted
as a knife edge; :func:`pnp_decision_flips` counts the
iterations whose decision (accept or reject) differs, from runs cut after
each iteration (reported, not held). :func:`hold_pg` replays an iteration:
K14 against ``pg_build_plain`` (H and g within :data:`TOLERANCE` of each
output's magnitude, the cost too), K15 against ``pg_step_plain`` on K14's
outputs: the decisions equal (or a knife edge: the two candidate costs on
the two sides of the cost, or the relative decreases on the two sides of
``min_rel_decrease``, counted), the candidate cost within the bound, and
the poses within what the solve's roundoff can move them by
(:func:`step_bound`: K15 factors by Cholesky, the plain version by LU).

:func:`time_backend_rows` times each kernel as ``ba_kernels.time_ba_rows``
times K10-K12: ``ms`` a call (K13 through ``pnp_solve_cuda``, K14 and K15
through their binding), ``device_ms`` warm in a replayed CUDA graph,
``device_cold_ms`` after an L2 flush, the plain version's call, the bound
(:func:`backend_bound`) and, for K15, the library's Cholesky
(``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve``) on the same Hd,
a yardstick the port never calls. K15 is timed on a binding whose
``min_rel_decrease`` is -inf, so that no launch finds its state done.
:func:`pg_cholesky_solve_ordered` is K15's solve in its order of
operations, in torch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from . import kernel_variants as kv
from ..backend.vo_backend import _qconj, _qmul, _qrot
from .ba_kernels import UNIT_ROUNDOFF, rel_diff, same_bits
from .residual_kernels import F64_FLOPS_PER_S, F64_MMA_FLOPS_PER_S

BACKEND_KERNELS = ("pnp_solve", "pg_build", "pg_step")
# K13 against its plain version: the final pose (absolute; the larger of
# this and what the roundoff of the sums can move it by, pnp_pose_bound:
# the two solves' decisions part at the optimum, where a step's cost change
# is below the cost's roundoff, and on the loop benchmark's own problems in
# float64 that moves a pose by up to ~2e-9), and the cost (of its magnitude) and the residual norms
# (px, of the larger of 1 and the norm) against the plain version's at the
# kernel's pose, by dtype; in float32 a norm of a point at ~600 px from the
# principal point rounds to ~1e-4 px
POSE_TOL = {torch.float64: 1e-9, torch.float32: 1e-5}
COST_RTOL = {torch.float64: 1e-9, torch.float32: 1e-5}
NORM_TOL = {torch.float64: 1e-8, torch.float32: 1e-3}
# K14 and K15's candidate cost against the plain stages, of each output's
# magnitude
TOLERANCE = {torch.float32: 1e-5, torch.float64: 1e-12}
# the loop stage's gates (backend/vo_backend.py's BackendConfig defaults)
LOOP_INLIER_PX = 3.0
LOOP_MIN_MATCHES = 20


@dataclasses.dataclass
class PnPCall:
    """One recorded K13 call: its inputs (copies) and its row."""
    points: torch.Tensor
    obs_xy: torch.Tensor
    mask: torch.Tensor
    K: torch.Tensor
    init_t: torch.Tensor
    init_q: torch.Tensor
    huber_a: float
    iterations: int
    row: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.points.dtype

    @property
    def B(self) -> int:
        return self.points.shape[0]

    @property
    def N(self) -> int:
        return self.points.shape[1]

    def args(self, iterations=None):
        return (self.points, self.obs_xy, self.mask, self.K, self.init_t, self.init_q,
                self.huber_a, self.iterations if iterations is None else iterations)


@contextlib.contextmanager
def record_pnp_calls() -> Iterator[List[PnPCall]]:
    """Record every ``ops.cuda_backend.pnp_solve_cuda`` call with B > 0 made
    inside the block, in order; the calls still run. Restored on leaving."""
    from ..ops import cuda_backend

    calls: List[PnPCall] = []
    original = cuda_backend.pnp_solve_cuda

    def solve(points, obs_xy, mask, K, init_t, init_q, huber_a=2.0, max_iterations=30):
        ins = tuple(x.clone() for x in (points, obs_xy, mask, K, init_t, init_q))
        row = original(points, obs_xy, mask, K, init_t, init_q, huber_a, max_iterations)
        if points.shape[0] > 0:
            calls.append(PnPCall(*ins, float(huber_a), int(max_iterations), row.clone()))
        return row

    cuda_backend.pnp_solve_cuda = solve
    try:
        yield calls
    finally:
        cuda_backend.pnp_solve_cuda = original


def pnp_plain_row(call: PnPCall, iterations=None) -> torch.Tensor:
    """The plain version's row on the call's inputs (on their device)."""
    from ..backend import geometry
    from ..core.transform import Pose

    p, o, m, K, t, q, a, n = call.args(iterations)
    pose, cost = geometry.solve_pnp_plain(p, o, m, K, Pose(t, q), a, n)
    return torch.cat([geometry.pnp_residual_norms(p, o, K, pose), cost[:, None], pose.t,
                      pose.q], dim=1)


def pnp_kernel_row(call: PnPCall, iterations=None) -> torch.Tensor:
    from ..ops import cuda_backend

    return cuda_backend.pnp_solve_cuda(*call.args(iterations))


def _gates(row: torch.Tensor, mask: torch.Tensor, N: int) -> torch.Tensor:
    """The loop stage's keep gate of each problem: its inliers (norm under
    LOOP_INLIER_PX where the mask is live) at least LOOP_MIN_MATCHES."""
    inl = mask * (row[:, :N] < LOOP_INLIER_PX)
    return inl.sum(dim=1) >= LOOP_MIN_MATCHES


def hold_pnp(call: PnPCall, ref: torch.Tensor = None) -> dict:
    """K13's row on the call's inputs against the plain version's (``ref``,
    else computed on the card): the final poses within :data:`POSE_TOL`, or
    within :func:`pnp_pose_bound` where that is larger, NaN where the other
    is NaN;
    the kernel's cost and norms against the plain version's cost and norms
    at the kernel's own pose (within :data:`COST_RTOL` and
    :data:`NORM_TOL`: a point seen through the depth clamp moves its norm by
    480 / 1e-6 px a metre of the pose, so the two solves' norms are compared
    each at its own pose); the two solves' final costs within
    :data:`COST_RTOL` of the plain version's (a check of the solve itself,
    where the pose bound is wide), but on a problem with a live point seen
    through the depth clamp at the plain version's final pose
    (:func:`_clamped`; counted), whose cost moves with the pose by 480 /
    1e-6 px a metre, so that two orders of the plain version's own sums
    part its final costs by up to ~3e-3 in float32; the keep gates equal, but where a live
    point's two norms lie on the two sides of the inlier threshold (a knife
    edge, counted); the kernel's row against the recorded one bit for bit
    (the replay). Returns the largest differences (``cost_between``: the
    two solves' final costs)."""
    dt = call.dtype
    N = call.N
    got = pnp_kernel_row(call)
    ref = pnp_plain_row(call) if ref is None else ref
    label = f"PnP call (B {call.B}, N {N}, {call.iterations} iterations)"
    if not torch.equal(torch.isnan(got[:, N:]), torch.isnan(ref[:, N:])):
        raise AssertionError(f"{label}: the kernel's NaN entries differ from the plain version's")
    at = dataclasses.replace(call, init_t=got[:, N + 1:N + 4].contiguous(),
                             init_q=got[:, N + 4:].contiguous())
    own = pnp_plain_row(at, 0).double()
    got64, ref64 = got.double(), ref.double()

    def finite_diff(a, b):
        fin = ~(torch.isnan(a) & torch.isnan(b))
        return torch.where(fin, (a - b).abs(), torch.zeros_like(a))
    pose_b = finite_diff(got64[:, N + 1:], ref64[:, N + 1:]).amax(dim=1)
    d = finite_diff(got64, own)
    def scale(x, floor):
        return torch.nan_to_num(x.abs(), nan=1.0).clamp(min=floor)
    norms = float((d[:, :N] / scale(own[:, :N], 1.0)).max()) if N else 0.0
    cost = float((d[:, N] / scale(own[:, N], 1e-300)).max())
    between_b = finite_diff(got64[:, N], ref64[:, N]) / scale(ref64[:, N], 1e-300)
    clamped = _clamped(call, ref)
    between = float(between_b.max())
    between_held = float(torch.where(clamped, 0.0, between_b).max()) if call.B else 0.0
    tol = torch.full_like(pose_b, POSE_TOL[dt])
    if bool((pose_b > tol).any()):
        tol = torch.maximum(tol, pnp_pose_bound(call, ref))
    pose = float(pose_b.max())
    if not bool((pose_b <= tol).all()):
        b = int(torch.argmax(pose_b / tol))
        raise AssertionError(f"{label}: problem {b}'s pose differs from the plain version's by "
                             f"{float(pose_b[b]):.3e} (bound {float(tol[b]):.3e})")
    for name, dd, t in (("cost", cost, COST_RTOL[dt]), ("norms", norms, NORM_TOL[dt])):
        if not dd <= t:
            raise AssertionError(f"{label}: the {name} differs from the plain version's at "
                                 f"the kernel's pose by {dd:.3e} (bound {t:.0e})")
    if not between_held <= COST_RTOL[dt]:
        raise AssertionError(f"{label}: the final cost differs from the plain version's by "
                             f"{between_held:.3e} of its magnitude (bound {COST_RTOL[dt]:.0e})")
    mask = call.mask.to(ref.dtype)
    gk, gp = _gates(got, mask, N), _gates(ref, mask, N)
    lo = torch.minimum(got[:, :N], ref[:, :N])
    hi = torch.maximum(got[:, :N], ref[:, :N])
    edge = ((lo < LOOP_INLIER_PX) & (hi >= LOOP_INLIER_PX) & (mask > 0)).any(dim=1)
    if bool(((gk != gp) & ~edge).any()):
        raise AssertionError(f"{label}: the keep gates differ from the plain version's")
    return dict(pose=pose, pose_share=float((pose_b / tol).max()), cost=cost, norms=norms,
                cost_between=between, cost_between_held=between_held,
                clamped=int(clamped.sum()), problems=call.B, gates_equal=int((gk == gp).sum()),
                knife_edges=int(((gk != gp) & edge).sum()), replayed=same_bits(got, call.row),
                kept=int(gk.sum()))


def _clamped(call: PnPCall, ref: torch.Tensor) -> torch.Tensor:
    """[B] whether a problem has a live point at a depth of at most 1e-6
    (the projection's clamp) at the reference's final pose."""
    from ..core.lie import quat_conjugate, quat_rotate

    N = call.N
    t, q = ref[:, N + 1:N + 4], ref[:, N + 4:]
    z = quat_rotate(quat_conjugate(q)[:, None, :], call.points - t[:, None, :])[..., 2]
    return ((z <= 1e-6) & (call.mask > 0)).any(dim=1)


def pnp_pose_bound(call: PnPCall, ref: torch.Tensor) -> torch.Tensor:
    """[B] what roundoff in the sums of N terms can move a problem's final
    pose by between two implementations that sum in different orders, in
    float64 at the reference's final pose: the step's first-order error
    ||H^-1|| (||E_g|| + ||E_H|| ||x - x0||), E = c u times the magnitudes of
    the terms of g and H (c = 2N), and the width of the valley in which the
    cost's own roundoff c u cost hides the minimum, sqrt(2 c u cost /
    lambda_min(H)); both twice (one for each implementation)."""
    from ..backend.ba import reprojection_jacobians
    from ..backend.geometry import _project_local
    from ..core.lie import quat_conjugate, quat_rotate

    N = call.N
    dd = torch.float64
    pts, obs, m, K = (x.to(dd) for x in (call.points, call.obs_xy, call.mask, call.K))
    t, q = ref[:, N + 1:N + 4].to(dd), ref[:, N + 4:].to(dd)
    cost = ref[:, N].to(dd).abs()
    q_inv = quat_conjugate(q)[:, None, :]
    Pc = quat_rotate(q_inv, pts - t[:, None, :])
    eye = torch.eye(3, dtype=dd, device=pts.device)
    Rt = quat_rotate(q_inv, eye).transpose(-1, -2)
    r = _project_local(pts, obs, K, t, q)
    J, _ = reprojection_jacobians(Pc, Rt[:, None], K)
    x = 0.5 * (r * r).sum(-1)
    a = call.huber_a
    w = torch.where(x > a * a, a / torch.sqrt(x.clamp(min=1e-24)), torch.ones_like(x)) * m
    n = m.sum(-1).clamp(min=1.0)
    H = torch.einsum("bnia,bn,bnic->bac", J, w, J) / n[:, None, None]
    aJ = J.abs()
    E_H = torch.einsum("bnia,bn,bnic->bac", aJ, w.abs(), aJ) / n[:, None, None]
    E_g = torch.einsum("bnia,bn,bni->ba", aJ, w.abs(), r.abs()) / n[:, None]
    cu = 2.0 * N * UNIT_ROUNDOFF[call.dtype]
    bad = ~torch.isfinite(H).flatten(1).all(dim=1)      # a NaN point: no bound
    H, E_H, E_g = (torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0) for x in (H, E_H, E_g))
    lam = torch.linalg.eigvalsh(0.5 * (H + H.transpose(-1, -2)))
    lo = lam[:, 0].clamp(min=1e-300)
    moved = torch.linalg.vector_norm(
        torch.cat([t - call.init_t.to(dd), q - call.init_q.to(dd)], 1), dim=1)
    lin = (cu / lo) * (torch.linalg.vector_norm(E_g, dim=1)
                       + torch.linalg.matrix_norm(E_H, 2) * moved)
    valley = torch.sqrt(2.0 * cu * cost / lo)
    out = 2.0 * (lin + valley)
    return torch.where(torch.isfinite(out) & ~bad, out, torch.zeros_like(out)).to(ref.device)


def pnp_decision_flips(call: PnPCall, iterations: int = None) -> int:
    """The iterations (over all problems) whose decision differs between K13
    and the plain version: a decision read from runs cut after k and after
    k + 1 iterations (the pose moved or not)."""
    n = call.iterations if iterations is None else iterations
    N = call.N
    flips = 0
    prev_k = pnp_kernel_row(call, 0)[:, N + 1:]
    prev_p = pnp_plain_row(call, 0)[:, N + 1:]
    for k in range(1, n + 1):
        cur_k = pnp_kernel_row(call, k)[:, N + 1:]
        cur_p = pnp_plain_row(call, k)[:, N + 1:]
        moved_k = (cur_k != prev_k).any(dim=1)
        moved_p = (cur_p != prev_p).any(dim=1)
        flips += int((moved_k != moved_p).sum())
        prev_k, prev_p = cur_k, cur_p
    return flips


def hold_pnp_calls(calls: List[PnPCall]) -> dict:
    """:func:`hold_pnp` on every recorded call; the worst differences, the
    problems held, their gates equal and at a knife edge, and the calls
    replayed bit for bit."""
    out = dict(calls=0, problems=0, pose=0.0, pose_share=0.0, cost=0.0, norms=0.0,
               cost_between=0.0, cost_between_held=0.0, clamped=0, gates_equal=0,
               knife_edges=0, replayed_equal=0, largest_batch=0)
    for c in calls:
        got = hold_pnp(c)
        out["calls"] += 1
        out["largest_batch"] = max(out["largest_batch"], c.B)
        for k in ("pose", "pose_share", "cost", "norms", "cost_between", "cost_between_held"):
            out[k] = max(out[k], got[k])
        for k in ("problems", "clamped", "gates_equal", "knife_edges"):
            out[k] += got[k]
        out["replayed_equal"] += int(got["replayed"])
    return out


# ------------------------------------------------------------------ the pose graph


@dataclasses.dataclass
class PGCall:
    """One recorded pose-graph iteration: the poses at its start and the
    scalars (copies), the edges, the options and the run it belongs to."""
    t: torch.Tensor
    q: torch.Tensor
    scalars: torch.Tensor
    edges: object
    opts: object
    run: int

    @property
    def dtype(self) -> torch.dtype:
        return self.t.dtype

    @property
    def N(self) -> int:
        return self.t.shape[0]

    @property
    def E(self) -> int:
        return self.edges.i.shape[0]

    def poses(self):
        from ..core.transform import Pose

        return Pose(t=self.t, q=self.q)

    def fresh(self):
        """(poses, scalars) copies, for a call that writes them in place."""
        from ..core.transform import Pose

        return Pose(t=self.t.clone(), q=self.q.clone()), self.scalars.clone()


@contextlib.contextmanager
def record_pg_calls() -> Iterator[List[PGCall]]:
    """Record every ``ops.cuda_backend.PGBinding.build`` call made inside the
    block (an iteration's start on the kernels), in order; the calls still
    run. Restored on leaving."""
    from ..ops import cuda_backend

    calls: List[PGCall] = []
    original = cuda_backend.PGBinding.build
    runs = [0]

    def build(self):
        if not hasattr(self, "_recorded_run"):
            self._recorded_run = runs[0]
            runs[0] += 1
        calls.append(PGCall(self.t.clone(), self.q.clone(), self.scalars.clone(), self.edges,
                            self.opts, self._recorded_run))
        return original(self)

    cuda_backend.PGBinding.build = build
    try:
        yield calls
    finally:
        cuda_backend.PGBinding.build = original


def pg_blocks(poses, edges):
    """K14's H and g written out in torch in its structure: each edge's
    weighted Jacobians (node 0's times 0) add J_a^T J_c to the blocks (a, c)
    of its two nodes and J_a^T r to g's blocks, the edges in order. Returns
    (H [6N, 6N], g [6N]); equal to ``pg_build_plain``'s dense product up to
    the order of each entry's sum."""
    from ..backend.ba import relative_pose_jacobians

    N = poses.t.shape[0]
    i, j = edges.i, edges.j
    r, J_i, J_j = relative_pose_jacobians(poses.t[i], poses.q[i], poses.t[j], poses.q[j],
                                          edges.t_ij, edges.q_ij)
    gauge = torch.ones(N, dtype=poses.t.dtype, device=poses.t.device)
    gauge[0] = 0.0
    sw = torch.sqrt(edges.weight)
    Ji = J_i * gauge[i][:, None, None] * sw[:, None, None]
    Jj = J_j * gauge[j][:, None, None] * sw[:, None, None]
    rw = r * sw[:, None]
    blocks = poses.t.new_zeros((N * N, 6, 6))
    for a, c, A, C in ((i, i, Ji, Ji), (j, j, Jj, Jj), (i, j, Ji, Jj), (j, i, Jj, Ji)):
        blocks.index_add_(0, a * N + c, A.transpose(-1, -2) @ C)
    H = blocks.reshape(N, N, 6, 6).permute(0, 2, 1, 3).reshape(6 * N, 6 * N)
    g = poses.t.new_zeros((N, 6))
    g.index_add_(0, i, torch.einsum("eka,ek->ea", Ji, rw))
    g.index_add_(0, j, torch.einsum("eka,ek->ea", Jj, rw))
    return H, g.reshape(-1)


def pg_term_scales(poses, edges) -> Dict[str, float]:
    """The largest magnitude of the terms H's and g's entries sum (the
    absolute weighted Jacobians' products), in float64."""
    from ..backend.ba import relative_pose_jacobians
    from ..core.transform import Pose

    p64 = Pose(poses.t.double(), poses.q.double())
    e64 = edges._replace(t_ij=edges.t_ij.double(), q_ij=edges.q_ij.double(),
                         weight=edges.weight.double())
    N = p64.t.shape[0]
    i, j = e64.i, e64.j
    r, J_i, J_j = relative_pose_jacobians(p64.t[i], p64.q[i], p64.t[j], p64.q[j], e64.t_ij,
                                          e64.q_ij)
    sw = torch.sqrt(e64.weight)[:, None, None]
    E = r.shape[0]
    e = torch.arange(E, device=r.device)
    J = torch.zeros((E, 6, N, 6), dtype=torch.float64, device=r.device)
    J[e, :, i] = (J_i * sw).abs()
    J[e, :, j] = (J_j * sw).abs()
    J = J.reshape(E * 6, N * 6)
    rw = (r * sw[:, :, 0]).abs().reshape(-1)
    return dict(H=float((J.T @ J).max()), g=float((J.T @ rw).max()))


def damped_system(H: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """K15's Hd = H + (lambda diag(H) + 1e-12) I + the gauge's diagonal."""
    D = H.shape[0]
    eye = torch.eye(D, dtype=H.dtype, device=H.device)
    gd = torch.zeros(D, dtype=H.dtype, device=H.device)
    gd[:6] = 1.0
    return H + (lam * torch.diagonal(H) + 1e-12) * eye + torch.diag(gd)


def pg_cholesky_solve_ordered(Hd: torch.Tensor, g: torch.Tensor):
    """K15's solve of Hd x = g in its order of operations: Hd's lower
    triangle with g as row D, right-looking, each entry updated once a
    pivot in pivot order (a rounded product, then a rounded difference), the
    column below each pivot divided by its square root, the forward sweep
    the last row; then x_j = z_j / L_jj for j from the last, each z_i taking
    L_ji x_j in descending j. Returns (x, ok); x is NaN where a pivot is not
    > 0."""
    D = Hd.shape[0]
    A = torch.cat([torch.tril(Hd), g[None, :]], 0).clone()
    for j in range(D):
        d = A[j, j]
        if not bool(d > 0):
            return torch.full_like(g, float("nan")), False
        s = torch.sqrt(d)
        A[j + 1:, j] = A[j + 1:, j] / s
        A[j, j] = s
        A[j + 1:, j + 1:] = A[j + 1:, j + 1:] - A[j + 1:, j, None] * A[None, j + 1:D, j]
    z = A[D].clone()
    x = torch.empty_like(z)
    for j in range(D - 1, -1, -1):
        x[j] = z[j] / A[j, j]
        z[:j] = z[:j] - A[j, :j] * x[j]
    return x, True


def step_bound(Hd: torch.Tensor, x: torch.Tensor) -> float:
    """What roundoff alone can move the solution x of Hd x = g by, to first
    order, between two backward-stable solves (Cholesky and LU) in the
    working precision: 2 (c u kappa_2(Hd) ||x||), c = 2 D."""
    D = Hd.shape[0]
    u = UNIT_ROUNDOFF[Hd.dtype]
    kappa = float(torch.linalg.cond(Hd.to(torch.float64)))
    return 2.0 * (2.0 * D * u * kappa * float(torch.linalg.vector_norm(x.to(torch.float64))))


def hold_pg(call: PGCall) -> dict:
    """Replay one iteration through K14-K15 and the plain stages on the
    same inputs (module docstring). Returns the largest differences of K14
    (of each output's magnitude) and of K15's poses (a share of their
    bound), whether the decisions flipped at a knife edge (described), the
    iteration's ok and done, and K15's state (for the replay's chain)."""
    from ..backend import pose_graph as pg
    from ..ops import cuda_backend as cb

    bound = TOLERANCE[call.dtype]
    label = f"pose-graph iteration (run {call.run}, N {call.N}, E {call.E})"
    poses, sk = call.fresh()
    H, g = cb.pg_build_cuda(poses, call.edges, sk, call.opts)
    Hp, gp, sp = pg.pg_build_plain(call.poses(), call.edges, call.scalars)
    costs = max(rel_diff(sk[cb.G_BUILD_COST:], sp[cb.G_BUILD_COST:]),
                rel_diff(sk[cb.G_COST:cb.G_COST + 1], sp[cb.G_COST:cb.G_COST + 1]))
    finite = bool(torch.isfinite(Hp).all()) and bool(torch.isfinite(gp).all())
    out = dict(pg_build=costs, finite_build=finite)
    if finite:
        # H's and g's sums cancel near the optimum: their roundoff is relative
        # to the magnitudes of their terms where those are larger
        diffs = (rel_diff(H, Hp), rel_diff(g, gp))
        if not max(diffs) <= bound:
            terms = pg_term_scales(call.poses(), call.edges)
            diffs = (rel_diff(H, Hp, terms["H"]), rel_diff(g, gp, terms["g"]))
        out["pg_build"] = max(costs, *diffs)
    if not out["pg_build"] <= bound:
        raise AssertionError(f"{label} K14: differs from pg_build_plain by {out['pg_build']:.3e} "
                             f"of its magnitude (bound {bound:.0e})")
    # K15 and the plain step on K14's outputs
    s_in = sk.clone()
    pk, sck = _clone(poses), sk.clone()
    cb.pg_step_cuda(pk, call.edges, sck, H, g, call.opts)
    pp, scp = pg.pg_step_plain(poses, call.edges, H, g, s_in, call.opts)
    cost = float(s_in[cb.G_COST])
    was_done = bool(s_in[cb.G_DONE])
    cand_k, cand_p = float(sck[cb.G_CAND_COST]), float(scp[cb.G_CAND_COST])
    rel_k, rel_p = float(sck[cb.G_REL]), float(scp[cb.G_REL])
    same = all(torch.equal(sck[i], scp[i]) for i in (cb.G_OK, cb.G_DONE, cb.G_IT, cb.G_LAM))
    out.update(flip=not same, pg_step=0.0, ok=bool(sck[cb.G_OK]), done=bool(sck[cb.G_DONE]),
               nan_step=False)
    if was_done:
        if not (same_bits(sck, s_in) and same_bits(pk.t, poses.t) and same_bits(pk.q, poses.q)):
            raise AssertionError(f"{label} K15: a done state changed")
    else:
        d_cand = abs(cand_k - cand_p) / max(abs(cand_p), 1e-300)
        if not (d_cand <= bound or (math.isnan(cand_k) and math.isnan(cand_p))):
            raise AssertionError(f"{label} K15: the candidate cost differs by {d_cand:.3e} of "
                                 f"its magnitude")
        out["pg_step"] = 0.0 if math.isnan(cand_p) else d_cand
        edge_ok = min(cand_k, cand_p) < cost <= max(cand_k, cand_p)
        m = call.opts.min_rel_decrease
        edge_done = min(rel_k, rel_p) < m <= max(rel_k, rel_p)
        if not same:
            if not (edge_ok or edge_done):
                raise AssertionError(f"{label} K15: ok / done {float(sck[cb.G_OK])} / "
                                     f"{float(sck[cb.G_DONE])} against the plain version's "
                                     f"{float(scp[cb.G_OK])} / {float(scp[cb.G_DONE])} "
                                     f"(candidate cost {cand_k!r} / {cand_p!r}, cost {cost!r})")
            out["flip_detail"] = (f"{label}: ok {float(sck[cb.G_OK]):g} / {float(scp[cb.G_OK]):g}"
                                  f", done {float(sck[cb.G_DONE]):g} / {float(scp[cb.G_DONE]):g}"
                                  f": candidate cost {cand_k!r} / {cand_p!r}, cost {cost!r}, "
                                  f"relative decrease {rel_k!r} / {rel_p!r}")
        elif not out["ok"]:
            out["nan_step"] = math.isnan(cand_k)
            if not (same_bits(pk.t, poses.t) and same_bits(pk.q, poses.q)):
                raise AssertionError(f"{label} K15: a rejected step moved the poses")
        else:
            d = max(float((pk.t - pp.t).abs().max()), float((pk.q - pp.q).abs().max()))
            floor = bound * max(1.0, float(poses.t.abs().max()))
            b = floor
            if not d <= floor:
                # past the floor: what the two solves' roundoff can move the step by
                Hd = damped_system(H, s_in[cb.G_LAM])
                x = torch.linalg.solve(Hd.to(torch.float64), g.to(torch.float64))
                b = max(floor, step_bound(Hd, x))
            if not d <= b:
                raise AssertionError(f"{label} K15: the poses differ from the plain version's "
                                     f"by {d:.3e}, past the solve's roundoff bound {b:.3e}")
            out["pg_step"] = max(out["pg_step"], d / b)
    out["state"] = (pk.t, pk.q, sck)
    return out


def _clone(p):
    from ..core.transform import Pose

    return Pose(t=p.t.clone(), q=p.q.clone())


def hold_pg_calls(calls: List[PGCall]) -> dict:
    """:func:`hold_pg` on every recorded iteration; each iteration's K15
    state against the next recorded iteration's start in the same run (bit
    for bit). Returns the largest differences, the iterations held,
    accepted and done, the transitions compared and equal, and the knife
    edges' flips (each described)."""
    from ..ops import cuda_backend as cb

    chain = cb.G_DONE + 1    # the cost, lambda, the count and done
    n = dict(iterations=0, accepted=0, done=0, nan_steps=0, transitions=0, replayed_equal=0,
             nonfinite_builds=0, pg_build=0.0, pg_step=0.0, flips=[])
    for i, call in enumerate(calls):
        got = hold_pg(call)
        n["iterations"] += 1
        n["accepted"] += got["ok"]
        n["done"] += got["done"]
        n["nan_steps"] += got["nan_step"]
        n["nonfinite_builds"] += not got["finite_build"]
        n["pg_build"] = max(n["pg_build"], got["pg_build"])
        n["pg_step"] = max(n["pg_step"], got["pg_step"])
        if got["flip"]:
            n["flips"].append(got.get("flip_detail", "a flip"))
        nxt = calls[i + 1] if i + 1 < len(calls) else None
        if nxt is not None and nxt.run == call.run:
            t, q, sc = got["state"]
            n["transitions"] += 1
            n["replayed_equal"] += int(torch.equal(t, nxt.t) and torch.equal(q, nxt.q)
                                       and torch.equal(sc[:chain], nxt.scalars[:chain]))
    return n


# ------------------------------------------------------------------ bounds, times


def backend_bound(kernel: str, itemsize: int, rate: float, B: int = 1, N: int = 256,
                  iterations: int = 30, nodes: int = 64, E: int = 65,
                  mma_rate: float = None) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time of one call, the larger
    of each input read once and each output written once at 3.35 TB/s and
    its floating-point operations at ``rate``, K15's factor, whose trailing
    updates are matrix products, at ``mma_rate`` (default ``rate``: in
    float64 the tensor cores' rate, twice the rate outside them, makes the
    bound of the factor half as long). K13 reads the points,
    observations, mask, K and init and writes the rows (~300 operations a
    correspondence an iteration: the reprojection, its Jacobian, the 27
    weighted sums and the candidate's cost; ~400 an iteration for the
    6 x 6 solve and the retraction); K14 reads the poses and edges and
    writes H and g (~4,000 operations an edge: the closed-form Jacobians
    and the four 6 x 6 block products, twice, once from each node's CTA, of
    which one pass counts); K15 reads H, g, the poses and edges and writes
    the poses and scalars (D^3 / 3 for the factor, 2 D^2 for the two
    sweeps, ~300 an edge for the candidate's cost)."""
    D = 6 * nodes
    if kernel == "pnp_solve":
        nbytes = itemsize * (B * N * 6 + 4 + 7 * B + B * (N + 8))
        ops = B * (iterations * (300 * N + 400) + 60 * N)
    elif kernel == "pg_build":
        nbytes = itemsize * (7 * nodes + 8 * E + D * D + D + 8) + 16 * E
        ops = 4000 * E + 300 * E
    else:
        nbytes = itemsize * (D * D + D + 14 * nodes + 8 * E + 16) + 16 * E
        factor = D ** 3 / 3
        ops = 2 * D * D + 300 * E + 100 * nodes
    b_ms = 1e3 * nbytes / kv.HBM_BYTES_PER_S
    o_ms = 1e3 * ops / rate
    if kernel == "pg_step":
        o_ms += 1e3 * factor / (rate if mma_rate is None else mma_rate)
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _pg_binding(call: PGCall, step: bool):
    """A binding on copies of the call's state with H and g built (K14),
    its ``min_rel_decrease`` -inf so that no K15 launch finds it done."""
    from ..ops import cuda_backend as cb

    poses, sc = call.fresh()
    opts = dataclasses.replace(call.opts, min_rel_decrease=float("-inf")) if step else call.opts
    b = cb.PGBinding(poses, call.edges, opts, sc, own=False)
    b.build()
    return b


def _cholesky_yardstick(call: PGCall):
    """The library's solve of K15's damped system: ``torch.linalg.cholesky_ex``
    of Hd and ``torch.cholesky_solve``, on the Hd and g of the call."""
    b = _pg_binding(call, True)
    torch.cuda.synchronize()
    from ..ops import cuda_backend as cb

    Hd = damped_system(b.H, b.scalars[cb.G_LAM])
    rhs = b.g[:, None].clone()

    def solve():
        L, _ = torch.linalg.cholesky_ex(Hd)
        return torch.cholesky_solve(rhs, L)
    return solve


def _row(label, kernel, calls, fns, plain, bounds, dt, reps, inner, library=None, **shape):
    w_inner = len(fns) * math.ceil(50 / len(fns))
    times = [(kv.time_ms(fns[0], reps, inner), kv.device_ms(fns, reps, w_inner),
              kv.device_flushed_ms(fns[0], reps, 20)) for _ in range(2)]
    row = dict(inputs=label, kernel=kernel, calls=calls, dtype=str(dt).split(".")[-1],
               **dict(zip(("ms", "device_ms", "device_cold_ms"),
                          (statistics.fmean(x) for x in zip(*times)))),
               plain_ms=kv.time_ms(plain, reps, 2),
               bound_ms=statistics.fmean(b for b, _ in bounds),
               bound_by=max(("bytes", "operations"), key=[by for _, by in bounds].count),
               library_ms=None, library_device_ms=None, library_device_cold_ms=None, **shape)
    if library is not None:
        row.update(library_ms=kv.time_ms(library[0], reps, inner),
                   library_device_ms=kv.device_ms(library, reps, w_inner),
                   library_device_cold_ms=kv.device_flushed_ms(library[0], reps, 20))
    return row


def time_backend_rows(label: str, pnp_calls: List[PnPCall], pg_calls: List[PGCall],
                      reps: int = 10, inner: int = 10, out=print) -> Dict[str, dict]:
    """K13 on (at most 20 of, the largest batches) the recorded PnP calls, a
    call and the plain version at the largest, and K14-K15 on (at most 50 of)
    the recorded pose-graph iterations, timed as the module docstring says;
    returns a row by kernel."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing the backend's kernels needs a CUDA device")
    from ..backend import pose_graph as pg

    rows = {}
    if pnp_calls:
        # the largest batches first: a call and the plain version's at the largest
        warm = sorted(pnp_calls, key=lambda c: -c.B)[:20]
        c0 = warm[0]
        dt = c0.dtype
        rate = F64_FLOPS_PER_S if dt == torch.float64 else kv.F32_FLOPS_PER_S
        fns = [lambda c=c: pnp_kernel_row(c) for c in warm]
        rows["pnp_solve"] = _row(
            label, "pnp_solve", len(pnp_calls), fns, lambda: pnp_plain_row(warm[0]),
            [backend_bound("pnp_solve", c.points.element_size(), rate, c.B, c.N, c.iterations)
             for c in warm], dt, reps, inner, B=c0.B, N=c0.N,
            mean_B=statistics.fmean(c.B for c in warm))
    if pg_calls:
        warm = pg_calls[:50]
        c0 = warm[0]
        dt = c0.dtype
        rate = F64_FLOPS_PER_S if dt == torch.float64 else kv.F32_FLOPS_PER_S
        mma = F64_MMA_FLOPS_PER_S if dt == torch.float64 else kv.F32_FLOPS_PER_S
        bounds = {k: [backend_bound(k, c.t.element_size(), rate, nodes=c.N, E=c.E,
                                    mma_rate=mma) for c in warm]
                  for k in ("pg_build", "pg_step")}
        builds = [_pg_binding(c, False) for c in warm]
        steps = [_pg_binding(c, True) for c in warm]
        torch.cuda.synchronize()
        rows["pg_build"] = _row(
            label, "pg_build", len(pg_calls), [b.build for b in builds],
            lambda: pg.pg_build_plain(c0.poses(), c0.edges, c0.scalars), bounds["pg_build"],
            dt, reps, inner, N=c0.N, E=c0.E)
        Hp, gp, sp = pg.pg_build_plain(c0.poses(), c0.edges, c0.scalars)
        rows["pg_step"] = _row(
            label, "pg_step", len(pg_calls), [b.step for b in steps],
            lambda: pg.pg_step_plain(c0.poses(), c0.edges, Hp, gp, sp, c0.opts),
            bounds["pg_step"], dt, reps, inner,
            library=[_cholesky_yardstick(c) for c in warm], N=c0.N, E=c0.E)
    for kernel, row in rows.items():
        lib = ("" if row["library_ms"] is None else
               f"; cholesky_ex + cholesky_solve on the same Hd {1e3 * row['library_ms']:.2f} "
               f"us a call / {1e3 * row['library_device_ms']:.2f} warm / "
               f"{1e3 * row['library_device_cold_ms']:.2f} cold")
        out(f"{label} {kernel} ({row['calls']} calls, {row['dtype']}): kernel "
            f"{1e3 * row['ms']:.2f} us a call / {1e3 * row['device_ms']:.2f} warm / "
            f"{1e3 * row['device_cold_ms']:.2f} cold; plain {1e3 * row['plain_ms']:.2f} us a "
            f"call; bound {1e3 * row['bound_ms']:.4f} us ({row['bound_by']}){lib}")
    return rows


# ------------------------------------------------------------------ problems


def pnp_arrays(B: int = 1, N: int = 256, seed: int = 0, live=None, nan_problem=None,
               behind: bool = False, outliers: int = 3) -> dict:
    """B PnP problems of N slots made with numpy from ``seed``: points 2-5 m
    in front of a camera at a small random pose, their noisy projections
    (fx = 480), ``outliers`` rows moved by 30 px (Huber), the slots past
    each problem's live count (``live``: a list, default all) masked out
    and moved by 500 px; ``nan_problem``: that problem's point 5 NaN (in a
    live row); ``behind``: problem 0's point 7 behind the camera (the depth
    clamp). The arrays of :func:`pnp_tensors`."""
    rng = np.random.default_rng(seed)
    K = np.array([480.0, 480.0, 319.5, 239.5])
    X = np.stack([rng.uniform(-1, 1, (B, N)), rng.uniform(-1, 1, (B, N)),
                  rng.uniform(2, 5, (B, N))], -1)
    w = rng.normal(0, 0.05, (B, 3))
    th = np.linalg.norm(w, axis=1, keepdims=True)
    q = np.concatenate([np.sin(th / 2) * w / th, np.cos(th / 2)], 1)
    t = rng.normal(0, 0.1, (B, 3))
    Pc = _qrot(_qconj(q)[:, None], X - t[:, None])
    obs = np.stack([Pc[..., 0] / Pc[..., 2] * K[0] + K[2],
                    Pc[..., 1] / Pc[..., 2] * K[1] + K[3]], -1) + rng.normal(0, 0.5, (B, N, 2))
    obs[:, :outliers] += 30.0
    live = [N] * B if live is None else live
    mask = (np.arange(N)[None] < np.asarray(live)[:, None]).astype(np.float64)
    obs[mask == 0] += 500.0
    if nan_problem is not None:
        X[nan_problem, 5, 0] = np.nan
    if behind:
        X[0, 7] = t[0] + _qrot(q[0], np.array([0.1, 0.0, -1.0]))
    dw = rng.normal(0, 0.02, (B, 3))
    dth = np.linalg.norm(dw, axis=1, keepdims=True)
    dq = np.concatenate([np.sin(dth / 2) * dw / dth, np.cos(dth / 2)], 1)
    return dict(points=X, obs_xy=obs, mask=mask, K=K, init_t=t + rng.normal(0, 0.05, (B, 3)),
                init_q=_qmul(q, dq))


def pnp_tensors(a: dict, dtype=torch.float64, device="cpu"):
    """(points, obs_xy, mask, K, Pose(init_t, init_q)) of :func:`pnp_arrays`."""
    from ..core.transform import Pose

    f = lambda x: torch.tensor(x, dtype=dtype, device=device)  # noqa: E731
    return (f(a["points"]), f(a["obs_xy"]), f(a["mask"]), f(a["K"]),
            Pose(f(a["init_t"]), f(a["init_q"])))


def pose_graph_arrays(n: int = 64, seed: int = 1, loop: bool = True):
    """A drifted chain of n keyframes with noisy consecutive edges and (with
    ``loop``) two loop edges of weight 5: ((t, q), (i, j, t_ij, q_ij, w))."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    i, j, w = np.arange(n - 1), np.arange(1, n), np.ones(n - 1)
    if loop:
        i = np.concatenate([i, [0, min(5, n - 2)]])
        j = np.concatenate([j, [n - 1, n - 2]])
        w = np.concatenate([w, [5.0, 5.0]])
    t_ij = t[j] - t[i] + rng.normal(0, 0.01, (len(i), 3))
    return (t, q), (i, j, t_ij, np.tile(q[:1], (len(i), 1)), w)


def main() -> int:
    """On the card: 8a's PnP (B = 1 and a batch of 55) and pose graph
    through the kernels, recorded; each call held against the plain
    versions, the decision flips counted, and K13-K15 timed. Prints the
    card and each result."""
    from .. import interop
    from ..backend import geometry, pose_graph
    from ..core.transform import Pose
    from ..ops import cuda_backend

    if not torch.cuda.is_available():
        raise RuntimeError("backend_kernels needs a CUDA device")
    print(kv.card_line())
    cuda_backend.zero_launch_counts()
    with record_pnp_calls() as pnp_calls, record_pg_calls() as pg_calls:
        for B in (1, 55):
            geometry.solve_pnp(*pnp_tensors(pnp_arrays(B, seed=B), device="cuda"))
        (t, q), e = pose_graph_arrays()
        f = lambda x: torch.tensor(x, dtype=torch.float64, device="cuda")  # noqa: E731
        pose_graph.optimize_pose_graph_counted(
            Pose(f(t), f(q)), interop.pose_graph_edges_from_arrays(*e, device="cuda"))
    torch.cuda.synchronize()
    print(f"launches {cuda_backend.launch_counts()}; {len(pnp_calls)} PnP calls, "
          f"{len(pg_calls)} pose-graph iterations")
    print("K13 held:", hold_pnp_calls(pnp_calls))
    print("K13 decision flips:", [pnp_decision_flips(c) for c in pnp_calls])
    print("K14-K15 held:", {k: v for k, v in hold_pg_calls(pg_calls).items()})
    time_backend_rows("8a", pnp_calls, pg_calls)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
