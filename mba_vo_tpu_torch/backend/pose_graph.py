"""Pose-graph optimisation over SE(3) relative-pose constraints.

Counterpart of ``mba_vo_tpu/backend/pose_graph.py``: nodes are keyframe
poses, edges carry measured relative transforms with scalar information
weights, and the residual of an edge is

    r_e = log( T_meas^-1 * (T_i^-1 * T_j) )  in R^6.

Gauss-Newton with the Jacobian over the stacked [N, 6] tangent written
out (``ba.relative_pose_jacobians``, the odometry prior's), one dense
[6N x 6N] solve, node 0 gauge-fixed, and an LM loop on the
host that reads one flag an iteration. A singular damped system gives a NaN
step, which is rejected.

An iteration is two stages: the build (H, g and the cost at the current
poses, which becomes the loop's initial cost at its first iteration) and
the step (the damped solve, the candidate, its cost, the decision and the
select, lambda, the iteration count and the done flag), with the loop's
scalars in one vector laid out by ``ops/cuda_backend.py``'s ``G_*``
constants. On CUDA tensors they are kernels K14 and K15
(``csrc/pose_graph.cu``, bound by ``cuda_backend.PGBinding``), or the call
raises; on CPU tensors the plain stages :func:`pg_build_plain` and
:func:`pg_step_plain` (the same ops in the same order as the reference's
loop body, the solve by ``torch.linalg.solve_ex``).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..core.transform import Pose
from ..ops import cuda_backend
from ..ops.cuda_backend import G_BUILD_COST, G_COST, G_DONE, G_IT, G_LAM, new_scalars
from .ba import relative_pose_jacobians, relative_pose_residuals, retract


@dataclasses.dataclass(frozen=True)
class PoseGraphOptions:
    max_iterations: int = 30
    initial_lambda: float = 1e-6
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-12
    max_lambda: float = 1e8
    min_rel_decrease: float = 1e-10


class PoseGraphEdge(NamedTuple):
    """Batched edges: i[E], j[E] node indices; measured T_ij (frame i -> j);
    weight [E] scalar information."""

    i: torch.Tensor
    j: torch.Tensor
    t_ij: torch.Tensor    # [E, 3]
    q_ij: torch.Tensor    # [E, 4]
    weight: torch.Tensor  # [E]


def edge_residuals(poses: Pose, edges: PoseGraphEdge) -> torch.Tensor:
    """[E, 6] residuals log(T_meas^-1 (T_i^-1 T_j))."""
    return relative_pose_residuals(poses.t[edges.i], poses.q[edges.i], poses.t[edges.j],
                                   poses.q[edges.j], edges.t_ij, edges.q_ij)


def _cost(poses: Pose, edges: PoseGraphEdge) -> torch.Tensor:
    r = edge_residuals(poses, edges)
    return 0.5 * torch.sum(edges.weight[:, None] * r * r) / torch.clamp(
        edges.weight.sum(), min=1e-12)


def _gauge(N: int, like: torch.Tensor) -> torch.Tensor:
    gauge = like.new_ones((N,))
    gauge[0] = 0.0
    return gauge


def pg_build_plain(poses: Pose, edges: PoseGraphEdge, scalars: torch.Tensor):
    """K14's plain version: (H [6N, 6N], g [6N], scalars') at the poses, the
    reference's build in its order: each edge's Jacobians written into the
    dense [E, 6, N, 6] Jacobian, node 0's columns times 0, the rows weighted
    by sqrt(w), H = Jw^T Jw and g = Jw^T rw (K14 adds the same terms block
    by block). scalars' is ``scalars`` with the cost at the poses as the
    build's cost and, where they count no iteration yet, as the cost."""
    N = poses.t.shape[0]
    dev = dict(dtype=poses.t.dtype, device=poses.t.device)
    gauge = _gauge(N, poses.t)
    sqrt_w = torch.sqrt(edges.weight)[:, None].repeat(1, 6).reshape(-1)
    r, J_i, J_j = relative_pose_jacobians(poses.t[edges.i], poses.q[edges.i],
                                          poses.t[edges.j], poses.q[edges.j], edges.t_ij,
                                          edges.q_ij)
    E = r.shape[0]
    e = torch.arange(E, device=r.device)
    J = torch.zeros((E, 6, N, 6), **dev)
    J[e, :, edges.i] = J_i
    J[e, :, edges.j] = J_j
    J = J * gauge[None, None, :, None]              # node 0 does not move
    Jw = J.reshape(E * 6, N * 6) * sqrt_w[:, None]
    rw = r.reshape(-1) * sqrt_w
    cost = _cost(poses, edges)
    out = scalars.clone()
    out[G_BUILD_COST] = cost
    out[G_COST] = torch.where(scalars[G_IT] == 0, cost, scalars[G_COST])
    return Jw.T @ Jw, Jw.T @ rw, out


def pg_step_plain(poses: Pose, edges: PoseGraphEdge, H: torch.Tensor, g: torch.Tensor,
                  scalars: torch.Tensor, opts: PoseGraphOptions):
    """K15's plain version, the reference's loop body after its build: the
    damped, gauge-fixed solve (NaN where ``solve_ex`` reports a singular
    system), the candidate, its cost, ok, rel, the select, lambda within its
    clamps, the iteration count and done. Returns (poses', scalars'); a
    state already done comes back unchanged."""
    N = poses.t.shape[0]
    gauge = _gauge(N, poses.t)
    cost, lam = scalars[G_COST], scalars[G_LAM]
    eyeN = torch.eye(N * 6, dtype=H.dtype, device=H.device)
    gauge_diag = torch.repeat_interleave(1.0 - gauge, 6)
    Hd = H + (lam * torch.diagonal(H) + 1e-12) * eyeN + torch.diag(gauge_diag)
    sol, info = torch.linalg.solve_ex(Hd, g)
    sol = torch.where(info == 0, sol, torch.full_like(sol, float("nan")))
    delta = -sol.reshape(N, 6) * gauge[:, None]
    cand = retract(poses, delta)
    cand_cost = _cost(cand, edges)
    ok = (cand_cost < cost) & torch.all(torch.isfinite(delta))
    rel = (cost - cand_cost) / torch.clamp(cost, min=1e-24)
    lam = torch.where(
        ok,
        torch.clamp(lam * opts.lambda_down, min=opts.min_lambda),
        torch.clamp(lam * opts.lambda_up, max=opts.max_lambda),
    )
    done = ok & (rel < opts.min_rel_decrease)
    out = torch.stack([torch.where(ok, cand_cost, cost), lam, scalars[G_IT] + 1,
                       done.to(cost.dtype), cand_cost, ok.to(cost.dtype), rel,
                       scalars[G_BUILD_COST]])
    was_done = scalars[G_DONE] != 0
    keep = ~ok | was_done
    return (Pose(t=torch.where(keep, poses.t, cand.t), q=torch.where(keep, poses.q, cand.q)),
            torch.where(was_done, scalars, out))


def run_plain_stages(poses: Pose, edges: PoseGraphEdge,
                     opts: PoseGraphOptions = PoseGraphOptions()) -> Tuple[Pose, torch.Tensor, int]:
    """The LM loop on :func:`pg_build_plain` and :func:`pg_step_plain`, one
    host read an iteration (on any device); as
    :func:`optimize_pose_graph_counted`."""
    scalars = new_scalars(poses.t, opts)
    it = 0
    while it < opts.max_iterations:
        H, g, scalars = pg_build_plain(poses, edges, scalars)
        poses, scalars = pg_step_plain(poses, edges, H, g, scalars, opts)
        it += 1
        if bool(scalars[G_DONE]):
            break
    return poses, (scalars[G_COST] if it else _cost(poses, edges)), it


def optimize_pose_graph_counted(
    poses: Pose, edges: PoseGraphEdge, opts: PoseGraphOptions = PoseGraphOptions()
) -> Tuple[Pose, torch.Tensor, int]:
    """:func:`optimize_pose_graph` that also returns its LM iteration count.
    On CUDA tensors an iteration is K14, K15 and one read of the done flag;
    on CPU tensors the plain stages."""
    if not poses.t.is_cuda:
        return run_plain_stages(poses, edges, opts)
    b = cuda_backend.PGBinding(poses, edges, opts)
    it = 0
    while it < opts.max_iterations:
        b.build()
        b.step()
        it += 1
        if bool(b.scalars[G_DONE]):
            break
    cost = b.scalars[G_COST].clone() if it else _cost(poses, edges)
    return Pose(t=b.t, q=b.q), cost, it


def optimize_pose_graph(
    poses: Pose, edges: PoseGraphEdge, opts: PoseGraphOptions = PoseGraphOptions()
) -> Tuple[Pose, torch.Tensor]:
    """LM pose-graph relaxation; returns (poses, final_cost). Node 0 fixed."""
    poses, cost, _ = optimize_pose_graph_counted(poses, edges, opts)
    return poses, cost
