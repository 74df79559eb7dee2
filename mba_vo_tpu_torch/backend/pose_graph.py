"""Pose-graph optimisation over SE(3) relative-pose constraints.

Counterpart of ``mba_vo_tpu/backend/pose_graph.py``: nodes are keyframe
poses, edges carry measured relative transforms with scalar information
weights, and the residual of an edge is

    r_e = log( T_meas^-1 * (T_i^-1 * T_j) )  in R^6.

Gauss-Newton with the Jacobian over the stacked [N, 6] tangent written
out (``ba.relative_pose_jacobians``, the odometry prior's), one dense
[6N x 6N] solve, node 0 gauge-fixed, and an LM loop on the host that reads
one flag an iteration. A singular damped system gives a NaN step, which is
rejected.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from ..core.transform import Pose
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


def optimize_pose_graph_counted(
    poses: Pose, edges: PoseGraphEdge, opts: PoseGraphOptions = PoseGraphOptions()
) -> Tuple[Pose, torch.Tensor, int]:
    """:func:`optimize_pose_graph` that also returns its LM iteration count."""
    N = poses.t.shape[0]
    dtype = poses.t.dtype
    dev = dict(dtype=dtype, device=poses.t.device)
    gauge = torch.ones((N,), **dev)
    gauge[0] = 0.0
    sqrt_w = torch.sqrt(edges.weight)[:, None].repeat(1, 6).reshape(-1)

    def build(p: Pose):
        r, J_i, J_j = relative_pose_jacobians(p.t[edges.i], p.q[edges.i], p.t[edges.j],
                                              p.q[edges.j], edges.t_ij, edges.q_ij)
        E = r.shape[0]
        e = torch.arange(E, device=r.device)
        J = torch.zeros((E, 6, N, 6), **dev)
        J[e, :, edges.i] = J_i
        J[e, :, edges.j] = J_j
        J = J * gauge[None, None, :, None]              # node 0 does not move
        Jw = J.reshape(E * 6, N * 6) * sqrt_w[:, None]
        rw = r.reshape(-1) * sqrt_w
        return Jw.T @ Jw, Jw.T @ rw

    cost = _cost(poses, edges)
    lam = torch.tensor(opts.initial_lambda, **dev)
    eyeN = torch.eye(N * 6, **dev)
    gauge_diag = torch.repeat_interleave(1.0 - gauge, 6)
    it = 0
    while it < opts.max_iterations:
        H, g = build(poses)
        Hd = H + (lam * torch.diagonal(H) + 1e-12) * eyeN + torch.diag(gauge_diag)
        sol, info = torch.linalg.solve_ex(Hd, g)
        sol = torch.where(info == 0, sol, torch.full_like(sol, float("nan")))
        delta = -sol.reshape(N, 6) * gauge[:, None]
        cand = retract(poses, delta)
        cand_cost = _cost(cand, edges)
        ok = (cand_cost < cost) & torch.all(torch.isfinite(delta))
        rel = (cost - cand_cost) / torch.clamp(cost, min=1e-24)
        poses = Pose(t=torch.where(ok, cand.t, poses.t),
                     q=torch.where(ok, cand.q, poses.q))
        lam = torch.where(
            ok,
            torch.clamp(lam * opts.lambda_down, min=opts.min_lambda),
            torch.clamp(lam * opts.lambda_up, max=opts.max_lambda),
        )
        done = ok & (rel < opts.min_rel_decrease)
        cost = torch.where(ok, cand_cost, cost)
        it += 1
        if done.item():
            break
    return poses, cost, it


def optimize_pose_graph(
    poses: Pose, edges: PoseGraphEdge, opts: PoseGraphOptions = PoseGraphOptions()
) -> Tuple[Pose, torch.Tensor]:
    """LM pose-graph relaxation; returns (poses, final_cost). Node 0 fixed."""
    poses, cost, _ = optimize_pose_graph_counted(poses, edges, opts)
    return poses, cost
