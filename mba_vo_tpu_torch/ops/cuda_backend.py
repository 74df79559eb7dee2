"""Bind and launch the backend's loop-closure kernels: PnP (K13) and the
pose graph's LM iteration (K14-K15).

``csrc/pnp.cu`` replaces ``mba_vo_tpu/backend/geometry.py``'s
``solve_pnp`` (its ``lax.while_loop``, jitted as ``solve_pnp_jit``) and
``pnp_residual_norms``; ``csrc/pose_graph.cu`` the body of
``mba_vo_tpu/backend/pose_graph.py::optimize_pose_graph``'s
``lax.while_loop``. XLA compiles each into one device program (no Pallas
source):

  * K13 ``pnp_solve``: every LM iteration of a batch of PnP problems and
    the residual norms at the final pose, one CTA a problem, one launch a
    call (:func:`pnp_solve_cuda`); its row ``[norms (N) | cost | t (3) | q
    (4)]`` is what the backend's loop stage reads, one copy a round;
  * K14 ``pg_build``: the pose graph's normal equations H [6N, 6N] and g
    [6N] from the edges' closed-form Jacobians, block by block, and the
    cost at the current poses (the loop's initial cost at its first
    iteration);
  * K15 ``pg_step``: the damped, gauge-fixed Cholesky step, the candidate,
    its cost, the decision and the select in place.

A pose-graph iteration is K14, K15 and one host read of the done flag
(``backend/pose_graph.py::optimize_pose_graph_counted`` on CUDA tensors).
The plain versions are ``backend/geometry.py``'s ``solve_pnp_plain`` and
``pnp_residual_norms``, and ``backend/pose_graph.py``'s ``pg_build_plain``
and ``pg_step_plain``, which CPU tensors take. The kernels take CUDA
tensors only and raise on anything else; nothing falls back to the plain
versions.

:class:`PGBinding` binds one ``optimize_pose_graph_counted`` call: the
graph's tensors are checked once for device, dtype, shape and contiguity,
and it owns the state (poses and the scalars below, updated in place by
K15), H, g and K15's scratch. :func:`pg_build_cuda` and
:func:`pg_step_cuda` are each kernel alone on given inputs, for the
comparisons with the plain versions.

``LAUNCHES_PNP``, ``LAUNCHES_PG_BUILD`` and ``LAUNCHES_PG_STEP`` count the
launches, one a call (a call recorded into a CUDA graph is not a launch).
The libraries are built and loaded by ``ops/cuda_build.py`` at first use;
nothing here runs when the module is imported.

The pose graph's scalars are one vector of the working dtype indexed by
the ``G_*`` constants (``pose_graph.cu`` has the same enum): the current
cost, lambda, the iterations made, the done flag, K15's candidate cost, ok
flag and relative decrease, and K14's cost at the poses it was given.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import cuda_build
from .cuda_residual import _check, _launch

LAUNCHES_PNP = 0
LAUNCHES_PG_BUILD = 0
LAUNCHES_PG_STEP = 0

G_COST, G_LAM, G_IT, G_DONE, G_CAND_COST, G_OK, G_REL, G_BUILD_COST = range(8)
G_SIZE = 8

# K13's CTA (pnp.cu's kThreads), one a problem
PNP_THREADS = 256
# the shared memory a CTA may opt into (K15's z, x, column and candidate
# poses must fit)
SMEM_LIMIT = 232448

_loaded: Dict[str, ctypes.CDLL] = {}
_P, _I, _D, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
_SIGNATURES = {
    "pnp": {
        # points, obs, mask, K, init t, init q, out, B, N, huber_a, iterations, stream
        "pnp_solve": [_P] * 7 + [_I, _I, _D, _I, _P],
    },
    "pose_graph": {
        # t, q, scalars, i, j, t_ij, q_ij, weight, H, g, N, E, stream
        "pg_build": [_P] * 10 + [_I, _I, _P],
        # t, q, scalars, i, j, t_ij, q_ij, weight, H, g, scratch, N, E, lambda_up,
        # lambda_down, min_lambda, max_lambda, min_rel_decrease, smem, stream
        "pg_step": [_P] * 11 + [_I, _I] + [_D] * 5 + [_L, _P],
    },
}


def library(name: str) -> ctypes.CDLL:
    """``pnp.cu``'s or ``pose_graph.cu``'s library, its entries typed and its
    constants checked against this module's."""
    if name not in _loaded:
        lib = cuda_build.load(name)
        for fn_name, signature in _SIGNATURES[name].items():
            for suffix in ("f32", "f64"):
                fn = getattr(lib, f"{fn_name}_{suffix}")
                fn.argtypes, fn.restype = signature, ctypes.c_int
        if name == "pnp":
            lib.pnp_threads.argtypes, lib.pnp_threads.restype = [], ctypes.c_int
            if lib.pnp_threads() != PNP_THREADS:
                raise RuntimeError(f"pnp.cu launches {lib.pnp_threads()} threads a problem, "
                                   f"not {PNP_THREADS}")
        else:
            lib.pg_scalars_size.argtypes, lib.pg_scalars_size.restype = [], ctypes.c_int
            lib.pg_step_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.pg_step_smem_bytes.restype = ctypes.c_longlong
            if lib.pg_scalars_size() != G_SIZE:
                raise RuntimeError(f"pose_graph.cu lays out {lib.pg_scalars_size()} scalars, "
                                   f"not {G_SIZE}")
        _loaded[name] = lib
    return _loaded[name]


def _entry(lib: str, name: str, dtype: torch.dtype):
    suffix = {torch.float32: "f32", torch.float64: "f64"}[dtype]
    return getattr(library(lib), f"{name}_{suffix}")


def launch_counts() -> Dict[str, int]:
    """The launches of K13-K15 by kernel name."""
    return {"pnp_solve": LAUNCHES_PNP, "pg_build": LAUNCHES_PG_BUILD,
            "pg_step": LAUNCHES_PG_STEP}


def zero_launch_counts() -> None:
    global LAUNCHES_PNP, LAUNCHES_PG_BUILD, LAUNCHES_PG_STEP
    LAUNCHES_PNP = LAUNCHES_PG_BUILD = LAUNCHES_PG_STEP = 0


def pnp_solve_cuda(points: torch.Tensor, obs_xy: torch.Tensor, mask: torch.Tensor,
                   K: torch.Tensor, init_t: torch.Tensor, init_q: torch.Tensor,
                   huber_a: float = 2.0, max_iterations: int = 30) -> torch.Tensor:
    """K13: ``backend.geometry.solve_pnp_plain`` and ``pnp_residual_norms`` at
    its pose for each problem of the batch, in one launch.

    points [B, N, 3], obs_xy [B, N, 2], mask [B, N], K [4], init_t [B, 3],
    init_q [B, 4]: CUDA tensors of one float dtype, contiguous, on one
    device. Returns the rows [B, N + 8] = [norms (N) | cost | t (3) | q
    (4)]; with B = 0 nothing launches."""
    global LAUNCHES_PNP
    who = "pnp_solve_cuda"
    B = points.shape[0] if points.dim() == 3 else None
    N = points.shape[1] if points.dim() == 3 else None
    dtype = _check(who, dict(points=points, obs_xy=obs_xy, mask=mask, K=K, init_t=init_t,
                             init_q=init_q),
                   dict(points=(B, N, 3), obs_xy=(B, N, 2), mask=(B, N), K=(4,),
                        init_t=(B, 3), init_q=(B, 4)))
    if N < 1 or max_iterations < 0:
        raise ValueError(f"{who}: {N} correspondences, {max_iterations} iterations")
    out = points.new_empty((B, N + 8))
    if B == 0:
        return out
    LAUNCHES_PNP += _launch(_entry("pnp", "pnp_solve", dtype), points.device,
                            points.data_ptr(), obs_xy.data_ptr(), mask.data_ptr(), K.data_ptr(),
                            init_t.data_ptr(), init_q.data_ptr(), out.data_ptr(), B, N,
                            float(huber_a), int(max_iterations))
    return out


def new_scalars(like: torch.Tensor, opts) -> torch.Tensor:
    """The pose-graph loop's scalars at its start, of ``like``'s dtype and
    device: lambda at ``opts.initial_lambda``, every other entry 0."""
    scalars = like.new_zeros(G_SIZE)
    scalars[G_LAM] = opts.initial_lambda
    return scalars


def step_smem_bytes(N: int, itemsize: int) -> int:
    """K15's dynamic shared memory (``pose_graph.cu``'s ``step_smem_elems``):
    the forward sweep z and the step x [6N] each, a column of the factor
    [6N + 1] and the candidate poses [N, 7]."""
    return (18 * N + 1 + 7 * N) * itemsize


class PGBinding:
    """K14-K15 bound to one pose graph.

    ``poses``: a ``core.transform.Pose`` (t [N, 3], q [N, 4]) and ``edges`` a
    ``backend.pose_graph.PoseGraphEdge`` (i, j [E] int64, t_ij [E, 3], q_ij
    [E, 4], weight [E]) of CUDA tensors of one float dtype, contiguous, on
    one device; checked here, raising on the first tensor that fails (an
    edge index outside [0, N) is not checked on the host: the kernels give
    that edge a NaN residual, so every step is rejected). ``opts``: the
    ``backend.pose_graph.PoseGraphOptions``.

    The state is :attr:`t`, :attr:`q` and :attr:`scalars`: with ``own``
    (the LM's call) copies of the poses and new scalars (lambda at
    ``opts.initial_lambda``, every other entry 0), else the given tensors
    and ``scalars`` as given (updated in place). :meth:`build` is K14 into
    :attr:`H` and :attr:`g`, :meth:`step` K15 from them (replaced by
    :meth:`use_built`)."""

    def __init__(self, poses, edges, opts, scalars=None, own: bool = True):
        N = poses.t.shape[0] if poses.t.dim() == 2 else None
        E = edges.i.shape[0] if edges.i.dim() == 1 else None
        tensors = dict(t=poses.t, q=poses.q, i=edges.i, j=edges.j, t_ij=edges.t_ij,
                       q_ij=edges.q_ij, weight=edges.weight)
        shapes = dict(t=(N, 3), q=(N, 4), i=(E,), j=(E,), t_ij=(E, 3), q_ij=(E, 4),
                      weight=(E,))
        if scalars is not None:
            tensors["scalars"], shapes["scalars"] = scalars, (G_SIZE,)
        dtype = _check("PGBinding", tensors, shapes, int_names=("i", "j"))
        if N < 1:
            raise ValueError("PGBinding: a pose graph of no nodes")
        itemsize = poses.t.element_size()
        self.smem = step_smem_bytes(N, itemsize)
        if self.smem > SMEM_LIMIT:
            raise ValueError(f"PGBinding: K15's {self.smem} B of shared memory at {N} nodes "
                             f"pass the {SMEM_LIMIT} B a CTA may use")
        self.opts, self.dtype, self.N, self.E = opts, dtype, N, E
        self.device = poses.t.device
        self.edges = edges
        if own:
            self.t, self.q = poses.t.clone(), poses.q.clone()
        else:
            self.t, self.q = poses.t, poses.q
        self.scalars = new_scalars(poses.t, opts) if scalars is None else scalars
        D = 6 * N
        self.H, self.g = poses.t.new_empty((D, D)), poses.t.new_empty(D)
        self._scratch = poses.t.new_empty((D + 1) * D)
        self._edges = tuple(x.data_ptr() for x in (edges.i, edges.j, edges.t_ij, edges.q_ij,
                                                   edges.weight))
        self._state = (self.t.data_ptr(), self.q.data_ptr(), self.scalars.data_ptr())
        self._build = _entry("pose_graph", "pg_build", dtype)
        self._step = _entry("pose_graph", "pg_step", dtype)
        o = opts
        self._options = (float(o.lambda_up), float(o.lambda_down), float(o.min_lambda),
                         float(o.max_lambda), float(o.min_rel_decrease))

    def use_built(self, H: torch.Tensor, g: torch.Tensor) -> None:
        """K15's inputs from H [6N, 6N] and g [6N] (``pg_build_plain``'s),
        checked."""
        D = 6 * self.N
        _check("PGBinding.use_built", dict(state_t=self.t, H=H, g=g),
               dict(state_t=(self.N, 3), H=(D, D), g=(D,)))
        self.H, self.g = H, g

    def build(self) -> None:
        """K14: :attr:`H`, :attr:`g` and the cost at the state; the cost into
        the scalars (and, where they count no iteration yet, as the cost)."""
        global LAUNCHES_PG_BUILD
        LAUNCHES_PG_BUILD += _launch(self._build, self.device, *self._state, *self._edges,
                                     self.H.data_ptr(), self.g.data_ptr(), self.N, self.E)

    def step(self) -> None:
        """K15: the step from :attr:`H` and :attr:`g`, the decision and the
        next state, in place."""
        global LAUNCHES_PG_STEP
        LAUNCHES_PG_STEP += _launch(self._step, self.device, *self._state, *self._edges,
                                    self.H.data_ptr(), self.g.data_ptr(),
                                    self._scratch.data_ptr(), self.N, self.E, *self._options,
                                    self.smem)


def pg_build_cuda(poses, edges, scalars: torch.Tensor, opts):
    """K14 alone: ``backend.pose_graph.pg_build_plain`` at ``poses``, in one
    launch. Returns (H, g); the cost goes into ``scalars`` in place."""
    b = PGBinding(poses, edges, opts, scalars, own=False)
    b.build()
    return b.H, b.g


def pg_step_cuda(poses, edges, scalars: torch.Tensor, H: torch.Tensor, g: torch.Tensor, opts):
    """K15 alone: ``backend.pose_graph.pg_step_plain`` on H and g, writing
    the next state into ``poses`` and ``scalars`` in place, in one launch."""
    b = PGBinding(poses, edges, opts, scalars, own=False)
    b.use_built(H, g)
    b.step()
