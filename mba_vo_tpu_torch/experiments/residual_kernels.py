"""Kernels K2-K9 on the tracker's own inputs, on one NVIDIA GPU: record,
hold against the plain versions and the earlier designs, time.

K2 is ``csrc/residual_rows.cu`` (``warp_tangents``, ``blur_rows``), K3
``csrc/normal_equations.cu`` (``normal_equations``), K5
``csrc/frame_layout.cu`` (the patch layout, ``prepare_frame_layout``, on
every path) and K4 ``csrc/image_bilinear.cu`` (the direct path's
whole-image sampler, ``image_bilinear_lk``); their plain versions are in
``ops/residual.py`` and ``ops/image.py``. K4 and K5 equal their plain
versions bit for bit (:data:`BIT_EQUAL_PLAIN`). Each kernel keeps an
earlier design beside the one the tracker launches (:data:`EARLIER`):
``warp_tangents`` the old path, the torch chain of the pose Jacobian
(``virtual_poses_and_tangents``) feeding the thread design
(``warp_tangents_threads_cuda``, the sweep row), held to the kernel within
:data:`TOLERANCE`; ``blur_rows`` and ``normal_equations`` one thread a row
and two launches, K5 the serial design and K4 the branch design (their first),
equal to the kernel bit for bit (:data:`BIT_EQUAL`); K4 also the rows of
:func:`variant_fns`. :func:`record_residual_calls`
records every call the tracker makes of the five dispatchers
(``ops.residual.warp_tangents``, ``blur_rows``, ``normal_equations``,
``prepare_frame_layout`` and ``image_bilinear_lk``) as
copies of its inputs on their device (for ``warp_tangents`` the knots,
from which :func:`chain_args` gives the sweep row's inputs); :func:`hold`
runs a recorded call through the kernel and the plain version and returns
the largest difference, relative to each output's magnitude;
:func:`hold_earlier` holds the kernel to its earlier design;
:func:`time_rows` times kernel, earlier design and plain on recorded calls
(and, for ``warp_tangents``, the thread design alone on the chain's
outputs):

  * ``ms``: a call as Python waits for it (median over ``reps`` of the mean
    of ``inner`` back-to-back calls between two CUDA events), on the first
    recorded call;
  * ``device_ms`` (warm): the device's time a call in a replayed CUDA graph
    of the recorded calls in the tracker's order (at most 50 of them),
    whose inputs stay in the L2;
  * ``device_cold_ms``: a graph of (L2 flush, call) pairs less a graph of
    flushes, on the first recorded call (``kernel_variants.device_flushed_ms``);
  * ``bound_ms``: the larger of the bytes the function must move (each
    input read once, each output written once) over 3.35 TB/s and its
    operations over the card's float32 or float64 rate, the mean over the
    calls timed;
  * for K3, ``library_ms``: ``Jw.T @ Jw`` through cuBLAS on the call's
    weighted rows, the H part of the function as one library call, a
    yardstick the port never calls; for K4 ``torch.nn.functional.grid_sample``
    (``align_corners=True``, ``padding_mode="zeros"``) of the three planes
    stacked once outside, the same interpolation but at the border, and
    beside it K1 at N = 1 with the whole image as one window, each timed
    as the designs are (warm on the same calls, a call and cold on the
    first), its operands prepared once, outside. No single PyTorch call
    computes K2's or K5's functions (``library_ms`` None).

:func:`time_layouts` times K3's two cluster layouts (:data:`K3_LAYOUTS`),
between which its rule chooses by the rows, on the same calls, each held
to the earlier design bit for bit.

The LM iteration's kernels K6-K8 (``csrc/lm_step.cu``) are recorded,
held and timed the same way on the tracker's LM calls:
:func:`record_lm_calls` records the calls of ``solver.lm``'s three stage
dispatchers (copies of their inputs taken before the call, since the
kernels write the state in place), :func:`hold_lm` holds each call to the
plain stage (K8's state bit for bit, K7's mu and sigma within
:data:`LM_TOLERANCE`) and K6's step and model change, bit for bit, to
:func:`lm_step_kernel_order`, K6's order of operations written out in
torch (the plain stage solves with the library, whose order no kernel
repeats); K6's and K7's earlier designs (PR 12's block designs,
:data:`LM_EARLIER`) are held the same way, and K6's step and the
library's are each held to a float64 solve of the same system
(:func:`step_forward_errors`). :func:`time_lm_rows` times kernel, earlier
design and plain stage, with ``torch.linalg.cholesky_ex`` +
``torch.cholesky_solve`` beside K6 as its library yardstick and a floor
row (K6 at D = 6, K7 at N = 1) for each design.

The joint path's knot prior K9 (``csrc/knot_prior.cu``, ``solver.lm``'s
dispatcher ``knot_prior``) is recorded with them (:data:`LM_STAGES`),
held to its plain version (``knot_prior_plain``) bit for bit where the
transcendentals round alike and within :data:`PRIOR_TOLERANCE` where not
(:func:`hold_lm`), and timed beside its old path, the forward-mode
``torch.func.jacfwd`` of the prior residual that the LM ran before K9
(:func:`knot_prior_jacfwd`, kept here only for that row), with a floor row
at K = 3.

``chip_smoke.py`` phases 3 (record and hold) and 7 (time) drive it on the
bench scenario; ``python3 -m mba_vo_tpu_torch.experiments.residual_kernels``
runs both alone from the repository's root (it imports that scenario), and
with ``--layouts`` K3's layout sweep instead of the timing.
Requires CUDA for timing and raises without it; recording and holding run
on any device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import statistics
import sys
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from . import kernel_variants as kv

KERNELS = ("warp_tangents", "blur_rows", "normal_equations", "prepare_frame_layout",
           "image_bilinear_lk")
# the kernels held to their plain versions bit for bit on every call (K5's
# pixels pick the samples; K4 runs its plain version's operations)
BIT_EQUAL_PLAIN = ("prepare_frame_layout", "image_bilinear_lk")
F64_FLOPS_PER_S = 34e12      # float64 outside the tensor cores (H100 SXM data sheet)
# largest difference of kernel and plain, relative to the magnitude of each
# output (:func:`term_scales`), by kernel and dtype: in float64 1e-12 for
# K2's rows and 1e-10 for K3's sums; in float32 a few units of its epsilon
# (1.2e-7) for the rows and the rounding of sums over 4,096-32,768 rows in
# another order for K3
TOLERANCE = {
    ("warp_tangents", torch.float64): 1e-12, ("blur_rows", torch.float64): 1e-12,
    ("normal_equations", torch.float64): 1e-10,
    ("warp_tangents", torch.float32): 1e-6, ("blur_rows", torch.float32): 1e-6,
    ("normal_equations", torch.float32): 1e-5,
}
TOLERANCE.update({("warp_tangents_threads", dt): TOLERANCE["warp_tangents", dt]
                  for dt in (torch.float32, torch.float64)})


@dataclasses.dataclass
class ResidualCall:
    """One recorded call of a dispatcher: ``kernel`` (one of
    :data:`KERNELS`, or ``warp_tangents_threads``: the sweep row, from
    poses), copies of its positional arguments, and the pyramid level that
    made it (None outside ``_run_level``)."""
    kernel: str
    args: tuple
    level: Optional[int]

    @property
    def dtype(self) -> torch.dtype:
        if self.kernel in ("warp_tangents", "prepare_frame_layout"):
            return self.args[0].t.dtype
        return next(a.dtype for a in self.args if torch.is_tensor(a) and a.is_floating_point())

    @property
    def tangents(self) -> int:
        """D, the knot tangents of the call (0 for a cost-only call and for
        K4's and K5's calls)."""
        if self.kernel == "warp_tangents":
            return 6 * self.args[0].num_knots if self.args[5] else 0
        if self.kernel == "warp_tangents_threads":
            return self.args[2].shape[0]
        if self.kernel == "blur_rows":
            return self.args[3].shape[1]
        if self.kernel in ("prepare_frame_layout", "image_bilinear_lk"):
            return 0
        return 0 if self.args[1] is None else self.args[1].shape[-1]

    @property
    def full(self) -> bool:
        """Whether the call is one of an evaluation with the Jacobian: knot
        tangents, or K4's C = 3 (K5's calls are alike either way)."""
        if self.kernel == "prepare_frame_layout":
            return True
        if self.kernel == "image_bilinear_lk":
            return self.args[3] == 3
        return self.tangents > 0

    @property
    def frames(self) -> Optional[int]:
        """F, the frames of the call's LM problem (None for K4, whose
        positions do not say)."""
        if self.kernel == "image_bilinear_lk":
            return None
        if self.kernel == "prepare_frame_layout":
            return self.args[1].cur_imgs.shape[0]
        return self.args[{"warp_tangents": 8, "warp_tangents_threads": 5,
                          "blur_rows": 4}.get(self.kernel, 0)].shape[0]


def _copy(a):
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, tuple) and hasattr(a, "_fields"):     # the knots
        return type(a)(*(_copy(x) for x in a))
    return a


@contextlib.contextmanager
def record_residual_calls() -> Iterator[Dict[str, List[ResidualCall]]]:
    """Record every call of the five dispatchers in ``ops.residual``'s
    namespace made inside the block, by kernel, as the dict it yields; the
    calls still run. ``compute_residuals_windowed``,
    ``compute_residuals_direct`` and ``assemble`` look the names up when they
    are called, so nothing of the tracker changes; the names are restored on
    leaving the block, also on an exception. Record outside a CUDA graph
    capture. A layout call keeps copies of the whole level data."""
    from ..ops import residual

    calls: Dict[str, List[ResidualCall]] = {k: [] for k in KERNELS}
    originals = {k: getattr(residual, k) for k in KERNELS}

    def recorder(kernel):
        def recording(*args):
            calls[kernel].append(ResidualCall(kernel, tuple(_copy(a) for a in args),
                                              kv._caller_level()))
            return originals[kernel](*args)
        return recording

    for k in KERNELS:
        setattr(residual, k, recorder(k))
    try:
        yield calls
    finally:
        for k, fn in originals.items():
            setattr(residual, k, fn)


def kernel_fn(kernel: str):
    """The dispatcher (the kernel, on CUDA tensors); for
    ``warp_tangents_threads`` the sweep row's wrapper."""
    from ..ops import cuda_residual, residual

    if kernel == "warp_tangents_threads":
        return lambda *a: cuda_residual.warp_tangents_threads_cuda(
            *(x.contiguous() if torch.is_tensor(x) else x for x in a))
    return getattr(residual, kernel)


def plain_fn(kernel: str):
    from ..ops import image, residual

    return getattr(image if kernel == "image_bilinear_lk" else residual, f"{kernel}_plain")


def chain_args(call: ResidualCall) -> tuple:
    """The sweep row's arguments for a recorded ``warp_tangents`` call: the
    torch chain's virtual poses and pose tangents
    (``ops.residual.warp_poses``), then the call's own kp_z, K, pix, starts,
    H and W."""
    from ..ops import residual

    return residual.warp_poses(*call.args[:6]) + tuple(call.args[6:])


# the earlier design of a kernel, by the name of its wrapper in
# ops/cuda_residual.py (K5's in ops/cuda_layout.py, K4's in
# ops/cuda_image.py): for warp_tangents the old path (the torch chain of
# the pose Jacobian, then the thread design); those of BIT_EQUAL give the
# kernel's bits
EARLIER = {"warp_tangents": "warp_tangents_threads_cuda",
           "blur_rows": "blur_rows_threads_cuda",
           "normal_equations": "normal_equations_split_cuda",
           "prepare_frame_layout": "frame_layout_serial_cuda",
           "image_bilinear_lk": "image_bilinear_branch_cuda"}
BIT_EQUAL = ("blur_rows", "normal_equations", "prepare_frame_layout", "image_bilinear_lk")


def earlier_fn(kernel: str):
    """The earlier design of ``kernel`` (None where it has none), taking the
    dispatcher's arguments."""
    from ..ops import cuda_image, cuda_layout, cuda_residual, residual

    if kernel not in EARLIER:
        return None
    if kernel == "prepare_frame_layout":
        return lambda *args: cuda_layout.frame_layout_serial_cuda(
            *residual.frame_layout_args(*args))
    if kernel == "image_bilinear_lk":
        return lambda img, grad, loc, channels=3: cuda_image.image_bilinear_branch_cuda(
            img.contiguous(), grad.contiguous(), loc.contiguous(), channels)
    wrapper = getattr(cuda_residual, EARLIER[kernel])
    if kernel == "warp_tangents":
        return lambda *args: wrapper(*chain_args(ResidualCall(kernel, args, None)))
    if kernel == "blur_rows":
        return lambda val, gx, gy, dxy, obs, valid, num_vir, affine: wrapper(
            val, gx, gy, dxy.contiguous(), obs.contiguous(), valid.contiguous(), num_vir,
            affine)
    return lambda r, J, kp_w, huber_a, compensated=False: wrapper(
        r.contiguous(), None if J is None else J.contiguous(), kp_w.contiguous(), huber_a,
        compensated)


def variant_fns(kernel: str, calls: List[ResidualCall]) -> list:
    """The timed rows of a kernel beside its launched and earlier designs,
    as (name, function of the dispatcher's arguments): for K4 the
    interleaved design, whose [H, W, 4] planes are built here, once for
    each image of ``calls``, outside any timing."""
    from ..ops import cuda_image

    if kernel != "image_bilinear_lk":
        return []
    planes: dict = {}
    for c in calls:
        _per_image(planes, *c.args[:2], cuda_image.interleave_planes)
    return [("interleaved", lambda img, grad, loc, channels=3:
             cuda_image.image_bilinear_interleaved_cuda(
                 _per_image(planes, img, grad, None), loc.contiguous()))]


def _per_image(cache: dict, img: torch.Tensor, grad: torch.Tensor, build):
    """``build(img, grad)``, contiguous, once an image and its gradient
    (cached in ``cache`` by their storage), so that a timing finds it
    built."""
    key = (img.data_ptr(), grad.data_ptr())
    if key not in cache:
        cache[key] = build(img, grad).contiguous()
    return cache[key]


def _outputs(out) -> List[torch.Tensor]:
    return [o for o in (out if isinstance(out, tuple) else (out,)) if o is not None]


def term_scales(call: ResidualCall, ref) -> List[float]:
    """The magnitude each output of ``call`` is held to: the largest |entry|
    of the plain output, or, where an entry sums terms that cancel, the
    largest sum of the terms' magnitudes (the rounding of a sum is relative
    to its terms): blur_rows' r = pred - obs (the samples' and the
    observations' magnitude) and J = mean_v (gx dx + gy dy); K3's g =
    Jw^T rw. H's largest entry is on its diagonal, whose terms are
    squares."""
    from ..ops.residual import huber_weights

    scales = [float(o[~torch.isnan(o)].abs().max()) if o.numel() and
              (~torch.isnan(o)).any() else 0.0 for o in _outputs(ref)]
    a = call.args
    if call.kernel == "blur_rows":
        val, gx, gy, dxy, obs = a[:5]
        terms = (gx.abs() * dxy[0].abs() + gy.abs() * dxy[1].abs()).nan_to_num(0.0)
        scales[0] = max(scales[0], float(val.nan_to_num(0.0).abs().max()),
                        float(obs.abs().max()))
        if terms.numel():
            scales[1] = max(scales[1], float(terms.max()))
    elif call.kernel == "normal_equations" and a[1] is not None:
        r, J, kp_w, huber_a = a[:4]
        _, w = huber_weights(r, huber_a)
        ww = (w * kp_w[None, :, None]).abs()
        terms = torch.einsum("fnpk,fnp->k", J.abs() * ww[..., None], (r.abs() * ww))
        scales[2] = max(scales[2], float(terms.max()))
    return scales


def max_diff(out, ref, scales: List[float]):
    """(the largest |out - ref| over the entries where neither is NaN, the
    same over each output's scale), over every output; infinite where the
    NaN positions or the shapes differ."""
    worst = (0.0, 0.0)
    outs, refs = _outputs(out), _outputs(ref)
    if len(outs) != len(refs):
        return math.inf, math.inf
    for o, r, scale in zip(outs, refs, scales):
        if o.shape != r.shape or not torch.equal(torch.isnan(o), torch.isnan(r)):
            return math.inf, math.inf
        ok = ~torch.isnan(r)
        if not ok.any():
            continue
        diff = float((o[ok].to(r.dtype) - r[ok]).abs().max())
        worst = (max(worst[0], diff), max(worst[1], diff / scale if scale > 0 else diff))
    return worst


def same_bits(out, ref) -> bool:
    """Whether every output of ``out`` equals ``ref``'s bit for bit (a NaN
    where the other has a NaN, whatever its payload)."""
    outs, refs = _outputs(out), _outputs(ref)
    if len(outs) != len(refs):
        return False
    for o, r in zip(outs, refs):
        if o.shape != r.shape or o.dtype != r.dtype:
            return False
        if not o.is_floating_point():
            if not torch.equal(o, r):
                return False
            continue
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[o.element_size()]
        same = (o.view(ints) == r.view(ints)) | (torch.isnan(o) & torch.isnan(r))
        if not bool(same.all()):
            return False
    return True


def _within(call: ResidualCall, out, ref, what: str):
    """(absolute, relative) difference of ``out`` from ``ref``; raises past
    :data:`TOLERANCE` of each output's magnitude (:func:`term_scales`), and,
    for K2's first entry, where the in-image flags ``vs`` differ at all."""
    err = max_diff(out, ref, term_scales(call, ref))
    bound = TOLERANCE[call.kernel, call.dtype]
    label = f"{call.kernel} ({call.dtype}, D={call.tangents}, level {call.level})"
    if call.kernel.startswith("warp_tangents") and not torch.equal(out[1], ref[1]):
        raise AssertionError(f"{label}: kernel and {what} differ in vs")
    if not err[1] <= bound:
        raise AssertionError(f"{label}: kernel - {what} = {err[1]:.3e} of the output's "
                             f"magnitude > {bound}")
    return err


def hold_earlier(call: ResidualCall) -> bool:
    """The recorded call through the kernel and its earlier design; raises
    where they differ by a bit (:data:`BIT_EQUAL`) or, for
    ``warp_tangents``'s old path, as :func:`hold` does; returns True (False
    where the kernel has no earlier design)."""
    earlier = earlier_fn(call.kernel)
    if earlier is None:
        return False
    out = kernel_fn(call.kernel)(*call.args)
    ref = earlier(*call.args)
    if call.kernel not in BIT_EQUAL:
        _within(call, out, ref, "the old path")
    elif not same_bits(out, ref):
        raise AssertionError(f"{call.kernel} ({call.dtype}, D={call.tangents}, level "
                             f"{call.level}): the kernel and its earlier design differ")
    return True


def _unequal(out, ref) -> str:
    """Where two outputs that should be equal bit for bit differ: each
    output's count of differing entries and largest difference."""
    parts = []
    for i, (o, r) in enumerate(zip(_outputs(out), _outputs(ref))):
        if o.shape != r.shape:
            parts.append(f"output {i}: shapes {list(o.shape)} and {list(r.shape)}")
            continue
        o64, r64 = o.double(), r.double()
        bad = (o64 != r64) & ~(torch.isnan(o64) & torch.isnan(r64))
        if bad.any():
            parts.append(f"output {i}: {int(bad.sum())} of {bad.numel()} entries differ, "
                         f"by up to {float((o64 - r64)[bad].abs().max()):.3e}")
    return "; ".join(parts)


def hold(call: ResidualCall):
    """The recorded call through the kernel and the plain version; raises
    when they differ by more than :data:`TOLERANCE` of each output's
    magnitude (:func:`term_scales`) or, for K2's first entry, in any entry
    of ``vs``, or, for :data:`BIT_EQUAL_PLAIN`, by a bit; returns (absolute,
    relative) differences."""
    out = kernel_fn(call.kernel)(*call.args)
    ref = plain_fn(call.kernel)(*call.args)
    if call.kernel in BIT_EQUAL_PLAIN:
        if not same_bits(out, ref):
            raise AssertionError(f"{call.kernel} ({call.dtype}, level {call.level}): the "
                                 f"kernel and the plain version differ: {_unequal(out, ref)}")
        return 0.0, 0.0
    return _within(call, out, ref, "plain")


def hold_direct(knots, data, num_vir: int, degree: int, affine: bool = False):
    """The direct path as the card composes it (``compute_residuals_direct``:
    K5, K2's warp_tangents at zero window corners, K4, K2's blur_rows) against
    its plain chain (``compute_residuals_plain``) on the same tensors, with
    J; raises where the valid masks differ or r or J differ by more than
    :data:`TOLERANCE` (blur_rows') of their magnitude: for r the samples' and
    the observations' largest |entry|, for J the largest |gx| |dx| +
    |gy| |dy| of its terms (the plain versions at the plain positions), as
    :func:`term_scales` scales blur_rows'. Returns (r's, J's) relative
    differences."""
    from ..ops import image, residual

    r, J, valid = residual.compute_residuals_direct(knots, data, num_vir, degree, True, affine)
    rp, Jp, vp = residual.compute_residuals_plain(knots, data, num_vir, degree, True, affine)
    H, W = data.img_ref.shape
    pix, _, obs = residual.prepare_frame_layout_plain(knots, data, num_vir, degree)
    starts = torch.zeros((pix.shape[1], 2), dtype=torch.int64, device=pix.device)
    loc, _, dxy = residual.warp_tangents_plain(knots, data.cap_times, data.exp_times, num_vir,
                                               degree, True, data.kp_z, data.K, pix, starts,
                                               H, W)
    val, gx, gy = image.image_bilinear_lk_plain(data.img_ref, data.grad_ref, loc)
    terms = (gx.abs() * dxy[0].abs() + gy.abs() * dxy[1].abs()).nan_to_num(0.0)
    r_scale = max(float(val.abs().max()), float(obs.abs().max()))
    j_scale = float(terms.max()) if terms.numel() else 0.0
    errs = (float((r - rp).abs().max()) / max(r_scale, 1e-300),
            float((J - Jp).abs().max()) / max(j_scale, 1e-300))
    bound = TOLERANCE["blur_rows", knots.t.dtype]
    label = f"the direct path ({knots.t.dtype}, degree {degree}, affine {affine})"
    if not torch.equal(valid, vp):
        raise AssertionError(f"{label}: the kernels' and the plain chain's valid masks differ")
    if not max(errs) <= bound:
        raise AssertionError(f"{label}: kernels - plain chain = {errs[0]:.3e} (r), "
                             f"{errs[1]:.3e} (J) of the magnitude > {bound}")
    return errs


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if torch.is_tensor(t))


def _distinct(index: torch.Tensor) -> int:
    """The number of distinct entries of an integer tensor."""
    return int(torch.unique(index.reshape(-1)).numel())


def touched_pixels(call: ResidualCall) -> int:
    """The image pixels a K4 or K5 call must read: for K5 the distinct
    pixels of cur_imgs its patches gather (indices clamped as the gather
    clamps them), for K4 the distinct corners of its in-image samples (of
    each plane it reads)."""
    if call.kernel == "prepare_frame_layout":
        data = call.args[1]
        F, Hc, Wc = data.cur_imgs.shape
        pix = plain_fn(call.kernel)(*call.args)[0]
        x = pix[..., 0].clamp(-1, Wc).to(torch.int64).clamp(0, Wc - 1)
        y = pix[..., 1].clamp(-1, Hc).to(torch.int64).clamp(0, Hc - 1)
        f = torch.arange(F, device=pix.device)[:, None, None]
        return _distinct((f * Hc + y) * Wc + x)
    img, _, loc = call.args[:3]
    H, W = img.shape
    x, y = loc[..., 0].reshape(-1), loc[..., 1].reshape(-1)
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    x0, y0 = x[inb].floor().long(), y[inb].floor().long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    return _distinct(torch.cat([y0 * W + x0, y0 * W + x1, y1 * W + x0, y1 * W + x1]))


def bound_ms(call: ResidualCall):
    """(least milliseconds the card could take for the call, "bytes" or
    "operations"): every input read once and every output written once over
    3.35 TB/s, against the call's floating-point operations over the
    card's rate for its dtype. Of an image K4 or K5 reads, only the pixels
    this call's data touch count (:func:`touched_pixels`)."""
    a, k = call.args, call.kernel
    D = call.tangents
    if k == "prepare_frame_layout":
        knots, data, V, degree = a
        F, N, P = data.cur_imgs.shape[0], data.kp_z.shape[0], data.pattern.shape[0]
        isz = data.kp_z.element_size()
        moved = (_nbytes(*knots, data.cap_times, data.exp_times, data.kp_xy, data.kp_z,
                         data.kp_mask, data.K, data.pattern)
                 + touched_pixels(call) * isz + F * N * P * (3 * isz + 1))
        # a (keypoint, pixel)'s anchor and layout (~45), a frame's pose (its
        # segments' log and exp, ~600 each)
        flops = F * N * P * 45 + F * (degree - 1) * 600
    elif k == "image_bilinear_lk":
        img, _, loc, C = a
        samples = loc.shape[0] * loc.shape[1]
        moved = (_nbytes(loc) + samples * C * img.element_size()
                 + touched_pixels(call) * C * img.element_size())
        flops = samples * (10 + 7 * C)
    elif k == "warp_tangents":
        knots, caps, exps, V = a[:4]
        kp_z, K, pix, starts = a[6:10]
        F, N, P = pix.shape[:3]
        samples = N * F * P * V
        moved = _nbytes(*knots, caps, exps, kp_z, K, pix, starts) + \
            samples * (3 + 2 * D) * pix.element_size()
        # a sample's warp (~80) and its chain rule's 14 coefficients (~250),
        # two 7-term sums a tangent; a pose's rotation jobs (13, ~600 each)
        flops = samples * (330 + 26 * D) + F * V * 13 * 600
    elif k == "blur_rows":
        val, gx, gy, dxy, obs, valid = a[:6]
        V = a[6]
        rows = obs.numel()
        moved = _nbytes(val, gx, gy, dxy, obs, valid) + rows * (1 + D) * obs.element_size()
        flops = rows * (V + D * (4 * V + 1) + 2)
    else:
        r, J, kp_w = a[:3]
        E = (D + 1) * (D + 2) // 2 - 1 if D else 0
        F, N, _ = r.shape
        moved = _nbytes(r, J, kp_w) + (1 + F * N + D + D * D) * r.element_size()
        flops = r.numel() * (15 + D + 2 * E)
    rate = kv.F32_FLOPS_PER_S if call.dtype == torch.float32 else F64_FLOPS_PER_S
    t_bytes, t_ops = moved / kv.HBM_BYTES_PER_S, flops / rate
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _stacked(call: ResidualCall, planes: dict) -> torch.Tensor:
    """The call's three planes stacked [1, 3, H, W], once an image
    (:func:`_per_image`), outside any timing."""
    return _per_image(planes, *call.args[:2],
                      lambda img, grad: torch.stack([img, grad[..., 0], grad[..., 1]])[None])


def _grid_sample_yardstick(call: ResidualCall, planes: dict):
    """``grid_sample`` of the three planes (:func:`_stacked`) at the call's
    positions, normalised for ``align_corners=True``, as a function of no
    arguments."""
    import torch.nn.functional as tnf

    img, _, loc = call.args[:3]
    H, W = img.shape
    stacked = _stacked(call, planes)
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], dtype=loc.dtype, device=loc.device)
    grid = (loc * scale - 1.0)[None]                                        # [1, N, S, 2]
    return lambda: tnf.grid_sample(stacked, grid, mode="bilinear", padding_mode="zeros",
                                   align_corners=True)


def _k1_whole_image(call: ResidualCall, planes: dict):
    """K1 at N = 1, the whole image's three planes as one window
    (:func:`_stacked`), at the call's N S positions, as a function of no
    arguments (a yardstick; it counts K1 launches)."""
    from ..ops import cuda_sampling

    loc = call.args[2]
    stacked = _stacked(call, planes)
    xy = loc.reshape(1, -1, 2).contiguous()
    ones = torch.ones(xy.shape[:2], dtype=loc.dtype, device=loc.device)
    return lambda: cuda_sampling.window_bilinear_cuda(stacked, xy, ones)


def _cublas_yardstick(call: ResidualCall):
    """``Jw.T @ Jw`` on the call's weighted rows, as a function of no
    arguments (the weighting done once, outside)."""
    from ..ops.residual import huber_weights

    r, J, kp_w, huber_a = call.args[:4]
    _, w = huber_weights(r, huber_a)
    Jw = (J * (w * kp_w[None, :, None])[..., None]).reshape(-1, J.shape[-1]).contiguous()
    return lambda: Jw.T @ Jw


def full_calls(calls: List[ResidualCall]) -> List[ResidualCall]:
    """The calls of evaluations with the Jacobian (:attr:`ResidualCall.full`):
    the cost-only calls left out (each LM iteration makes one of each), all
    of them where there are none of the other kind."""
    return [c for c in calls if c.full] or calls


def time_rows(label: str, calls: List[ResidualCall], reps: int = 30, inner: int = 20,
              out=print) -> List[dict]:
    """The kernel, its earlier design (where it has one; for
    ``warp_tangents`` the old path whole, then the thread design alone on
    the chain's outputs), its other rows (:func:`variant_fns`, each held to
    the kernel bit for bit on the calls timed) and the plain version timed
    on the kernel's recorded ``calls`` (see the module docstring); returns
    one dict for each, the kernel's first, the earlier design's second, the
    plain version's last."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing the residual stage's kernels needs a CUDA device")
    kernel = calls[0].kernel
    warm_calls = calls[:50]
    bounds = [bound_ms(c) for c in warm_calls]
    b_ms = statistics.fmean(b for b, _ in bounds)
    b_by = max(("bytes", "operations"), key=[by for _, by in bounds].count)
    # the yardsticks on the same calls as the designs (warm: every call timed;
    # a call and cold: the first), their operands prepared outside
    lib = k1_n1 = None
    planes: dict = {}
    if kernel == "normal_equations" and calls[0].args[1] is not None:
        lib = [_cublas_yardstick(c) for c in warm_calls]
    elif kernel == "image_bilinear_lk":
        lib = [_grid_sample_yardstick(c, planes) for c in warm_calls]
        k1_n1 = [_k1_whole_image(c, planes) for c in warm_calls]
    w_inner = len(warm_calls) * math.ceil(50 / len(warm_calls))
    designs = [("kernel", kernel_fn(kernel), [c.args for c in warm_calls]),
               ("earlier", earlier_fn(kernel), [c.args for c in warm_calls])]
    if kernel == "warp_tangents":
        # the thread design alone, on the chain's outputs (computed here,
        # outside the timing)
        designs.append(("earlier kernel", kernel_fn("warp_tangents_threads"),
                        [chain_args(c) for c in warm_calls]))
    for name, fn in variant_fns(kernel, warm_calls):
        # each row gives the launched design's bits on every call it is timed on
        for c in warm_calls:
            if not same_bits(fn(*c.args), kernel_fn(kernel)(*c.args)):
                raise AssertionError(f"{label} {kernel} {name}: differs from the kernel")
        designs.append((name, fn, [c.args for c in warm_calls]))
    designs.append(("plain", plain_fn(kernel), [c.args for c in warm_calls]))
    rows = []
    for name, fn, args in designs:
        if fn is None:
            continue
        first = args[0]
        ms = kv.time_ms(lambda: fn(*first), reps, inner)
        warm = kv.device_ms([lambda a=a: fn(*a) for a in args], 20, w_inner)
        cold = kv.device_flushed_ms(lambda: fn(*first), 20, 20)
        rows.append(dict(inputs=label, kernel=kernel, name=name, calls=len(calls),
                         D=calls[0].tangents, dtype=str(calls[0].dtype).split(".")[-1],
                         ms=ms, device_ms=warm, device_cold_ms=cold, bound_ms=b_ms,
                         bound_by=b_by))
    if lib is not None:
        rows[0].update(library_ms=kv.time_ms(lib[0], reps, inner),
                       library_device_ms=kv.device_ms(lib, 20, w_inner),
                       library_device_cold_ms=kv.device_flushed_ms(lib[0], 20, 20))
    else:
        rows[0].update(library_ms=None, library_device_ms=None, library_device_cold_ms=None)
    if k1_n1 is not None:
        rows[0].update(k1_n1_ms=kv.time_ms(k1_n1[0], reps, inner),
                       k1_n1_device_ms=kv.device_ms(k1_n1, 20, w_inner),
                       k1_n1_device_cold_ms=kv.device_flushed_ms(k1_n1[0], 20, 20))

    if kernel == "image_bilinear_lk":
        rows[0].update(image_levels(label, warm_calls, designs, lib, k1_n1, out))

    def us(r):
        share = 100 * b_ms / r["device_cold_ms"] if r["device_cold_ms"] > 0 else math.nan
        return (f"{1e3 * r['ms']:.2f} us a call / {1e3 * r['device_ms']:.2f} warm / "
                f"{1e3 * r['device_cold_ms']:.2f} cold (bound {share:.1f} % of cold)")

    k = rows[0]
    lib_name = "grid_sample" if kernel == "image_bilinear_lk" else "cuBLAS Jw.T @ Jw"
    lib_txt = ("" if lib is None else
               f"; {lib_name} {1e3 * k['library_ms']:.2f} us a call / "
               f"{1e3 * k['library_device_ms']:.2f} warm / "
               f"{1e3 * k['library_device_cold_ms']:.2f} cold")
    if k1_n1 is not None:
        lib_txt += (f"; K1 at N = 1 on the whole image {1e3 * k['k1_n1_ms']:.2f} us a call / "
                    f"{1e3 * k['k1_n1_device_ms']:.2f} warm / "
                    f"{1e3 * k['k1_n1_device_cold_ms']:.2f} cold")
    out(f"{label} {kernel} ({len(calls)} calls, D={k['D']}, {k['dtype']}): " + "; ".join(
        f"{r['name']} {us(r)}" for r in rows) + f"; bound {1e3 * b_ms:.3f} us ({b_by})"
        + lib_txt)
    return rows


def image_levels(label: str, calls: List[ResidualCall], designs: list, lib: list,
                 k1_n1: list, out=print) -> dict:
    """K4's rows on its recorded C = 3 ``calls`` broken down (``designs``:
    :func:`time_rows`' (name, function, arguments) list; ``lib`` and
    ``k1_n1`` the yardsticks a call): the warm device time of the select,
    branch and interleaved designs, ``grid_sample`` and K1 at N = 1 on each
    pyramid level's calls, and on the first call alone (where PR 10 timed
    the yardsticks); then the interleaved row's plane, built once a keyframe
    level: how many the calls would need, its warm device time and its host
    time a build, against the device time the row saves on those calls.
    Returns dict(levels=[...], first_call={...}, plane={...})."""
    from ..ops import cuda_image

    fns = {n: f for n, f, _ in designs}
    timed = {"select": fns["kernel"], "branch": fns["earlier"],
             "interleaved": fns["interleaved"]}

    def row(js):
        inner = len(js) * math.ceil(50 / len(js))
        r = {name: kv.device_ms([lambda a=calls[j].args, fn=fn: fn(*a) for j in js], 20, inner)
             for name, fn in timed.items()}
        r["grid_sample"] = kv.device_ms([lib[j] for j in js], 20, inner)
        r["k1_n1"] = kv.device_ms([k1_n1[j] for j in js], 20, inner)
        return r

    def txt(r):
        return ", ".join(f"{name} {1e3 * r[name]:.2f}" for name in
                         ("select", "branch", "interleaved", "grid_sample", "k1_n1"))

    by_level: Dict[tuple, List[int]] = {}
    for j, c in enumerate(calls):
        by_level.setdefault((c.level, *c.args[0].shape), []).append(j)
    levels = []
    for (level, H, W), js in sorted(by_level.items(), key=lambda kv_: -kv_[0][1]):
        levels.append(dict(level=level, H=H, W=W, calls=len(js), **row(js)))
        out(f"{label} image_bilinear_lk, level {level} ({H} x {W}, {len(js)} calls), us warm: "
            + txt(levels[-1]))
    first = dict(level=calls[0].level, H=calls[0].args[0].shape[0],
                 W=calls[0].args[0].shape[1], **row([0]))
    out(f"{label} image_bilinear_lk, the first call alone (level {first['level']}, "
        f"{first['H']} x {first['W']}), us warm: " + txt(first))
    # the keyframe levels the calls sample: one plane each
    images: List[tuple] = []
    for c in calls:
        img, grad = c.args[:2]
        if not any(i.shape == img.shape and torch.equal(i, img) and torch.equal(g, grad)
                   for i, g in images):
            images.append((img, grad))
    build_dev, build_host = [], []
    for img, grad in images:
        build_dev.append(kv.device_ms([lambda i=img, g=grad: cuda_image.interleave_planes(i, g)],
                                      20, 50))
        for _ in range(kv.WARMUP):
            cuda_image.interleave_planes(img, grad)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            cuda_image.interleave_planes(img, grad)
        build_host.append((time.perf_counter() - t0) / 200 * 1e3)
        torch.cuda.synchronize()
    all_calls = row(list(range(len(calls))))
    saved = len(calls) * (all_calls["select"] - all_calls["interleaved"])
    plane = dict(builds=len(images), calls=len(calls), device_ms=sum(build_dev),
                 host_ms=sum(build_host), saved_device_ms=saved)
    out(f"{label} image_bilinear_lk, the interleaved row's planes: {len(images)} keyframe "
        f"levels for {len(calls)} C = 3 calls; building them takes "
        f"{1e3 * plane['device_ms']:.2f} us of device and {1e3 * plane['host_ms']:.2f} us of "
        f"host (enqueue, {', '.join(f'{1e3 * h:.2f}' for h in build_host)} a level); the row "
        f"saves {1e3 * saved:.2f} us of device on those calls (select "
        f"{1e3 * all_calls['select']:.2f} against interleaved "
        f"{1e3 * all_calls['interleaved']:.2f} us warm a call) and no host time")
    return dict(levels=levels, first_call=first, plane=plane)


# K3's CTAs a chunk: one cluster of the 16 chunks' CTAs, or 16 clusters of a
# CTA a part
K3_LAYOUTS = (1, 8)


def time_layouts(label: str, calls: List[ResidualCall], out=print) -> List[dict]:
    """K3's two layouts (:data:`K3_LAYOUTS`) on its recorded ``calls``: each
    held to the earlier design bit for bit on the first call, then timed on
    the device warm (a graph of at most 50 calls) and cold; returns a dict
    a layout."""
    from ..ops import cuda_residual as cr

    if not torch.cuda.is_available():
        raise RuntimeError("timing K2 and K3 needs a CUDA device")
    kernel, first = calls[0].kernel, calls[0].args
    rows = []
    warm_calls = calls[:50]
    w_inner = len(warm_calls) * math.ceil(50 / len(warm_calls))
    for pc in K3_LAYOUTS:
        name = f"{pc} CTA(s) a chunk"

        def fn(r, J, kp_w, huber_a, compensated=False, pc=pc):
            return cr._normal_equations_cluster(
                r.contiguous(), None if J is None else J.contiguous(), kp_w.contiguous(),
                huber_a, compensated, pc)

        if not same_bits(fn(*first), earlier_fn(kernel)(*first)):
            raise AssertionError(f"{label} {kernel} {name}: differs from the earlier design")
        warm = kv.device_ms([lambda a=c.args: fn(*a) for c in warm_calls], 20, w_inner)
        cold = kv.device_flushed_ms(lambda: fn(*first), 20, 20)
        rows.append(dict(inputs=label, kernel=kernel, layout=name, device_ms=warm,
                         device_cold_ms=cold))
        out(f"{label} {kernel} {name}: {1e3 * warm:.2f} warm / {1e3 * cold:.2f} cold "
            f"(equal to the earlier design)")
    return rows


# ------------------------------------------------ K6-K8: the LM iteration

LM_KERNELS = ("lm_step", "lm_decide", "lm_commit")
# the LM's dispatchers that record_lm_calls records: K6-K8 and the knot
# prior K9, which runs only where the prior is on (the joint path)
PRIOR = "knot_prior"
LM_STAGES = LM_KERNELS + (PRIOR,)
# K7's mu and sigma against the plain version's, relative to themselves
LM_TOLERANCE = {torch.float32: 1e-5, torch.float64: 1e-12}
# K9 against its plain version, relative to each output's magnitude, where a
# transcendental (sin, cos, atan2) rounds otherwise than torch's on the card
PRIOR_TOLERANCE = {torch.float32: 1e-6, torch.float64: 1e-13}


def _split(a: torch.Tensor):
    """Veltkamp's split of a into a high and a low half whose products are
    exact (2^27 + 1 in float64, 2^12 + 1 in float32)."""
    c = (134217729.0 if a.dtype == torch.float64 else 4097.0) * a
    hi = c - (c - a)
    return hi, a - hi


def _two_product(a: torch.Tensor, b: torch.Tensor):
    """(a b rounded, its rounding error), Dekker's product without a fused
    multiply-add."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    return p, (((ah * bh - p) + ah * bl) + al * bh) + al * bl


def cholesky_columns(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g in K6's order of operations (``csrc/lm_step.cu``): the
    right-looking Cholesky factorisation of H's lower triangle, column by
    column (the pivot's square root, the column divided by it, each
    trailing entry less one product a pivot), then L y = g row by row and
    L^T x = y back, every product rounded before its difference; then one
    step of refinement: the residual g - H x summed in double the working
    precision (each product split exactly, each sum's error kept, a row at
    a time in column order) and solved with the same factor. A pivot that
    is not positive fails the factorisation: a NaN x, as
    ``jnp.linalg.cholesky`` gives."""
    D = H.shape[0]
    A = H.clone()
    failed = torch.zeros((), dtype=torch.bool, device=H.device)
    for k in range(D):
        failed = failed | ~(A[k, k] > 0)
        A[k, k] = torch.sqrt(A[k, k])
        A[k + 1:, k] = A[k + 1:, k] / A[k, k]
        col = A[k + 1:, k]
        A[k + 1:, k + 1:] = A[k + 1:, k + 1:] - torch.outer(col, col)

    def solve(rhs):
        b = rhs.clone()
        for j in range(D):
            b[j] = b[j] / A[j, j]
            b[j + 1:] = b[j + 1:] - A[j + 1:, j] * b[j]
        for j in range(D - 1, -1, -1):
            b[j] = b[j] / A[j, j]
            b[:j] = b[:j] - A[j, :j] * b[j]
        return b

    x = solve(g)
    p, pe = _two_product(H, x[None, :].expand_as(H))
    s, c = g.clone(), torch.zeros_like(g)
    for j in range(D):
        t = s - p[:, j]
        bb = t - s
        c = c + (((s - (t - bb)) + (-p[:, j] - bb)) - pe[:, j])
        s = t
    x = x + solve(s + c)
    return torch.where(failed, torch.full_like(x, float("nan")), x)


def block_sum(v: torch.Tensor) -> torch.Tensor:
    """The sum of a vector in the order of K6's model change: a tree over
    ``cuda_lm.LM_TREE`` slots, each slot's strided entries summed in order
    first (the block design's threads; the shuffle design emulates the same
    tree in one warp)."""
    from ..ops import cuda_lm

    n = cuda_lm.LM_TREE
    rows = v.new_zeros(-(-v.shape[0] // n) * n)
    rows[:v.shape[0]] = v
    acc = torch.zeros_like(rows[:n])
    for row in rows.view(-1, n):
        acc = acc + row
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = acc[:half] + acc[half:]
    return acc[0]


def warp_count(w: torch.Tensor) -> torch.Tensor:
    """K8's staged design's residual count in its order (``lm_step.cu``'s
    ``lm_commit_staged_kernel``: each warp's lane l sums entries l, l + 32,
    ... in order, then ``warp_allsum``'s butterfly, each lane adding the
    lane ``s`` apart for s = 16 ... 1); every lane's sum, [32]. On 0/1
    weights every order gives the same bits."""
    W = 32
    lanes = torch.zeros(W, dtype=w.dtype)
    for lane in range(W):
        p = torch.zeros((), dtype=w.dtype)
        for n in range(lane, w.shape[0], W):
            p = p + w[n]
        lanes[lane] = p
    s = W // 2
    while s > 0:
        lanes = lanes + lanes[torch.arange(W) ^ s]
        s //= 2
    return lanes


def lm_step_kernel_order(H1: torch.Tensor, g: torch.Tensor):
    """K6's step and model cost change from its damped H1 in the kernel's
    order of operations: (step = -:func:`cholesky_columns` (H1, g), -(g .
    step + 0.5 step . (H1 step)) with H1 step a row at a time in column
    order and both dot products by :func:`block_sum`). On the card K6
    equals it bit for bit, however ill-conditioned H1; the plain stage
    solves with the library instead."""
    step = -cholesky_columns(H1, g)
    hs = torch.zeros_like(step)
    for j in range(step.shape[0]):
        hs = hs + H1[:, j] * step[j]
    return step, -(block_sum(g * step) + 0.5 * block_sum(step * hs))


@dataclasses.dataclass
class LMCall:
    """One recorded call of an LM stage's dispatcher in ``solver.lm``
    (``kernel`` one of :data:`LM_STAGES`): copies of its positional
    arguments, taken before the call (the kernels write the state in
    place)."""
    kernel: str
    args: tuple

    @property
    def dtype(self) -> torch.dtype:
        return (self.args[0].H if self.kernel == "lm_commit" else self.args[0]).dtype

    @property
    def D(self) -> int:
        """The unknowns 6K (K7's calls: 0, it has none)."""
        if self.kernel == "lm_decide":
            return 0
        if self.kernel == PRIOR:
            return 6 * self.args[0].shape[0]
        return (self.args[0].H if self.kernel == "lm_commit" else self.args[0]).shape[0]

    def fresh(self) -> tuple:
        """Copies of the arguments, for a call that may write into them."""
        return _lm_copy(self.args)


def _lm_copy(a):
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, tuple):
        items = [_lm_copy(x) for x in a]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return a


@contextlib.contextmanager
def record_lm_calls() -> Iterator[Dict[str, List[LMCall]]]:
    """Record every call of the LM's stage dispatchers (``solver.lm.lm_step``,
    ``lm_decide``, ``lm_commit`` and ``knot_prior``, which ``lm_iteration``
    and ``optimize_level`` look up when they run) made inside the block, by
    kernel (:data:`LM_STAGES`; the prior's list stays empty where the
    prior is off); the calls still run (K8's and K9's through the level's
    binding, which is not recorded: a recorded call replays through the
    dispatcher's other route, ``lm_commit_cuda`` and ``knot_prior_cuda``,
    and :func:`lm_commit_binding_fn` binds its state again). Names restored
    on leaving. Record outside a CUDA graph capture."""
    from ..solver import lm

    calls: Dict[str, List[LMCall]] = {k: [] for k in LM_STAGES}
    originals = {k: getattr(lm, k) for k in LM_STAGES}

    def recorder(kernel):
        def recording(*args, **kw):
            calls[kernel].append(LMCall(kernel, _lm_copy(args)))
            return originals[kernel](*args, **kw)
        return recording

    for k in LM_STAGES:
        setattr(lm, k, recorder(k))
    try:
        yield calls
    finally:
        for k, fn in originals.items():
            setattr(lm, k, fn)


def lm_kernel_fn(kernel: str):
    from ..solver import lm

    return getattr(lm, kernel)


def lm_plain_fn(kernel: str):
    """The plain version of an LM stage, taking its dispatcher's arguments
    (K8's ``binding``, which the plain stage has no use for, dropped): what
    replaces the dispatcher in the plain-stage tracker."""
    from ..solver import lm

    fn = getattr(lm, f"{kernel}_plain")
    if kernel in ("lm_commit", PRIOR):
        return lambda *args, binding=None: fn(*args)
    return fn


def _knot_prior_residual(knots) -> torch.Tensor:
    """[(K-2)*6] constant-velocity violation: second differences of knot
    translations and of consecutive relative-rotation tangents (the prior's
    residual, which K9 and its plain version linearise in closed form)."""
    from ..core.lie import quat_conjugate, quat_log, quat_multiply

    d2t = knots.t[2:] - 2.0 * knots.t[1:-1] + knots.t[:-2]          # [K-2, 3]
    w_rel = quat_log(quat_multiply(quat_conjugate(knots.q[:-1]), knots.q[1:]))
    d2w = w_rel[1:] - w_rel[:-1]                                     # [K-2, 3]
    return torch.cat([d2t.reshape(-1), d2w.reshape(-1)])


def knot_prior_jacfwd(t: torch.Tensor, q: torch.Tensor, weight: float):
    """The knot prior's (cost, g, H) as the LM computed it before K9: the
    residual's Jacobian by ``torch.func.jacfwd`` through
    ``spline_retract_flat`` at zero (eager, ~300 ops), then J^T p and J^T J
    by the library. The old path of the harness's K9 row; no path of the
    port runs it."""
    from torch.func import jacfwd

    from ..core.spline import SplineKnots, spline_retract_flat

    knots = SplineKnots(t, q, None, None)
    zero = t.new_zeros(6 * t.shape[0])

    def prior_of(delta):
        return _knot_prior_residual(spline_retract_flat(knots, delta))

    p0 = prior_of(zero)
    Jp = jacfwd(prior_of)(zero)   # [P, 6K]
    cost = 0.5 * weight * torch.sum(p0 * p0)
    return cost, weight * (Jp.T @ p0), weight * (Jp.T @ Jp)


# K6's to K8's earlier designs (the block designs), by the name of
# their wrapper in ops/cuda_lm.py; K6's and K8's give the launched design's
# bits
LM_EARLIER = {"lm_step": "lm_step_block_cuda", "lm_decide": "lm_decide_block_cuda",
              "lm_commit": "lm_commit_block_cuda"}


def lm_earlier_fn(kernel: str):
    """The earlier design of an LM stage (None where it has none), taking
    the dispatcher's arguments."""
    from ..ops import cuda_lm

    if kernel not in LM_EARLIER:
        return None
    wrapper = getattr(cuda_lm, LM_EARLIER[kernel])
    if kernel == "lm_step":
        return lambda H, g, scalars, t, q, solver="cholesky": wrapper(H, g, scalars, t, q)
    if kernel == "lm_commit":
        return _commit_fn(wrapper)
    return lambda cost, patch, kp_w, kp_mask, scalars, P, opts, prior_cost=None: wrapper(
        cost, patch, kp_w, kp_mask, scalars, P, opts.max_chi_square_error,
        opts.min_step_quality, prior_cost)


def _commit_fn(wrapper):
    """A K8 wrapper of ``ops/cuda_lm.py`` taking the dispatcher's
    (``solver.lm.lm_commit``'s) arguments and returning the state."""
    from ..solver import lm

    def commit(s, H1, cand_t, cand_q, cost, g, H, patch, mask, kp_w, P, opts, more,
               prior=None):
        wrapper(*s, H1, cand_t, cand_q, cost, g, H, patch, mask, kp_w, P, more=more,
                prior=prior, **lm.commit_options(opts))
        return s
    return commit


def lm_commit_binding_fn(call: "LMCall"):
    """K8 as the LM calls it: a ``cuda_lm.CommitBinding`` of the state of
    ``call``'s arguments (bound here, outside any timing), called with the
    dispatcher's arguments; a state other than the bound one is bound again
    by the call."""
    from ..ops import cuda_lm
    from ..solver import lm

    s, P, opts = call.args[0], call.args[10], call.args[11]
    binding = cuda_lm.CommitBinding(s, P, **lm.commit_options(opts))

    def commit(s, H1, cand_t, cand_q, cost, g, H, patch, mask, kp_w, P, opts, more,
               prior=None):
        return lm.lm_commit(s, H1, cand_t, cand_q, cost, g, H, patch, mask, kp_w, P, opts,
                            more, prior, binding=binding)
    return commit


UNIT_ROUNDOFF = {torch.float32: 2.0 ** -24, torch.float64: 2.0 ** -53}


def step_forward_errors(H1: torch.Tensor, g: torch.Tensor, steps: Dict[str, torch.Tensor],
                        refined: Tuple[str, ...] = ()):
    """Each step of ``steps`` against x64, the float64 solve of the same H1
    and g (cast up; LAPACK's LU on the CPU): ||step + x64|| / ||x64|| (the
    step is -x), with kappa_2(H1) and each step's bound, u the working
    type's unit roundoff: 3 D kappa_2(H1) u, the forward error that a
    backward-stable Cholesky solve allows; for a step named in ``refined``
    (refined once, its residual summed in double the working precision)
    kappa_2(H1) u, with no factor D. The second is an empirical bound, not a
    theorem: one such refinement takes the error of a solve whose D
    kappa_2 u is small down to ~u, and every recorded call of the tracker
    leaves K6's step far under it. Returns (errors by name, kappa, bounds
    by name); :func:`forward_verdicts` checks them."""
    H64, g64 = H1.detach().double().cpu(), g.detach().double().cpu()
    x64 = torch.linalg.solve(H64, g64)
    kappa = float(torch.linalg.cond(H64))
    u = UNIT_ROUNDOFF[H1.dtype]
    norm = float(torch.linalg.norm(x64))
    errs = {name: float(torch.linalg.norm(s.detach().double().cpu() + x64)) / norm
            for name, s in steps.items()}
    bounds = {name: kappa * u if name in refined else 3 * H1.shape[0] * kappa * u
              for name in steps}
    return errs, kappa, bounds


def forward_verdicts(label: str, errs: Dict[str, float], bounds: Dict[str, float]):
    """Each step's verdict under its bound (:func:`step_forward_errors`):
    "held" where its error is within a bound under 1; "unchecked" where the
    bound is 1 or more, which any step meets, a zero step (error 1)
    included. Raises where a step is over its bound."""
    verdicts = {}
    for name, e in errs.items():
        if bounds[name] >= 1.0:
            verdicts[name] = "unchecked"
        elif e <= bounds[name]:
            verdicts[name] = "held"
        else:
            raise AssertionError(f"{label}: the {name} step's forward error {e:.3e} is over "
                                 f"its bound {bounds[name]:.3e}")
    return verdicts


def _hold_decide(label: str, out, ref, bound: float) -> dict:
    """K7's results ``out`` against the plain stage's ``ref``: the flags,
    decrease, mask and weights equal, mu and sigma within ``bound``."""
    from ..solver import lm

    (sc, mask, w), (psc, pmask, pw) = out, ref
    exact = (lm.S_CAND_COST, lm.S_QUALITY, lm.S_SUCCESS, lm.S_ACD_NEW)
    if not (same_bits(sc[list(exact)], psc[list(exact)]) and torch.equal(mask, pmask)
            and torch.equal(w, pw)):
        raise AssertionError(f"{label}: flags, decrease or mask differ: "
                             f"{sc[list(exact)].tolist()} {psc[list(exact)].tolist()}, "
                             f"{int((mask != pmask).sum())} mask entries")
    errs = {"abs": float((sc[[lm.S_MU, lm.S_SIGMA]] - psc[[lm.S_MU, lm.S_SIGMA]])
                         .abs().max())}
    for name, i in (("mu", lm.S_MU), ("sigma", lm.S_SIGMA)):
        got, want = float(sc[i]), float(psc[i])
        errs[name] = abs(got - want) / (abs(want) if want else 1.0)
        if not errs[name] <= bound:
            raise AssertionError(f"{label}: {name} {errs[name]:.3e} (bound {bound})")
    return dict(errs, success=float(sc[lm.S_SUCCESS]))


def _ulps(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |out - ref| in units of the last place of ref's entry."""
    r = ref.abs()
    ulp = torch.nextafter(r, torch.full_like(r, math.inf)) - r
    return float(((out - ref).abs() / ulp).max())


def _hold_prior(call: LMCall) -> dict:
    """K9's recorded call through the kernel and the plain version on
    fresh copies: each output (cost, g, H) within :data:`PRIOR_TOLERANCE`
    of its largest magnitude (raises past it, or on a NaN); returns the
    largest relative (``prior``) and absolute (``abs``) differences, the
    largest in units of the plain value's last place (``ulps``) and whether
    every output was equal bit for bit (``bits``, 1.0 or 0.0)."""
    bound = PRIOR_TOLERANCE[call.dtype]
    label = f"{call.kernel} ({str(call.dtype).split('.')[-1]}, D={call.D})"
    out = lm_kernel_fn(PRIOR)(*call.fresh())
    ref = lm_plain_fn(PRIOR)(*call.fresh())
    got = dict(prior=0.0, abs=0.0, ulps=0.0, bits=float(same_bits(out, ref)))
    for name, o, r in zip(("cost", "g", "H"), out, ref):
        d, scale = float((o - r).abs().max()), float(r.abs().max())
        err = d / scale if scale else (0.0 if d == 0.0 else math.inf)
        if not err <= bound:
            raise AssertionError(f"{label}: {name} differs from the plain version by "
                                 f"{err:.3e} of its magnitude (bound {bound:.0e})")
        got.update(prior=max(got["prior"], err), abs=max(got["abs"], d),
                   ulps=max(got["ulps"], _ulps(o, r)))
    return got


def hold_lm(call: LMCall) -> dict:
    """The recorded call through the kernel, its earlier design
    (:data:`LM_EARLIER`) and the plain version on fresh copies; raises
    where they disagree: K6 its damped H by a bit from the plain stage's,
    its step, model change and invalid flag by a bit from
    :func:`lm_step_kernel_order` on that H1, its candidate knots by a bit
    from ``spline_retract_flat`` of its own step (the knots when invalid),
    its earlier design by a bit in any output, and its refined step past
    kappa_2(H1) u or the plain stage's library step past 3 D kappa_2(H1) u
    of a float64 solve, where that bound is under 1
    (:func:`step_forward_errors`, :func:`forward_verdicts`); K7 (both designs) its candidate cost,
    quality, success, cost decrease, mask or keypoint weights by a bit, mu
    or sigma by more than :data:`LM_TOLERANCE`; K8 any part of the next
    state by a bit, in both designs, the staged design through
    ``lm_commit_cuda`` and through a ``CommitBinding``. Returns the
    differences measured (``step``: K6's step
    against the plain stage's library solve, relative to its norm, a
    figure and no check; ``fwd_kernel``, ``fwd_library``, ``kappa``,
    ``fwd_bound_*``: the forward errors and their bounds, NaN on an
    invalid step; ``fwd_checked_*``: whether the bound was under 1; ``mu``,
    ``sigma``: relative, the larger of the two designs'; ``abs``: the
    largest absolute; ``invalid``, ``success``: the flags). K9's calls go
    to :func:`_hold_prior`."""
    from ..core.spline import SplineKnots, spline_retract_flat
    from ..solver import lm

    if call.kernel == PRIOR:
        return _hold_prior(call)
    bound = LM_TOLERANCE[call.dtype]
    label = f"{call.kernel} ({str(call.dtype).split('.')[-1]}, D={call.D})"
    out = lm_kernel_fn(call.kernel)(*call.fresh())
    ref = lm_plain_fn(call.kernel)(*call.fresh())
    earlier = lm_earlier_fn(call.kernel)
    before = earlier(*call.fresh()) if earlier is not None else None
    if call.kernel == "lm_step":
        H1, step, ct, cq, sc = out
        pH1, pstep, _, _, psc = ref
        if not same_bits(out, before):
            raise AssertionError(f"{label}: the shuffle design and the block design differ: "
                                 f"{_unequal(out, before)}")
        if not same_bits(H1, pH1):
            raise AssertionError(f"{label}: damped H differs")
        ostep, omcc = lm_step_kernel_order(H1, call.args[1])
        oinvalid = bool(omcc < 0) or not bool(torch.isfinite(ostep).all())
        invalid = float(sc[lm.S_INVALID])
        if not (same_bits(step, ostep) and same_bits(sc[lm.S_MCC], omcc)
                and invalid == float(oinvalid)):
            raise AssertionError(f"{label}: step, model change or invalid flag differ from "
                                 f"K6's order transcribed: {_unequal(step, ostep)}")
        err = err_abs = 0.0
        fwd = dict(fwd_kernel=math.nan, fwd_library=math.nan, kappa=math.nan,
                   fwd_bound_kernel=math.nan, fwd_bound_library=math.nan,
                   fwd_checked_kernel=False, fwd_checked_library=False)
        if invalid:
            t, q = call.args[3], call.args[4]
            if not (torch.equal(ct, t) and torch.equal(cq, q)):
                raise AssertionError(f"{label}: an invalid step's candidate is not the knots")
        else:
            cand = spline_retract_flat(SplineKnots(call.args[3], call.args[4], None, None),
                                       step)
            if not (torch.equal(ct, cand.t) and torch.equal(cq, cand.q)):
                raise AssertionError(f"{label}: candidate unequal to the retraction of "
                                     f"K6's step")
            if bool(torch.isfinite(pstep).all()):
                err_abs = float((step - pstep).abs().max())
                err = err_abs / float(torch.linalg.norm(pstep))
                errs, kappa, fb = step_forward_errors(H1, call.args[1],
                                                      {"kernel": step, "library": pstep},
                                                      refined=("kernel",))
                verdicts = forward_verdicts(label, errs, fb)
                fwd = dict(fwd_kernel=errs["kernel"], fwd_library=errs["library"],
                           kappa=kappa, fwd_bound_kernel=fb["kernel"],
                           fwd_bound_library=fb["library"],
                           fwd_checked_kernel=verdicts["kernel"] == "held",
                           fwd_checked_library=verdicts["library"] == "held")
        return dict(step=err, abs=err_abs, invalid=invalid,
                    plain_invalid=float(psc[lm.S_INVALID]), **fwd)
    if call.kernel == "lm_decide":
        got = _hold_decide(label, out, ref, bound)
        old = _hold_decide(f"{label}, the block design", before, ref, bound)
        return dict(got, abs=max(got["abs"], old["abs"]), mu=max(got["mu"], old["mu"]),
                    sigma=max(got["sigma"], old["sigma"]))
    # lm_commit writes its state in place and returns it
    designs = {"the block design": before,
               "the binding": lm_commit_binding_fn(call)(*call.fresh())}
    for name, a, b in zip(lm.LMState._fields, out, ref):
        if not same_bits(a, b):
            raise AssertionError(f"{label}: {name} differs: {_unequal(a, b)}")
    for design, got in designs.items():
        for name, a, b in zip(lm.LMState._fields, got, ref):
            if not same_bits(a, b):
                raise AssertionError(f"{label}, {design}: {name} differs: {_unequal(a, b)}")
    return {"abs": 0.0}


def _lm_bound(call: LMCall):
    """(bound ms, "bytes" or "operations") of an LM stage's call: each input
    read once and each output written once at 3.35 TB/s, against its
    floating-point operations (K6: the Cholesky factorisation's D^3 / 3, the
    two solves' 2 D^2, H1 times the step's 2 D^2; K7 and K8 a few an entry)
    at the card's rate for the dtype. K8 counts what the call's branch
    moves: each state array once, as written (on a rejected or invalid
    step only H, from H1, and the scalars). K9 reads the knots and writes
    cost, g and H; its operations: ~150 a knot pair (the product, log,
    Jr^-1 and Jr^-1 R^T), ~500 a prior block (3 x 3 pairs of its blocks, 9
    entries each, a dot product of 3 and a sum: 6) and the weight's product
    an output."""
    a = call.args
    rate = F64_FLOPS_PER_S if call.dtype == torch.float64 else kv.F32_FLOPS_PER_S
    if call.kernel == PRIOR:
        t, q = a[:2]
        K, D = t.shape[0], call.D
        moved = _nbytes(t, q) + (1 + D + D * D) * t.element_size()
        ops = 150 * (K - 1) + 500 * (K - 2) + D * D + D
    elif call.kernel == "lm_step":
        H, g, sc, t, q = a[:5]
        D = H.shape[0]
        moved = 2 * _nbytes(H, g, t, q) + _nbytes(sc) + g.element_size() * 2
        ops = D ** 3 / 3 + 6 * D * D + 40 * t.shape[0]
    elif call.kernel == "lm_decide":
        cost, patch, w, kp_mask, sc = a[:5]
        moved = _nbytes(cost, patch, w, kp_mask, sc) + 2 * _nbytes(w)
        ops = 8 * patch.numel() + 10 * w.numel()
    else:
        # what this call's branch moves: K6's and K7's flags in the
        # scalars choose it
        from ..solver import lm

        s, H1, ct, cq, cost, g, H, patch, mask, kp_w = a[:10]
        prior = [x for x in (a[13] or ()) if torch.is_tensor(x)]
        sc = s.scalars
        success = bool(sc[lm.S_SUCCESS] != 0) and not bool(sc[lm.S_INVALID] != 0)
        # always: the scalars read and written, the new weights read (the
        # residual count), H written once from one D x D input (H1, or K3's
        # H on success: either, the same size)
        moved = 2 * _nbytes(sc) + _nbytes(kp_w, s.H, H1)
        ops = s.H.numel() + 40
        if success:
            # the candidate's sums and the new mask read, the state written
            moved += (_nbytes(ct, cq, cost, g, patch, mask, *prior)
                      + _nbytes(s.t, s.q, s.g, s.mask, s.kp_w, s.patch_costs))
            ops += 2 * (s.H.numel() + s.g.numel()) + s.patch_costs.numel()
    b_ms, o_ms = 1e3 * moved / kv.HBM_BYTES_PER_S, 1e3 * ops / rate
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def _cholesky_yardstick(call: LMCall):
    """The solve part of K6 as the library computes it: two PyTorch calls,
    ``torch.linalg.cholesky_ex`` of the damped H and ``torch.cholesky_solve``,
    on the call's H1 (computed once, outside)."""
    H, g, sc = call.args[:3]
    from ..solver import lm

    H1 = H + torch.diag(torch.diag(H)) / sc[lm.S_RADIUS]
    rhs = g[:, None].clone()

    def solve():
        L, _ = torch.linalg.cholesky_ex(H1)
        return torch.cholesky_solve(rhs, L)
    return solve


def floor_call(call: LMCall) -> LMCall:
    """The floor of an LM stage's recorded ``call``: K6 at one knot (D = 6,
    the leading block of the call's H, itself positive definite where H
    is), K7 at one keypoint of one frame, K8 at one knot, one frame and one
    keypoint (K = 1, F = 1, N = 1: the state and the iteration's tensors
    sliced as for K6 and K7, the scalars and the options as recorded), K9
    at its least, 3 knots; the least work one launch of the design does."""
    a = call.args
    if call.kernel == PRIOR:
        return LMCall(call.kernel, (a[0][:3].contiguous(), a[1][:3].contiguous()) + tuple(a[2:]))
    if call.kernel == "lm_step":
        H, g, sc, t, q = a[:5]
        return LMCall(call.kernel, (H[:6, :6].contiguous(), g[:6].contiguous(), sc,
                                    t[:1].contiguous(), q[:1].contiguous()) + tuple(a[5:]))
    if call.kernel == "lm_commit":
        from ..solver import lm

        def knot(x):    # [D] or [D, D] sliced to one knot's 6 unknowns
            return (x[:6, :6] if x.dim() == 2 else x[:6]).contiguous()

        s, H1, ct, cq, cost, g, H, patch, mask, kp_w = a[:10]
        state = lm.LMState(s.t[:1].contiguous(), s.q[:1].contiguous(),
                           s.H[:6, :6].contiguous(), s.g[:6].contiguous(), s.scalars,
                           s.mask[:1].contiguous(), s.kp_w[:1].contiguous(),
                           s.patch_costs[:1, :1].contiguous())
        prior = a[13] if len(a) > 13 else None
        if prior is not None:
            prior = (prior[0], knot(prior[1]), knot(prior[2]))
        return LMCall(call.kernel, (state, knot(H1), ct[:1].contiguous(), cq[:1].contiguous(),
                                    cost, knot(g), knot(H), patch[:1, :1].contiguous(),
                                    mask[:1].contiguous(), kp_w[:1].contiguous())
                      + tuple(a[10:13]) + (prior,))
    cost, patch, kp_w, kp_mask = a[:4]
    return LMCall(call.kernel, (cost, patch[:1, :1].contiguous(), kp_w[:1].contiguous(),
                                kp_mask[:1].contiguous()) + tuple(a[4:]))


def interleaved_ms(fns: Sequence[Callable[[], object]], reps: int = 10,
                   inner: int = 10) -> List[float]:
    """``kernel_variants.time_ms`` of each of ``fns`` in one loop: each rep
    times ``inner`` calls of every function in turn, so that a drift of the
    host's speed reaches each alike; a median over the reps each, in
    milliseconds."""
    for fn in fns:
        for _ in range(kv.WARMUP):
            fn()
    torch.cuda.synchronize()
    samples: List[List[float]] = [[] for _ in fns]
    for _ in range(reps):
        for fn, got in zip(fns, samples):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(inner):
                fn()
            b.record()
            b.synchronize()
            got.append(a.elapsed_time(b) / inner)
    return [statistics.median(got) for got in samples]


def time_lm_rows(label: str, calls: List[LMCall], reps: int = 10, inner: int = 10,
                 out=print) -> List[dict]:
    """An LM stage's kernel, earlier design (:data:`LM_EARLIER`, where it
    has one; for K9 its old path, :func:`knot_prior_jacfwd`) and plain
    version timed on its recorded ``calls`` as
    :func:`time_rows` times K2-K5 (a call, warm in a replayed graph of the
    calls in order, cold after an L2 flush on the first), on fresh copies
    of each call's arguments made once outside the timing (K8's repeated
    calls advance their copy of the state; the work does not depend on it);
    for K6 the library's Cholesky solve beside it
    (:func:`_cholesky_yardstick`); each design's floor (:func:`floor_call`:
    ``floor_device_ms`` and ``floor_device_cold_ms`` in its row); for K8
    the kernel row's ``binding_ms``, a call through a ``CommitBinding`` of
    the first call's state (the LM's host call), and its ``ms``, the public
    wrapper's call, both from one :func:`interleaved_ms`. Returns the kernel's
    dict first, the earlier design's (or old path's) second where there is
    one, the plain version's last."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing the LM's kernels needs a CUDA device")
    kernel = calls[0].kernel
    warm = calls[:50]
    bounds = [_lm_bound(c) for c in warm]
    b_ms = statistics.fmean(b for b, _ in bounds)
    b_by = max(("bytes", "operations"), key=[by for _, by in bounds].count)
    w_inner = len(warm) * math.ceil(50 / len(warm))
    earlier = (("old path", knot_prior_jacfwd) if kernel == PRIOR
               else ("earlier", lm_earlier_fn(kernel)))
    designs = [("kernel", lm_kernel_fn(kernel)), earlier, ("plain", lm_plain_fn(kernel))]
    floor = floor_call(calls[0]) if kernel in LM_EARLIER or kernel == PRIOR else None
    rows = []
    for name, fn in designs:
        if fn is None:
            continue
        args = [c.fresh() for c in warm]
        first = args[0]
        row = dict(inputs=label, kernel=kernel, name=name, calls=len(calls), D=calls[0].D,
                   dtype=str(calls[0].dtype).split(".")[-1],
                   ms=kv.time_ms(lambda: fn(*first), reps, inner),
                   device_ms=kv.device_ms([lambda a=a: fn(*a) for a in args], reps, w_inner),
                   device_cold_ms=kv.device_flushed_ms(lambda: fn(*first), reps, 20),
                   bound_ms=b_ms, bound_by=b_by)
        if floor is not None and name in ("kernel", "earlier"):
            fa = floor.fresh()
            row.update(floor_device_ms=kv.device_ms([lambda: fn(*fa)], reps, 50),
                       floor_device_cold_ms=kv.device_flushed_ms(lambda: fn(*fa), reps, 20))
        rows.append(row)
    k = rows[0]
    k.update(library_ms=None, library_device_ms=None, library_device_cold_ms=None)
    if kernel == "lm_step":
        lib = [_cholesky_yardstick(c) for c in warm]
        k.update(library_ms=kv.time_ms(lib[0], reps, inner),
                 library_device_ms=kv.device_ms(lib, reps, w_inner),
                 library_device_cold_ms=kv.device_flushed_ms(lib[0], reps, 20))
    extra = ""
    if kernel == "lm_commit":
        # the public wrapper's call and the binding's, timed in turn in one
        # loop; the first replaces the row's ``ms``
        fa, fb = calls[0].fresh(), calls[0].fresh()
        fn, bound = lm_kernel_fn(kernel), lm_commit_binding_fn(LMCall(kernel, fb))
        k["ms"], k["binding_ms"] = interleaved_ms([lambda: fn(*fa), lambda: bound(*fb)], reps,
                                                  inner)
        extra = (f"; a call through a CommitBinding {1e3 * k['binding_ms']:.2f} us, "
                 f"lm_commit_cuda's {1e3 * k['ms']:.2f} (timed in turn)")

    def us(r):
        fl = ("" if "floor_device_ms" not in r else
              f" (floor {1e3 * r['floor_device_ms']:.2f} / "
              f"{1e3 * r['floor_device_cold_ms']:.2f})")
        return (f"{1e3 * r['ms']:.2f} us a call / {1e3 * r['device_ms']:.2f} warm / "
                f"{1e3 * r['device_cold_ms']:.2f} cold{fl}")

    lib_txt = ("" if k["library_ms"] is None else
               f"; cholesky_ex + cholesky_solve (two calls, the solve alone) "
               f"{1e3 * k['library_ms']:.2f} us a call / "
               f"{1e3 * k['library_device_ms']:.2f} warm / "
               f"{1e3 * k['library_device_cold_ms']:.2f} cold")
    out(f"{label} {kernel} ({len(calls)} calls, D={k['D']}, {k['dtype']}): " + "; ".join(
        f"{r['name']} {us(r)}" for r in rows) + f"; bound {1e3 * b_ms:.4f} us ({b_by})"
        + lib_txt + extra)
    return rows


def main(argv=None) -> int:
    """Record the bench scenario's K2-K9 calls (16 frames of track_frame,
    f32; one joint chunk at degree 4; 4 frames of the direct path), hold
    each against the plain version and the earlier design, and time every
    kernel (``--layouts``: K3's layout sweep instead)."""
    layouts = "--layouts" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("residual_kernels: needs one CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    print(kv.card_line())
    img, traj, frames = smoke.make_scenario("cuda", smoke.LONG_FRAMES)
    _, recorded, lm_calls = smoke.record_tracker_calls(img, traj, frames)
    smoke.hold_residual_calls(recorded)
    smoke.hold_lm_calls(lm_calls)
    if not layouts:
        for label, by_kernel in lm_calls.items():
            for kernel, calls in by_kernel.items():
                time_lm_rows(label, calls, out=print)
    for label, by_kernel in recorded.items():
        for kernel, calls in by_kernel.items():
            if not layouts:
                time_rows(label, full_calls(calls), out=print)
            elif kernel == "normal_equations":
                time_layouts(label, full_calls(calls), out=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
