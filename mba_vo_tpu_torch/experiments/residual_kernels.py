"""Kernels K2-K8 on the tracker's own inputs, on one NVIDIA GPU: record,
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
repeats), and :func:`time_lm_rows` times kernel and plain stage, with
``torch.linalg.cholesky_ex`` + ``torch.cholesky_solve`` beside K6 as its
library yardstick.

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
from typing import Dict, Iterator, List, Optional

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
# K7's mu and sigma against the plain version's, relative to themselves
LM_TOLERANCE = {torch.float32: 1e-5, torch.float64: 1e-12}


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
    """The sum of a vector in the order of K6's block reduction over its
    ``cuda_lm.LM_THREADS`` threads: each thread's strided entries in order,
    then a tree over the threads."""
    from ..ops import cuda_lm

    n = cuda_lm.LM_THREADS
    rows = v.new_zeros(-(-v.shape[0] // n) * n)
    rows[:v.shape[0]] = v
    acc = torch.zeros_like(rows[:n])
    for row in rows.view(-1, n):
        acc = acc + row
    while acc.shape[0] > 1:
        half = acc.shape[0] // 2
        acc = acc[:half] + acc[half:]
    return acc[0]


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
    (``kernel`` one of :data:`LM_KERNELS`): copies of its positional
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
    """Record every call of the LM's three stage dispatchers
    (``solver.lm.lm_step``, ``lm_decide``, ``lm_commit``, which
    ``lm_iteration`` looks up when it runs) made inside the block, by
    kernel; the calls still run. Names restored on leaving. Record outside a
    CUDA graph capture."""
    from ..solver import lm

    calls: Dict[str, List[LMCall]] = {k: [] for k in LM_KERNELS}
    originals = {k: getattr(lm, k) for k in LM_KERNELS}

    def recorder(kernel):
        def recording(*args):
            calls[kernel].append(LMCall(kernel, _lm_copy(args)))
            return originals[kernel](*args)
        return recording

    for k in LM_KERNELS:
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
    from ..solver import lm

    return getattr(lm, f"{kernel}_plain")


def hold_lm(call: LMCall) -> dict:
    """The recorded call through the kernel and the plain version on fresh
    copies; raises where they disagree: K6 its damped H by a bit from the
    plain stage's, its step, model cost change and invalid flag by a bit
    from :func:`lm_step_kernel_order` on that H1, its candidate knots by a
    bit from ``spline_retract_flat`` of its own step (the knots when
    invalid); K7 its candidate cost, quality, success, cost decrease, mask
    or keypoint weights by a bit, mu or sigma by more than
    :data:`LM_TOLERANCE`; K8 any part of the next state by a bit. Returns
    the differences measured (``step``: K6's step against the plain stage's
    library solve, relative to its norm, a figure and no check; ``mu``,
    ``sigma``: relative; ``abs``: the largest absolute; ``invalid``,
    ``success``: the flags)."""
    from ..core.spline import SplineKnots, spline_retract_flat
    from ..solver import lm

    bound = LM_TOLERANCE[call.dtype]
    label = f"{call.kernel} ({str(call.dtype).split('.')[-1]}, D={call.D})"
    out = lm_kernel_fn(call.kernel)(*call.fresh())
    ref = lm_plain_fn(call.kernel)(*call.fresh())
    if call.kernel == "lm_step":
        H1, step, ct, cq, sc = out
        pH1, pstep, _, _, psc = ref
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
        return dict(step=err, abs=err_abs, invalid=invalid,
                    plain_invalid=float(psc[lm.S_INVALID]))
    if call.kernel == "lm_decide":
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
    # lm_commit writes its state in place and returns it
    for name, a, b in zip(lm.LMState._fields, out, ref):
        if not same_bits(a, b):
            raise AssertionError(f"{label}: {name} differs: {_unequal(a, b)}")
    return {"abs": 0.0}


def _lm_bound(call: LMCall):
    """(bound ms, "bytes" or "operations") of an LM stage's call: each input
    read once and each output written once at 3.35 TB/s, against its
    floating-point operations (K6: the Cholesky factorisation's D^3 / 3, the
    two solves' 2 D^2, H1 times the step's 2 D^2; K7 and K8 a few an entry)
    at the card's rate for the dtype. K8 counts what the call's branch
    moves: each state array once, as written (on a rejected or invalid
    step only H, from H1, and the scalars)."""
    a = call.args
    rate = F64_FLOPS_PER_S if call.dtype == torch.float64 else kv.F32_FLOPS_PER_S
    if call.kernel == "lm_step":
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


def time_lm_rows(label: str, calls: List[LMCall], reps: int = 10, inner: int = 10,
                 out=print) -> List[dict]:
    """An LM stage's kernel and plain version timed on its recorded ``calls``
    as :func:`time_rows` times K2-K5 (a call, warm in a replayed graph of the
    calls in order, cold after an L2 flush on the first), on fresh copies
    of each call's arguments made once outside the timing (K8's repeated
    calls advance their copy of the state; the work does not depend on it);
    for K6 the library's Cholesky solve beside it (:func:`_cholesky_yardstick`).
    Returns the kernel's dict first, the plain version's last."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing the LM's kernels needs a CUDA device")
    kernel = calls[0].kernel
    warm = calls[:50]
    bounds = [_lm_bound(c) for c in warm]
    b_ms = statistics.fmean(b for b, _ in bounds)
    b_by = max(("bytes", "operations"), key=[by for _, by in bounds].count)
    w_inner = len(warm) * math.ceil(50 / len(warm))
    rows = []
    for name, fn in (("kernel", lm_kernel_fn(kernel)), ("plain", lm_plain_fn(kernel))):
        args = [c.fresh() for c in warm]
        first = args[0]
        rows.append(dict(inputs=label, kernel=kernel, name=name, calls=len(calls),
                         D=calls[0].D, dtype=str(calls[0].dtype).split(".")[-1],
                         ms=kv.time_ms(lambda: fn(*first), reps, inner),
                         device_ms=kv.device_ms([lambda a=a: fn(*a) for a in args], reps,
                                                w_inner),
                         device_cold_ms=kv.device_flushed_ms(lambda: fn(*first), reps, 20),
                         bound_ms=b_ms, bound_by=b_by))
    k = rows[0]
    k.update(library_ms=None, library_device_ms=None, library_device_cold_ms=None)
    if kernel == "lm_step":
        lib = [_cholesky_yardstick(c) for c in warm]
        k.update(library_ms=kv.time_ms(lib[0], reps, inner),
                 library_device_ms=kv.device_ms(lib, reps, w_inner),
                 library_device_cold_ms=kv.device_flushed_ms(lib[0], reps, 20))

    def us(r):
        return (f"{1e3 * r['ms']:.2f} us a call / {1e3 * r['device_ms']:.2f} warm / "
                f"{1e3 * r['device_cold_ms']:.2f} cold")

    lib_txt = ("" if k["library_ms"] is None else
               f"; cholesky_ex + cholesky_solve (two calls, the solve alone) "
               f"{1e3 * k['library_ms']:.2f} us a call / "
               f"{1e3 * k['library_device_ms']:.2f} warm / "
               f"{1e3 * k['library_device_cold_ms']:.2f} cold")
    out(f"{label} {kernel} ({len(calls)} calls, D={k['D']}, {k['dtype']}): " + "; ".join(
        f"{r['name']} {us(r)}" for r in rows) + f"; bound {1e3 * b_ms:.4f} us ({b_by})"
        + lib_txt)
    return rows


def main(argv=None) -> int:
    """Record the bench scenario's K2-K8 calls (16 frames of track_frame,
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
