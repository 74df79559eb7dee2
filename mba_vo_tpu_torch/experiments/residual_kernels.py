"""Kernels K2, K3, K4 and K5 on the tracker's own inputs, on one NVIDIA
GPU: record, hold against the plain versions and the earlier designs, time.

K2 is ``csrc/residual_rows.cu`` (``warp_tangents``, ``blur_rows``), K3
``csrc/normal_equations.cu`` (``normal_equations``), K5
``csrc/frame_layout.cu`` (the patch layout, ``prepare_frame_layout``, on
every path) and K4 ``csrc/image_bilinear.cu`` (the direct path's
whole-image sampler, ``image_bilinear_lk``); their plain versions are in
``ops/residual.py`` and ``ops/image.py``. K4 and K5 equal their plain
versions bit for bit (:data:`BIT_EQUAL_PLAIN`). K2 and K3 keep an earlier
design beside the one the tracker launches (:data:`EARLIER`): ``warp_tangents`` the old path, the
torch chain of the pose Jacobian (``virtual_poses_and_tangents``) feeding
the thread design (``warp_tangents_threads_cuda``, the sweep row), held to
the kernel within :data:`TOLERANCE`; ``blur_rows`` and
``normal_equations`` one thread a row and two launches, equal to the
kernel bit for bit (:data:`BIT_EQUAL`). :func:`record_residual_calls`
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
    beside it K1 at N = 1 with the whole image as one window. No single
    PyTorch call computes K2's or K5's functions (``library_ms`` None).

:func:`time_layouts` times K3's two cluster layouts (:data:`K3_LAYOUTS`),
between which its rule chooses by the rows, on the same calls, each held
to the earlier design bit for bit.

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
# ops/cuda_residual.py: for warp_tangents the old path (the torch chain of
# the pose Jacobian, then the thread design); those of BIT_EQUAL give the
# kernel's bits
EARLIER = {"warp_tangents": "warp_tangents_threads_cuda",
           "blur_rows": "blur_rows_threads_cuda",
           "normal_equations": "normal_equations_split_cuda"}
BIT_EQUAL = ("blur_rows", "normal_equations")


def earlier_fn(kernel: str):
    """The earlier design of ``kernel`` (None where it has none), taking the
    dispatcher's arguments."""
    from ..ops import cuda_residual

    if kernel not in EARLIER:
        return None
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


def _grid_sample_yardstick(call: ResidualCall):
    """``grid_sample`` of the three planes (stacked once, outside) at the
    call's positions, normalised for ``align_corners=True``, as a function
    of no arguments."""
    import torch.nn.functional as tnf

    img, grad, loc = call.args[:3]
    H, W = img.shape
    planes = torch.stack([img, grad[..., 0], grad[..., 1]])[None]          # [1, 3, H, W]
    scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], dtype=loc.dtype, device=loc.device)
    grid = (loc * scale - 1.0)[None]                                        # [1, N, S, 2]
    return lambda: tnf.grid_sample(planes, grid, mode="bilinear", padding_mode="zeros",
                                   align_corners=True)


def _k1_whole_image(call: ResidualCall):
    """K1 at N = 1, the whole image's three planes as one window (stacked
    once, outside), at the call's N S positions, as a function of no
    arguments (a yardstick; it counts K1 launches)."""
    from ..ops import cuda_sampling

    img, grad, loc = call.args[:3]
    planes = torch.stack([img, grad[..., 0], grad[..., 1]])[None].contiguous()
    xy = loc.reshape(1, -1, 2).contiguous()
    ones = torch.ones(xy.shape[:2], dtype=loc.dtype, device=loc.device)
    return lambda: cuda_sampling.window_bilinear_cuda(planes, xy, ones)


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
    the chain's outputs) and the plain version timed on the kernel's
    recorded ``calls`` (see the module docstring); returns one dict for
    each, the kernel's first, the earlier design's second, the plain
    version's last."""
    if not torch.cuda.is_available():
        raise RuntimeError("timing the residual stage's kernels needs a CUDA device")
    kernel = calls[0].kernel
    warm_calls = calls[:50]
    bounds = [bound_ms(c) for c in warm_calls]
    b_ms = statistics.fmean(b for b, _ in bounds)
    b_by = max(("bytes", "operations"), key=[by for _, by in bounds].count)
    lib = k1_n1 = None
    if kernel == "normal_equations" and calls[0].args[1] is not None:
        lib = _cublas_yardstick(calls[0])
    elif kernel == "image_bilinear_lk":
        lib, k1_n1 = _grid_sample_yardstick(calls[0]), _k1_whole_image(calls[0])
    designs = [("kernel", kernel_fn(kernel), [c.args for c in warm_calls]),
               ("earlier", earlier_fn(kernel), [c.args for c in warm_calls])]
    if kernel == "warp_tangents":
        # the thread design alone, on the chain's outputs (computed here,
        # outside the timing)
        designs.append(("earlier kernel", kernel_fn("warp_tangents_threads"),
                        [chain_args(c) for c in warm_calls]))
    designs.append(("plain", plain_fn(kernel), [c.args for c in warm_calls]))
    rows = []
    for name, fn, args in designs:
        if fn is None:
            continue
        first = args[0]
        ms = kv.time_ms(lambda: fn(*first), reps, inner)
        w_inner = len(warm_calls) * math.ceil(50 / len(warm_calls))
        warm = kv.device_ms([lambda a=a: fn(*a) for a in args], 20, w_inner)
        cold = kv.device_flushed_ms(lambda: fn(*first), 20, 20)
        rows.append(dict(inputs=label, kernel=kernel, name=name, calls=len(calls),
                         D=calls[0].tangents, dtype=str(calls[0].dtype).split(".")[-1],
                         ms=ms, device_ms=warm, device_cold_ms=cold, bound_ms=b_ms,
                         bound_by=b_by))
    if lib is not None:
        rows[0].update(library_ms=kv.time_ms(lib, reps, inner),
                       library_device_ms=kv.device_ms([lib], 20, 50),
                       library_device_cold_ms=kv.device_flushed_ms(lib, 20, 20))
    else:
        rows[0].update(library_ms=None, library_device_ms=None, library_device_cold_ms=None)
    if k1_n1 is not None:
        rows[0].update(k1_n1_ms=kv.time_ms(k1_n1, reps, inner),
                       k1_n1_device_ms=kv.device_ms([k1_n1], 20, 50),
                       k1_n1_device_cold_ms=kv.device_flushed_ms(k1_n1, 20, 20))

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


def main(argv=None) -> int:
    """Record the bench scenario's K2/K3 calls (16 frames of track_frame,
    f32; one joint chunk at degree 4), hold each against the plain version
    and the earlier design, and time every kernel (``--layouts``: K3's
    layout sweep)."""
    layouts = "--layouts" in (sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("residual_kernels: needs one CUDA GPU", file=sys.stderr)
        return 1
    import chip_smoke as smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    print(kv.card_line())
    img, traj, frames = smoke.make_scenario("cuda", smoke.LONG_FRAMES)
    recorded = smoke.record_tracker_calls(img, traj, frames)[1]
    smoke.hold_residual_calls(recorded)
    for label, by_kernel in recorded.items():
        for kernel, calls in by_kernel.items():
            if not layouts:
                time_rows(label, full_calls(calls), out=print)
            elif kernel == "normal_equations":
                time_layouts(label, full_calls(calls), out=print)
    return 0


if __name__ == "__main__":
    sys.exit(main())
