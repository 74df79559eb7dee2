"""How torch orders the patch layout's pose arithmetic on one NVIDIA GPU, so
that K5 (``csrc/frame_layout.cu``) can take the same order.

K5's pixels must equal the plain layout's bit for bit, and from a standing
start the anchors they floor are integers up to the last bit: the mid pose
must be the one ``sample_virtual_poses`` computes on the card, to the bit.
Two of its steps have an order that the card's torch chooses:

  * ``virtual_pose_times`` divides a tensor by a Python float: the probe
    compares the card's result with a true division and with a product by
    the divisor's reciprocal (rounded in the tensor's type), for V = 3, 4,
    5 and 9, in float32 and float64;
  * ``spline_interp_t``'s einsum sums a pose's translation over its
    ``degree`` knots: the probe compares the card's sum (at the layout's
    batch of F V poses) with candidate orders computed exactly on the host
    (``fractions.Fraction``, each rounding to float64 done once):
    products rounded and added in order, a fused multiply-add chain from
    the first product, the same chains from the last term, pairwise, and
    at degree 4 two fused chains over the even and the odd taps then their
    sum (``csrc/spline_pose.cuh``'s ``einsum_tap_sum`` takes the order that
    matches).

Then it holds K5's anchors (``ops.cuda_layout.frame_layout_cuda`` with
``anchors=True``) against the plain version's on the card, moving and from
a standing start, degrees 2 and 4, float32 and float64, and prints the
entries that differ; and, for a capture far past the spline's end
(:func:`probe_extrapolation`), both K5 designs' anchors against the plain
version's and the extrapolated translation against the candidate orders
in float32. Run from the repository's root:

    python3 -m mba_vo_tpu_torch.experiments.pose_order

Requires CUDA and raises without it.
"""

from __future__ import annotations

import sys
from fractions import Fraction

import numpy as np
import torch

from .kernel_variants import card_line


def _fma(a: float, b: float, c: float) -> float:
    """a b + c rounded once to float64."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _candidates(w, x):
    """Candidate float64 sums of w[j] x[j] over j, by name."""
    n = len(w)
    p = [float(Fraction(w[j]) * Fraction(x[j])) for j in range(n)]
    seq = p[0]
    for j in range(1, n):
        seq = seq + p[j]
    fma = p[0]
    for j in range(1, n):
        fma = _fma(w[j], x[j], fma)
    rseq = p[-1]
    for j in range(n - 2, -1, -1):
        rseq = rseq + p[j]
    rfma = p[-1]
    for j in range(n - 2, -1, -1):
        rfma = _fma(w[j], x[j], rfma)
    out = dict(products_in_order=seq, fma_chain=fma, products_reversed=rseq,
               fma_chain_reversed=rfma)
    if n == 4:
        out["pairwise"] = (p[0] + p[1]) + (p[2] + p[3])
        out["pairwise_fma"] = _fma(w[1], x[1], p[0]) + _fma(w[3], x[3], p[2])
        out["even_odd_fma"] = _fma(w[2], x[2], p[0]) + _fma(w[3], x[3], p[1])
    return out


def probe_division(out=print) -> dict:
    """The card's ``tensor / float`` against a true division and a product
    by the reciprocal: unequal entries of each, by dtype and V."""
    res = {}
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.float64):
        e = torch.tensor(rng.uniform(0.005, 0.06, 4096), dtype=dtype, device="cuda")
        for V in (3, 4, 5, 9):
            div = V - 1 + 1e-8
            v = torch.arange(V, dtype=dtype, device="cuda")
            card = v[None] * e[:, None] / div
            true = (v[None] * e[:, None]) / torch.tensor(div, dtype=dtype, device="cuda")
            np_t = np.float32 if dtype == torch.float32 else np.float64
            inv = (v[None] * e[:, None]) * float(np_t(1.0) / np_t(div))
            got = dict(true_division=int((card != true).sum()),
                       reciprocal_product=int((card != inv).sum()))
            res[str(dtype).split(".")[-1], V] = got
            out(f"virtual_pose_times' v e / {div!r} on the card, {dtype}, V = {V}: entries "
                f"unequal to a true division {got['true_division']}, to a product by the "
                f"reciprocal {got['reciprocal_product']} (of {card.numel()})")
    return res


def probe_translation(out=print) -> dict:
    """The card's einsum of a pose's translation against the candidate
    orders, float64, at the layout's batches: unequal entries of each."""
    res = {}
    rng = np.random.default_rng(1)
    for degree in (2, 4):
        for T in (5, 20, 40):
            w = rng.uniform(-0.2, 1.2, (T, degree))
            x = rng.normal(0, 0.3, (T, degree, 3))
            card = torch.einsum("...k,...ki->...i", torch.tensor(w, device="cuda"),
                                torch.tensor(x, device="cuda")).cpu().numpy()
            bad = {}
            for t in range(T):
                for i in range(3):
                    for name, val in _candidates(list(w[t]), list(x[t, :, i])).items():
                        bad[name] = bad.get(name, 0) + (val != card[t, i])
            res[degree, T] = bad
            out(f"spline_interp_t's einsum on the card, float64, degree {degree}, {T} poses: "
                f"entries unequal to each candidate order (of {3 * T}): "
                + ", ".join(f"{k} {v}" for k, v in bad.items()))
    return res


def probe_anchors(out=print) -> dict:
    """K5's anchors against the plain version's on the card: entries that
    differ, by case."""
    from ..core.spline import make_knots
    from ..ops import cuda_layout
    from ..ops import residual as tres
    from ..tracker.patterns import PATTERNS

    res = {}
    H, W, N = 480, 640, 512
    for dtype in (torch.float32, torch.float64):
        for degree, K, F, V in ((2, 2, 1, 5), (4, 7, 4, 5), (4, 11, 8, 4), (2, 3, 2, 3)):
            for standing in (False, True):
                rng = np.random.default_rng(K + F)
                t = np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0)
                q = np.concatenate([rng.normal(0, 0.02, (K, 3)), np.ones((K, 1))], axis=1)
                q /= np.linalg.norm(q, axis=1, keepdims=True)
                kp = rng.uniform(0, [W, H], (N, 2))
                if standing:
                    t, q, kp = np.zeros((K, 3)), np.tile([0.0, 0, 0, 1], (K, 1)), np.floor(kp)
                c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
                knots = make_knots(c(t), c(q), 0.05, 0.1)
                knots = knots._replace(t0=knots.t0.cuda(), dt=knots.dt.cuda())
                caps = c(0.05 + 0.1 * (degree - 1) / 2
                         + np.sort(rng.uniform(0, 0.1 * (K - degree + 0.5), F)))
                exps = c(np.full(F, 0.03))
                kp_t, z = c(kp), c(rng.uniform(1.5, 2.5, N))
                Kv = c([480.0, 480.0, (W - 1) / 2, (H - 1) / 2])
                pt, pq = tres.sample_virtual_poses(knots, caps, exps, V, degree)
                ref = tres.patch_anchors(pt[:, V // 2], pq[:, V // 2], kp_t, z, Kv)
                got = cuda_layout.frame_layout_cuda(
                    knots, caps, exps, V, degree, kp_t, z, torch.ones_like(z), Kv,
                    torch.as_tensor(PATTERNS["dso8"](), device="cuda"),
                    torch.zeros((F, H, W), dtype=dtype, device="cuda"), H, W, anchors=True)[3]
                bad = got != ref
                label = (f"{str(dtype).split('.')[-1]}, degree {degree}, {K} knots, F = {F}, "
                         f"V = {V}, {'standing' if standing else 'moving'}")
                res[label] = int(bad.sum())
                floors = int((torch.floor(got) != torch.floor(ref)).sum())
                out(f"K5 anchors against the plain version's on the card, {label}: "
                    f"{int(bad.sum())} of {bad.numel()} differ (largest "
                    f"{float((got - ref).abs().max()):.3e}), {floors} floors differ")
    return res


def _f32_candidates(w, x) -> dict:
    """:func:`_candidates`' orders in float32: each product and each fused
    multiply-add computed exactly, then rounded to float32."""
    f32 = np.float32

    def fma(a, b, c):
        return f32(float(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))))

    def add(a, b):
        return f32(float(Fraction(float(a)) + Fraction(float(b))))

    p = [f32(float(Fraction(float(w[j])) * Fraction(float(x[j])))) for j in range(len(w))]
    chain, seq, rchain = p[0], p[0], p[-1]
    for j in range(1, len(w)):
        chain, seq = fma(w[j], x[j], chain), add(seq, p[j])
    for j in range(len(w) - 2, -1, -1):
        rchain = fma(w[j], x[j], rchain)
    return dict(fma_chain=chain, products_in_order=seq, fma_chain_reversed=rchain)


def probe_extrapolation(out=print) -> dict:
    """A capture 4.5 knot intervals past the spline's end (the card tests'
    "clamped" problem of tests/test_torch_cuda.py::_layout_problem, seed 0,
    degree 4, F = 8, V = 5, 512 keypoints; its last frame extrapolates with
    basis weights of -7 to 33): the extrapolated frame's translation against
    the candidate orders in float32, and K5's anchors (both designs) against
    the plain version's (the entries that differ, and the largest distance
    in units of the plain anchor's last place) and against the plain
    version's with the translation taken in the kernels' order, by knot
    count and dtype."""
    from ..core.spline import _vec_basis, make_knots, spline_segment_start_and_u
    from ..core.spline import virtual_pose_times
    from ..ops import cuda_layout
    from ..ops import residual as tres
    from ..tracker.patterns import PATTERNS

    res = {}
    H, W, N, F, V, degree = 480, 640, 512, 8, 5, 4
    for K in (27, 64):
        for dtype in (torch.float32, torch.float64):
            # the draws of _layout_problem(K, 4, 8, 5, dtype, "clamped"), in its order
            rng = np.random.default_rng(0)
            t = np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0)
            q = np.concatenate([rng.normal(0, 0.02, (K, 3)), np.ones((K, 1))], axis=1)
            q /= np.linalg.norm(q, axis=1, keepdims=True)
            kp = rng.uniform([-3, -3], [W + 3, H + 3], (N, 2))
            caps = 0.05 + 0.1 * (degree - 1) / 2 + np.sort(
                rng.uniform(0, 0.1 * (K - degree + 0.5), F))
            caps[-1] = 0.05 + 0.1 * (K + 0.5)
            rng.uniform(0, 255, (F, H, W))                      # the current frames
            z = rng.uniform(1.5, 2.5, N)
            c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
            knots = make_knots(c(t), c(q), 0.05, 0.1)
            knots = knots._replace(t0=knots.t0.cuda(), dt=knots.dt.cuda())
            caps_t, exps = c(caps), c(np.full(F, 0.03))
            kp_t, z_t = c(kp), c(z)
            Kv = c([480.0, 480.0, (W - 1) / 2, (H - 1) / 2])
            pt, pq = tres.sample_virtual_poses(knots, caps_t, exps, V, degree)
            ref = tres.patch_anchors(pt[:, V // 2], pq[:, V // 2], kp_t, z_t, Kv)
            args = (knots, caps_t, exps, V, degree, kp_t, z_t, torch.ones_like(z_t), Kv,
                    torch.as_tensor(PATTERNS["dso8"](), device="cuda"),
                    torch.zeros((F, H, W), dtype=dtype, device="cuda"), H, W)
            staged = cuda_layout.frame_layout_cuda(*args, anchors=True)[3]
            serial = cuda_layout.frame_layout_serial_cuda(*args, anchors=True)[3]
            label = f"{K} knots, {str(dtype).split('.')[-1]}"
            ulp = torch.nextafter(ref, torch.full_like(ref, float("inf"))) - ref
            got = dict(staged_vs_plain=int((staged != ref).sum()),
                       serial_vs_plain=int((serial != ref).sum()),
                       staged_vs_serial=int((staged != serial).sum()),
                       staged_vs_plain_max_ulps=float(((staged - ref).abs() / ulp).max()))
            if dtype == torch.float32:
                times = virtual_pose_times(caps_t, exps, V).reshape(-1)
                idx, u = spline_segment_start_and_u(times, knots.t0, knots.dt, K, degree)
                m = (F - 1) * V + V // 2
                w = _vec_basis(u, degree)[m].cpu().numpy()
                x = knots.t[idx[m] + torch.arange(degree, device="cuda")].cpu().numpy()
                orders = {}
                for i in range(3):
                    for name, val in _f32_candidates(w, x[:, i]).items():
                        orders[name] = orders.get(name, 0) + int(val == np.float32(
                            float(pt[F - 1, V // 2, i])))
                got["translation_components_equal_to"] = orders
                tt = pt[:, V // 2].clone()
                tt[F - 1] = torch.tensor([_f32_candidates(w, x[:, i])["fma_chain"]
                                          for i in range(3)], dtype=dtype, device="cuda")
                alt = tres.patch_anchors(tt, pq[:, V // 2], kp_t, z_t, Kv)
                got["staged_vs_plain_with_the_fma_chain"] = int((staged != alt).sum())
                got["differing_frames"] = sorted({int(f) for f in torch.nonzero(
                    (staged != ref).any(-1))[:, 0]})
            res[label] = got
            out(f"K5 anchors, a capture 4.5 knot intervals past the spline's end, {label} "
                f"(degree 4, F = 8, {N * F} anchors of 2): " + ", ".join(
                    f"{k} {v}" for k, v in got.items()))
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("pose_order: needs one CUDA GPU", file=sys.stderr)
        return 1
    print(card_line())
    probe_division()
    probe_translation()
    probe_anchors()
    probe_extrapolation()
    return 0


if __name__ == "__main__":
    sys.exit(main())
