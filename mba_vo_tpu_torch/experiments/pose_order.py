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
entries that differ. Run from the repository's root:

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


def main() -> int:
    if not torch.cuda.is_available():
        print("pose_order: needs one CUDA GPU", file=sys.stderr)
        return 1
    print(card_line())
    probe_division()
    probe_translation()
    probe_anchors()
    return 0


if __name__ == "__main__":
    sys.exit(main())
