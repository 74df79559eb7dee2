"""How near K6's step and the library's come to the exact step, on the CPU.

K6 solves the damped normal equations H1 x = g by its own Cholesky order
and one step of refinement (``residual_kernels.lm_step_kernel_order``, to
which the card holds K6 bit for bit); the plain stage ``lm_step_plain``
solves with the library (``cholesky_ex`` + ``cholesky_solve``). In float32
the two differ by ~1e-4 of the step's norm on the tracker's H1. Here each
is held against x64, a float64 solve of the same H1 and g cast up, on the
float32 H1s an LM level on the CPU gives (``record_lm_calls``): the
library's step within 3 D kappa_2(H1) u, u = 2^-24, the forward error a
backward-stable Cholesky solve allows, and K6's refined step within
kappa_2(H1) u, with no factor D (``residual_kernels.step_forward_errors``).
A bound of 1 or more is met by any step, so a call under one is reported
unchecked, not held (``forward_verdicts``). ``chip_smoke.py`` phases 3 and
4 do the same on the card's recorded calls, both designs of K6 included.
"""

import numpy as np
import pytest
import torch

from mba_vo_tpu_torch.core.spline import make_knots
from mba_vo_tpu_torch.data.synthetic import synthesize_blurred_image
from mba_vo_tpu_torch.experiments import residual_kernels as rk
from mba_vo_tpu_torch.ops.image import image_gradients
from mba_vo_tpu_torch.ops.residual import TrackingLevelData
from mba_vo_tpu_torch.solver import lm as tlm
from mba_vo_tpu_torch.tracker.patterns import PATTERNS

from torch_port_common import DEPTH, EXPOSURE, H, KVEC, W, knots_arrays, level_arrays


def _f32_level(seed: int):
    """A float32 level on the CPU: one knot segment spanning the exposure
    (tests/test_torch_lm_kernels.py's level), the frame rendered from a
    known spline, the LM started off by a shift."""
    t_true, q_true, t0, dt = knots_arrays(seed=21, t0=0.1 - EXPOSURE / 2, dt=EXPOSURE)
    a = level_arrays(seed=seed, n_kp=40, dead=4, border=False)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    img = (128.0 + 60.0 * np.sin(xs / 7.0) * np.cos(ys / 9.0)
           + 40.0 * np.sin(xs / 13.0 + ys / 11.0))
    truth = make_knots(torch.tensor(t_true), torch.tensor(q_true), t0, dt)
    cur = synthesize_blurred_image(torch.tensor(img), truth, 2, float(a["cap_times"][0]),
                                   EXPOSURE, 5, DEPTH, torch.tensor(KVEC)).numpy()[None]
    cur = cur + np.random.default_rng(23).normal(0, 1.0, cur.shape)
    t = t_true + np.array([4e-3, -3e-3, 5e-3])
    q = q_true
    f32 = lambda x: torch.tensor(np.asarray(x), dtype=torch.float32)   # noqa: E731
    img_t = f32(img)
    data = TrackingLevelData(
        img_ref=img_t, grad_ref=image_gradients(img_t), cur_imgs=f32(cur),
        cap_times=f32(a["cap_times"]), exp_times=f32(a["exp_times"]), kp_xy=f32(a["kp_xy"]),
        kp_z=torch.full((len(a["kp_z"]),), DEPTH, dtype=torch.float32),
        kp_mask=f32(a["kp_mask"]), pattern=torch.as_tensor(np.asarray(PATTERNS["dso8"]())),
        K=f32(KVEC))
    return make_knots(f32(t), f32(q), t0, dt), data


@pytest.mark.parametrize("seed", [9, 11, 13])
def test_both_steps_within_the_forward_error_bound(seed):
    """Every float32 H1 of an LM level on the CPU: K6's step (its order,
    refined once) within kappa_2(H1) u of x64 and the library's step within
    3 D kappa_2(H1) u, both bounds under 1 here, so checked; K6's step the
    nearer; the errors are printed."""
    knots, data = _f32_level(seed)
    with rk.record_lm_calls() as calls:
        tlm.optimize_level(knots, data, 5, 2, tlm.LMOptions(
            sampling="windowed", huber_a=10.0, min_abs_cost_decrease=1e-6))
    steps = calls["lm_step"]
    assert steps and all(c.dtype == torch.float32 for c in steps)
    for i, call in enumerate(steps):
        H1, lib_step, _, _, sc = tlm.lm_step_plain(*call.fresh())
        k6_step, _ = rk.lm_step_kernel_order(H1, call.args[1])
        errs, kappa, bounds = rk.step_forward_errors(
            H1, call.args[1], {"K6": k6_step, "library": lib_step}, refined=("K6",))
        print(f"call {i} (D = {H1.shape[0]}): kappa_2 {kappa:.3e}, K6 {errs['K6']:.3e} "
              f"(bound {bounds['K6']:.3e}), library {errs['library']:.3e} "
              f"(bound {bounds['library']:.3e})")
        verdicts = rk.forward_verdicts(f"call {i}", errs, bounds)
        assert verdicts == {"K6": "held", "library": "held"}, (i, errs, bounds)
        assert errs["K6"] < errs["library"], (i, errs)


def _ill_conditioned(D=42, seed=3):
    """A float32 SPD H1 with kappa_2 ~ 1e6 and its library and K6 steps
    (no damping: H1 is H)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(0, 1, (D, D)))
    H64 = (Q * np.logspace(0, -6, D)) @ Q.T
    H1 = torch.tensor((H64 + H64.T) / 2, dtype=torch.float32)
    g = torch.tensor(rng.normal(0, 1, D), dtype=torch.float32)
    sc = torch.zeros(tlm.S_SIZE, dtype=torch.float32)
    sc[tlm.S_RADIUS] = 1e30
    t = torch.zeros(D // 6, 3)
    q = torch.tensor([[0.0, 0.0, 0.0, 1.0]]).repeat(D // 6, 1)
    _, lib_step, _, _, _ = tlm.lm_step_plain(H1, g, sc, t, q)
    k6_step, _ = rk.lm_step_kernel_order(H1, g)
    return H1, g, lib_step, k6_step


def test_forward_error_of_an_ill_conditioned_system():
    """A float32 SPD H1 with kappa_2 ~ 1e6 (D = 42): K6's refined step
    within kappa_2 u (~0.06) of x64 and nearer than the library's; the
    library's bound, 3 D kappa_2 u ~ 7.5, is 1 or more, which any step
    meets, so its step is reported unchecked, not held."""
    H1, g, lib_step, k6_step = _ill_conditioned()
    errs, kappa, bounds = rk.step_forward_errors(H1, g, {"K6": k6_step, "library": lib_step},
                                                 refined=("K6",))
    assert 1e5 < kappa < 1e7
    print(f"kappa_2 {kappa:.3e}, K6 {errs['K6']:.3e} (bound {bounds['K6']:.3e}), library "
          f"{errs['library']:.3e} (bound {bounds['library']:.3e})")
    assert bounds["K6"] < 1.0 <= bounds["library"]
    assert rk.forward_verdicts("ill-conditioned", errs, bounds) == {
        "K6": "held", "library": "unchecked"}
    assert 0 < errs["K6"] < errs["library"]


@pytest.mark.parametrize("wrong", ["zero", "scaled by 1.1", "library, unrefined"])
def test_a_wrong_step_fails_the_refined_bound(wrong):
    """The check that holds K6's refined step can fail: on the
    ill-conditioned system (kappa_2 u ~ 0.06) a zero step (error 1) and
    K6's step scaled by 1.1 (error 0.1) are over kappa_2 u and raise. The
    library's unrefined step (error ~1.5e-3) is within it: the bound
    catches a wrong step, not a solve left unrefined."""
    H1, g, lib_step, k6_step = _ill_conditioned()
    step = {"zero": torch.zeros_like(k6_step), "scaled by 1.1": 1.1 * k6_step,
            "library, unrefined": lib_step}[wrong]
    errs, _, bounds = rk.step_forward_errors(H1, g, {"step": step}, refined=("step",))
    if wrong == "library, unrefined":
        assert rk.forward_verdicts(wrong, errs, bounds) == {"step": "held"}
        return
    with pytest.raises(AssertionError, match="over its bound"):
        rk.forward_verdicts(wrong, errs, bounds)
