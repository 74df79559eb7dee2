"""The port's ops/window_sampling.py (the module that holds kernel K1)
against the JAX package on the CPU, in float64.

On CPU tensors ``window_bilinear`` runs the plain PyTorch version, so these
tests pin that version to JAX's ``window_bilinear_xla`` and to the Pallas
kernel in interpret mode, and pin the semantics the CUDA kernel must keep
(each case below is one of them). The kernel itself is held against the
plain version on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mba_vo_tpu.ops import window_sampling as jws
from mba_vo_tpu.ops.image import image_gradients as jgrad
from mba_vo_tpu.ops.pallas_sampling import pallas_window_bilinear
from mba_vo_tpu_torch.ops import cuda_sampling
from mba_vo_tpu_torch.ops import window_sampling as tws
from mba_vo_tpu_torch.ops.image import image_gradients as tgrad

from torch_port_common import npy, smooth_texture, t64

# sums of at most four non-zero products each: agreement to rounding
TOL = 1e-12


def problem(n, c, win_h, win_w, s, seed=0):
    rng = np.random.default_rng(seed)
    windows = rng.normal(0, 50.0, (n, c, win_h, win_w))
    # coordinates deliberately spill past the window on every side
    xy = np.stack([rng.uniform(-3, win_w + 2, (n, s)),
                   rng.uniform(-3, win_h + 2, (n, s))], axis=-1)
    valid = rng.integers(0, 2, (n, s)).astype(np.float64)
    return windows, xy, valid


def port(windows, xy, valid):
    return npy(tws.window_bilinear(t64(windows), t64(xy), t64(valid)))


@pytest.mark.parametrize("n,c,win_h,win_w,s", [
    (16, 3, 32, 32, 40),   # the tracker's shape (N cut from 512)
    (16, 1, 32, 32, 40),   # the cost-only call
    (9, 3, 20, 32, 17),    # rectangular: a level shorter than the window
    (5, 3, 32, 12, 8),     # rectangular the other way
])
def test_plain_matches_xla(n, c, win_h, win_w, s):
    w, xy, v = problem(n, c, win_h, win_w, s, seed=n + c)
    want = jws.window_bilinear_xla(jnp.asarray(w), jnp.asarray(xy), jnp.asarray(v))
    np.testing.assert_allclose(port(w, xy, v), np.asarray(want), atol=TOL, rtol=0)


@pytest.mark.parametrize("n,c,s", [(32, 3, 40), (7, 1, 12)])
def test_plain_matches_pallas_interpret(n, c, s):
    w, xy, v = problem(n, c, 32, 32, s, seed=3)
    want = pallas_window_bilinear(jnp.asarray(w), jnp.asarray(xy), jnp.asarray(v),
                                  interpret=True)
    np.testing.assert_allclose(port(w, xy, v), np.asarray(want), atol=TOL, rtol=0)


def _one_window(win_h=4, win_w=5):
    w = np.arange(1.0, 1.0 + win_h * win_w).reshape(1, 1, win_h, win_w)
    return w


def _sample(w, pts, valid=None):
    pts = np.asarray(pts, np.float64)[None]
    valid = np.ones(pts.shape[:2]) if valid is None else np.asarray(valid)[None]
    out = port(w, pts, valid)[0, 0]
    ref = np.asarray(jws.window_bilinear_xla(jnp.asarray(w), jnp.asarray(pts),
                                             jnp.asarray(valid)))[0, 0]
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_allclose(out, ref, atol=TOL, rtol=0)
    return out


def test_tap_outside_window_is_zero_not_clamped():
    """x = -0.5 takes half of column 0 (the -1 column adds nothing); a
    coordinate at least 1 px beyond the window gives exactly 0."""
    w = _one_window()
    out = _sample(w, [[-0.5, 0.0], [4.5, 3.0], [0.0, -0.5], [-1.0, 1.0],
                      [5.0, 1.0], [2.0, 4.0], [-7.0, 2.0], [1.0, 40.0]])
    assert out[0] == pytest.approx(0.5 * w[0, 0, 0, 0])
    assert out[1] == pytest.approx(0.5 * w[0, 0, 3, 4])
    assert out[2] == pytest.approx(0.5 * w[0, 0, 0, 0])
    np.testing.assert_array_equal(out[3:], 0.0)


def test_integer_coordinates_read_one_pixel():
    w = _one_window()
    ys, xs = np.mgrid[0:4, 0:5]
    out = _sample(w, np.stack([xs.ravel(), ys.ravel()], -1).astype(np.float64))
    np.testing.assert_array_equal(out, w.ravel())


def test_rectangular_window_axes():
    """win_h != win_w: x runs along the last axis, y along the rows."""
    w = _one_window(3, 7)
    out = _sample(w, [[6.0, 0.0], [0.0, 2.0], [6.0, 2.0], [6.5, 2.0], [0.0, 2.5]])
    np.testing.assert_allclose(out, [7.0, 15.0, 21.0, 0.5 * 21.0, 0.5 * 15.0])


def test_valid_multiplies_the_output():
    w = _one_window()
    out = _sample(w, [[1.25, 1.5], [1.25, 1.5], [2.0, 2.0]], valid=[1.0, 0.0, 0.0])
    assert out[0] != 0.0
    np.testing.assert_array_equal(out[1:], 0.0)


def test_nan_coordinate_gives_nan_even_where_invalid():
    """NaN reaches the cost, which is what stats_healthy watches for."""
    w = _one_window()
    out = _sample(w, [[np.nan, 1.0], [1.0, np.nan], [np.nan, 1.0], [1.0, 1.0]],
                  valid=[1.0, 1.0, 0.0, 1.0])
    assert np.isnan(out[:3]).all() and np.isfinite(out[3])


def test_sums_y_first_then_x():
    """out = sum_j (sum_i W[i, j] wy[i]) wx[j], the association of
    window_bilinear_xla, checked with values where the order is visible in
    float64 rounding."""
    w = np.array([[[[1e16, 1.0], [-1e16, 3.0]]]])
    out = _sample(w, [[0.3, 0.5]])
    hat = lambda d: max(0.0, 1.0 - abs(d))  # noqa: E731
    wy, wx = [hat(0.5), hat(0.5 - 1)], [hat(0.3), hat(0.3 - 1)]
    a = w[0, 0, 0] * wy[0] + w[0, 0, 1] * wy[1]
    assert out[0] == a[0] * wx[0] + a[1] * wx[1]
    # x first loses the small terms against 1e16
    b = w[0, 0, :, 0] * wx[0] + w[0, 0, :, 1] * wx[1]
    assert out[0] != b[0] * wy[0] + b[1] * wy[1]


def test_window_bilinear_on_cpu_runs_plain_and_launches_nothing():
    w, xy, v = problem(4, 3, 8, 8, 6)
    before = cuda_sampling.LAUNCHES
    out = tws.window_bilinear(t64(w), t64(xy), t64(v))
    assert cuda_sampling.LAUNCHES == before
    np.testing.assert_array_equal(
        npy(out), npy(tws.window_bilinear_plain(t64(w), t64(xy), t64(v))))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: a CPU tensor is an error."""
    w, xy, v = problem(2, 1, 8, 8, 3)
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_sampling.window_bilinear_cuda(t64(w), t64(xy), t64(v))


# --------------------------------------------------------- extract_windows


@pytest.mark.parametrize("h,w,win", [
    (40, 48, 16),    # interior and border centres
    (40, 48, 32),
    (24, 30, 32),    # a level smaller than the window: the window is the level
    (40, 20, 32),    # narrower than the window only
])
def test_extract_windows(h, w, win):
    img = smooth_texture(h, w, seed=h)
    chans_j = jws.stack_image_channels(jnp.asarray(img), jgrad(jnp.asarray(img)))
    chans_t = tws.stack_image_channels(t64(img), tgrad(t64(img)))
    rng = np.random.default_rng(w)
    centers = np.concatenate([
        rng.uniform(0, [w - 1, h - 1], (6, 2)),
        [[0.0, 0.0], [w - 1.0, h - 1.0], [0.2, h - 0.6], [w - 0.5, 3.7]],
        # far outside the image: the start clamps instead of reading past it
        [[-50.0, 10.0], [w + 80.0, -30.0], [7.0, h + 99.0]],
    ])
    wj, sj = jws.extract_windows(chans_j, jnp.asarray(centers), win)
    wt, st = tws.extract_windows(chans_t, t64(centers), win)
    assert tuple(wt.shape) == (len(centers), 3, min(win, h), min(win, w))
    np.testing.assert_array_equal(npy(st), np.asarray(sj))
    np.testing.assert_array_equal(npy(wt), np.asarray(wj))


# ------------------------------------------------------- the LK derivative


def test_lk_tangent_matches_jax_jvp():
    """The port writes sample_windows_lk's custom JVP out: value and the two
    gradient channels from one C = 3 call, tangent = d/dx * dx + d/dy * dy."""
    img = smooth_texture(40, 48, seed=3)
    chans = jws.stack_image_channels(jnp.asarray(img), jgrad(jnp.asarray(img)))
    windows, starts = jws.extract_windows(chans, jnp.asarray([[20.0, 18.0], [9.0, 30.0]]), 16)
    rng = np.random.default_rng(8)
    loc = rng.uniform(-1.5, 16.5, (2, 11, 2))
    valid = rng.integers(0, 2, (2, 11)).astype(np.float64)
    dloc = rng.normal(0, 1, (2, 11, 2))
    val_j, tan_j = jax.jvp(
        lambda p: jws.sample_windows_lk(windows, p, jnp.asarray(valid)),
        (jnp.asarray(loc),), (jnp.asarray(dloc),))
    val, gx, gy = tws.sample_windows_lk(t64(windows), t64(loc), t64(valid))
    np.testing.assert_allclose(npy(val), np.asarray(val_j), atol=TOL, rtol=0)
    tan = gx * t64(dloc[..., 0]) + gy * t64(dloc[..., 1])
    np.testing.assert_allclose(npy(tan), np.asarray(tan_j), atol=TOL, rtol=0)
    # the cost-only call (C = 1) gives the same values
    np.testing.assert_allclose(
        npy(tws.sample_windows(t64(windows), t64(loc), t64(valid))), npy(val),
        atol=TOL, rtol=0)
