"""The port's ops/image.py, ops/warp.py and data/synthetic.py against the
JAX package, float64 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core import lie as jlie
from mba_vo_tpu.data import synthetic as jsyn
from mba_vo_tpu.ops import image as jim
from mba_vo_tpu.ops import warp as jwarp
from mba_vo_tpu_torch.data import synthetic as tsyn
from mba_vo_tpu_torch.ops import image as tim
from mba_vo_tpu_torch.ops import warp as twarp

from torch_port_common import KVEC, knots_arrays, knots_pair, npy, random_quats, smooth_texture, t64

TOL = 1e-12


@pytest.mark.parametrize("h,w", [(64, 80), (63, 81), (7, 5)])
def test_pyramid_drops_odd_row_and_column(h, w):
    """An exact 2x2 box per level. JAX's reduce_window may add the four
    taps in another order, so the levels agree to the last bit or two."""
    img = smooth_texture(h, w, seed=h)
    pj = jim.image_pyramid(jnp.asarray(img), 3)
    pt = tim.image_pyramid(t64(img), 3)
    for a, b in zip(pj, pt):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(npy(b), np.asarray(a), rtol=1e-15, atol=0)


def test_gradients_and_magnitude():
    img = smooth_texture(30, 41, seed=2)
    gj, gt = jim.image_gradients(jnp.asarray(img)), tim.image_gradients(t64(img))
    np.testing.assert_array_equal(npy(gt), np.asarray(gj))
    for border in (gt[0], gt[-1], gt[:, 0], gt[:, -1]):
        assert not border.any()
    np.testing.assert_allclose(npy(tim.gradient_magnitude(gt)),
                               np.asarray(jim.gradient_magnitude(gj)), atol=TOL, rtol=0)


def test_bilinear_sample_and_in_bounds():
    img = smooth_texture(20, 24, seed=5)
    rng = np.random.default_rng(0)
    xy = np.concatenate([rng.uniform(-2, 26, (40, 2)),
                         [[0.0, 0.0], [23.0, 19.0], [23.0, 19.5], [-1e9, 3.0], [np.inf, 2.0]]])
    np.testing.assert_allclose(npy(tim.bilinear_sample(t64(img), t64(xy))),
                               np.asarray(jim.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))),
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(npy(tim.in_bounds(t64(xy), 20, 24)),
                                  np.asarray(jim.in_bounds(jnp.asarray(xy), 20, 24)))


def _warp_inputs(seed=0, n=30):
    rng = np.random.default_rng(seed)
    t = rng.normal(0, 0.05, (n, 3))
    q = random_quats(rng, n, 0.05)
    z = rng.uniform(1.0, 3.0, n)
    xy = rng.uniform([0, 0], [79, 63], (n, 2))
    return t, q, z, xy


def test_unit_ray_and_frontoparallel_warp():
    t, q, z, xy = _warp_inputs()
    np.testing.assert_allclose(npy(twarp.unit_ray(t64(xy), t64(KVEC))),
                               np.asarray(jwarp.unit_ray(jnp.asarray(xy), jnp.asarray(KVEC))),
                               atol=TOL, rtol=0)
    got = twarp.frontoparallel_warp(t64(t), t64(q), t64(z), t64(KVEC), t64(xy))
    want = jwarp.frontoparallel_warp(*map(jnp.asarray, (t, q, z, KVEC, xy)))
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-10, rtol=0)


def test_frontoparallel_warp_jvp_matches_jax_jvp():
    """The warp's written-out forward derivative, for D pose tangents at once,
    against jax.jvp of the JAX warp one tangent at a time."""
    t, q, z, xy = _warp_inputs(seed=1, n=12)
    rng = np.random.default_rng(2)
    D = 4
    dt, dq = rng.normal(0, 1, (D, 12, 3)), rng.normal(0, 1, (D, 12, 4))
    ref, dref = twarp.frontoparallel_warp_jvp(t64(t), t64(q), t64(z), t64(KVEC), t64(xy),
                                              t64(dt), t64(dq))
    for d in range(D):
        val, tan = jax.jvp(
            lambda tt, qq: jwarp.frontoparallel_warp(tt, qq, jnp.asarray(z),
                                                     jnp.asarray(KVEC), jnp.asarray(xy)),
            (jnp.asarray(t), jnp.asarray(q)), (jnp.asarray(dt[d]), jnp.asarray(dq[d])))
        np.testing.assert_allclose(npy(ref), np.asarray(val), atol=1e-10, rtol=0)
        np.testing.assert_allclose(npy(dref[d]), np.asarray(tan), atol=1e-9, rtol=1e-12)


# ----------------------------------------------------------------- synthetic


@pytest.mark.parametrize("h,w", [(480, 640), (64, 80)])
def test_scene_images(h, w):
    np.testing.assert_array_equal(tsyn.shapes_image(h, w), jsyn.shapes_image(h, w))
    np.testing.assert_array_equal(tsyn.smooth_shapes_image(h, w),
                                  jsyn.smooth_shapes_image(h, w))
    img = np.random.default_rng(0).uniform(0, 255, (h, w))
    for axis in (0, 1):
        np.testing.assert_array_equal(tsyn._box_filter_1d(img, 2, axis),
                                      jsyn._box_filter_1d(img, 2, axis))


@pytest.mark.parametrize("quantize", [False, True])
def test_blurred_image_forward_model(quantize):
    img = smooth_texture(48, 56, seed=7)
    kj, kt = knots_pair(knots_arrays(seed=11, t0=0.0, dt=0.1))
    K = np.array([45.0, 45.0, 27.5, 23.5])
    synth = jax.jit(jsyn.synthesize_blurred_image, static_argnums=(2, 5),
                    static_argnames=("quantize",))
    want = synth(jnp.asarray(img), kj, 2, 0.05, 0.03, 5, 2.0, jnp.asarray(K), quantize=quantize)
    got = tsyn.synthesize_blurred_image(t64(img), kt, 2, 0.05, 0.03, 5, 2.0, t64(K),
                                        quantize=quantize)
    np.testing.assert_allclose(npy(got), np.asarray(want), atol=1e-9, rtol=0)
    q = jlie.quat_exp(jnp.asarray([0.01, -0.02, 0.005]))
    np.testing.assert_allclose(
        npy(tsyn.warp_image(t64(img), t64([0.01, 0.0, 0.02]), t64(q), 2.0, t64(K))),
        np.asarray(jsyn.warp_image(jnp.asarray(img), jnp.asarray([0.01, 0.0, 0.02]), q,
                                   2.0, jnp.asarray(K))),
        atol=1e-9, rtol=0)
    assert got.dtype == torch.float64
