"""The port's models/camera.py and ops/image.py remapping against the JAX
package, on the CPU: rad-tan distortion, the pinhole and unified cameras
and the undistortion map in float64 to 1e-12 (the map to 1e-10 px); the
float32 map the command line builds, with its entries that differ in the
last bits counted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.models import camera as jcam
from mba_vo_tpu.ops import image as jim
from mba_vo_tpu_torch import interop
from mba_vo_tpu_torch.models import camera as tcam
from mba_vo_tpu_torch.ops import image as tim

from torch_port_common import npy, smooth_texture, t64

TOL = 1e-12
RNG = np.random.default_rng(23)
H, W = 120, 160
KVEC = np.array([150.0, 145.0, 79.5, 59.5])
DISTORTIONS = {"barrel": (-0.12, 0.04, 0.001, -0.002), "pincushion": (0.2, -0.05, -0.003, 0.004)}


def close(a, b, tol=TOL):
    np.testing.assert_allclose(npy(b), npy(a), atol=tol, rtol=0)


def radtan(coeffs):
    j = jcam.RadTanDistortion(*(jnp.float64(c) for c in coeffs))
    return j, interop.camera_from_fields(
        jcam.PinholeCamera(K=jnp.zeros(4), height=1, width=1, distortion=j)).distortion


def cameras(kind, coeffs=None, dtype=jnp.float64):
    """(JAX camera, port camera) of ``kind`` 'pinhole' or 'unified' (xi 0.8)
    at H x W, with rad-tan ``coeffs`` or none."""
    dist = None if coeffs is None else jcam.RadTanDistortion(*(dtype(c) for c in coeffs))
    K = jnp.asarray(KVEC, dtype)
    if kind == "unified":
        j = jcam.UnifiedCamera(K=K, xi=dtype(0.8), height=H, width=W, distortion=dist)
    else:
        j = jcam.PinholeCamera(K=K, height=H, width=W, distortion=dist)
    tdt = torch.float64 if dtype == jnp.float64 else torch.float32
    return j, interop.camera_from_fields(j, dtype=tdt)


@pytest.mark.parametrize("name", sorted(DISTORTIONS))
def test_radtan_distort_and_jacobian(name):
    j, t = radtan(DISTORTIONS[name])
    p = RNG.uniform(-0.6, 0.6, (64, 2))
    close(j.distort(jnp.asarray(p)), t.distort(t64(p)))
    close(j.distort_jacobian(jnp.asarray(p)), t.distort_jacobian(t64(p)))


@pytest.mark.parametrize("num_iters", [1, 5, 8])
def test_radtan_undistort_fixed_iterations(num_iters):
    """A fixed number of Gauss-Newton steps, no early exit: the result after
    one step is not yet converged and must agree as well."""
    j, t = radtan(DISTORTIONS["barrel"])
    p = RNG.uniform(-0.6, 0.6, (64, 2))
    close(j.undistort(jnp.asarray(p), num_iters), t.undistort(t64(p), num_iters))


def test_radtan_undistort_clamps_a_vanishing_determinant():
    """With k1 = -1 the Jacobian is singular at (1/sqrt(3), 0); next to it,
    at J[0, 0] = 1e-6, det(J^T J) = 4.4e-13 is replaced by 1e-12 in both
    packages, which makes the first step 8.4e4 (1.9e5 unclamped)."""
    j, t = radtan((-1.0, 0.0, 0.0, 0.0))
    p = np.array([[np.sqrt((1.0 - 1e-6) / 3.0), 0.0], [0.3, 0.2]])
    a, b = npy(j.undistort(jnp.asarray(p), 1)), npy(t.undistort(t64(p), 1))
    assert 5e4 < a[0, 0] < 1e5
    np.testing.assert_allclose(b, a, rtol=1e-12, atol=TOL)


@pytest.mark.parametrize("coeffs", [None, DISTORTIONS["barrel"]])
def test_pinhole(coeffs):
    j, t = cameras("pinhole", coeffs)
    P = np.stack([RNG.uniform(-1, 1, 32), RNG.uniform(-1, 1, 32), RNG.uniform(0.5, 4, 32)], -1)
    P[:3, 2] = [-1.0, 0.0, -1e-9]      # behind the camera and at z = 0: invalid
    (xj, vj), (xt, vt) = j.project(jnp.asarray(P)), t.project(t64(P))
    close(xj, xt)
    np.testing.assert_array_equal(npy(vt), npy(vj))
    assert not npy(vt)[:3].any()
    xy, z = RNG.uniform(0, [W, H], (32, 2)), RNG.uniform(0.5, 4, 32)
    close(j.unproject(jnp.asarray(xy), jnp.asarray(z)), t.unproject(t64(xy), t64(z)))
    close(j.unit_ray(jnp.asarray(xy)), t.unit_ray(t64(xy)))
    close(j.projection_jacobian(jnp.asarray(P[3:])), t.projection_jacobian(t64(P[3:])))
    for lv in (1, 2):
        lj, lt = j.level(lv), t.level(lv)
        assert (lt.height, lt.width) == (lj.height, lj.width)
        close(lj.K, lt.K)
    close(jcam.scale_intrinsics(jnp.asarray(KVEC), 3), tcam.scale_intrinsics(t64(KVEC), 3))


@pytest.mark.parametrize("coeffs", [None, DISTORTIONS["barrel"]])
def test_unified(coeffs):
    """Valid where z >= 0 (pinhole: z > 0); the denominator z + xi |P|
    clamped at 1e-12; beta clamped at 0 where xi > 1 lifts a far pixel."""
    j, t = cameras("unified", coeffs)
    P = np.stack([RNG.uniform(-2, 2, 32), RNG.uniform(-2, 2, 32), RNG.uniform(-1, 4, 32)], -1)
    P[0] = [0.0, 0.0, 0.0]                  # denominator 0: clamped
    P[1] = [0.3, -0.2, 0.0]                 # z = 0: valid for the unified model
    (xj, vj), (xt, vt) = j.project(jnp.asarray(P)), t.project(t64(P))
    close(xj, xt)
    np.testing.assert_array_equal(npy(vt), npy(vj))
    assert npy(vt)[1]
    xy, z = RNG.uniform(0, [W, H], (32, 2)), RNG.uniform(0.5, 4, 32)
    close(j.unproject(jnp.asarray(xy), jnp.asarray(z)), t.unproject(t64(xy), t64(z)))
    wide_j, wide_t = j._replace(xi=jnp.float64(1.6)), t._replace(xi=t64(1.6))
    far = np.array([[-400.0, -300.0], [500.0, 400.0], [80.0, 60.0]])
    close(wide_j.unproject(jnp.asarray(far), jnp.ones(3)),
          wide_t.unproject(t64(far), t64(np.ones(3))))
    lj, lt = j.level(1), t.level(1)
    assert (lt.height, lt.width) == (lj.height, lj.width)
    close(lj.K, lt.K)
    close(lj.xi, lt.xi)


MAPS = {"pinhole rad-tan": ("pinhole", DISTORTIONS["barrel"]), "unified": ("unified", None),
        "unified rad-tan": ("unified", DISTORTIONS["pincushion"])}


@pytest.mark.parametrize("name", sorted(MAPS))
def test_undistort_map_and_remap_float64(name):
    """The map onto the clean pinhole view to 1e-10 px; a bilinear remap of
    an image through it and undistort_image to 1e-12 grey levels."""
    sj, st = cameras(*MAPS[name])
    dj, dt = cameras("pinhole")
    mj, mt = jim.build_undistort_map(sj, dj), tim.build_undistort_map(st, dt)
    assert mt.shape == (H, W, 2) and mt.dtype == torch.float64
    close(mj, mt, 1e-10)
    img = smooth_texture(H, W, seed=3)
    close(jim.remap(jnp.asarray(img), mj), tim.remap(t64(img), mt), 1e-10)
    close(jim.undistort_image(jnp.asarray(img), sj, dj), tim.undistort_image(t64(img), st, dt),
          1e-10)
    # nearest-neighbour depth through the rounded map (half to even in both)
    close(jim.remap(jnp.asarray(img), jnp.round(mj)), tim.remap(t64(img), torch.round(mt)))


@pytest.mark.parametrize("name", sorted(MAPS))
def test_undistort_map_float32_counts_its_differences(name):
    """The command line's float32 map, built op by op in both packages (no
    fusion on either side): 0 of the 38,400 entries differ at 120 x 160 for
    each camera (PERF.md section 7), so the rounded map that remaps depth
    picks the same pixels too."""
    sj, st = cameras(*MAPS[name], dtype=jnp.float32)
    dj, dt = cameras("pinhole", dtype=jnp.float32)
    mj = np.asarray(jim.build_undistort_map(sj, dj))
    mt = tim.build_undistort_map(st, dt).numpy()
    assert mt.dtype == np.float32
    off = mt != mj
    print(f"{name}: {int(off.sum())} of {off.size} f32 map entries differ")
    assert not off.any()
