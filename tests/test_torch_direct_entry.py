"""The direct path's stages as the card composes them, run here with their
plain versions, against the JAX package on the CPU.

On CUDA tensors ``ops.residual.compute_residuals`` (``sampling="direct"``)
runs the patch layout K5, K2's ``warp_tangents`` with every window corner
at the origin, the whole-image Lucas-Kanade sampler K4 and K2's
``blur_rows`` (``compute_residuals_direct``). On CPU tensors each of those
dispatchers takes its plain version, so ``compute_residuals_direct`` here
is that composition of plain entries. It is held to the stage it replaces,
JAX's ``compute_residuals``, jitted: r, J and the valid mask, with J and
cost-only, affine and not, at degrees 2 and 4, one and two frames and from
a standing start. There the patch anchors are integers up to the last bit,
and the jitted layout floors a few onto other pixels than JAX run op by op
(and torch) does: in float64 the jitted function takes the anchors of its
op-by-op run (``patch_anchors`` replaced for that trace), in float32,
where the jitted warp rounds samples on the image's border otherwise too,
JAX runs op by op. K4's plain version (``ops.image.image_bilinear_lk_plain``) is
held to JAX's ``bilinear_sample`` of the image and of both gradient
channels, and to ``sample_lk``'s JVP.

Inputs from numpy seeds. Tolerances, relative to each output's magnitude
(the largest |entry| of JAX's output; for r the observations' largest):
1e-12 in float64 and 1e-5 in float32 (the two sum the spline's taps and
the chain rule in other orders); the valid mask equal entry for entry. The
affine J equals the J without it bit for bit (the reference pairs the
corrected residual with the frozen-(a, b) Jacobian), and the cost-only r
the r with J.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.core.spline import identity_knots as j_identity_knots
from mba_vo_tpu.ops import image as jimage
from mba_vo_tpu.ops import residual as jres
from mba_vo_tpu.tracker.patterns import PATTERNS
from mba_vo_tpu_torch.core.spline import identity_knots
from mba_vo_tpu_torch.ops import image as timage
from mba_vo_tpu_torch.ops import residual as tres

from torch_port_common import H, W, knots_arrays, level_arrays, npy, smooth_texture

BOUNDS = {"float64": 1e-12, "float32": 1e-5}
PATTERN = PATTERNS["dso8"]()

j_direct = jax.jit(jres.compute_residuals, static_argnums=(2, 3, 4, 5))


def _positions(n, s, seed=0):
    """[n, s, 2] positions over and around an H x W image: the border
    x = W - 1 and y = H - 1, the corner, integers, just off each edge, far
    off, and NaN."""
    rng = np.random.default_rng(seed)
    loc = np.stack([rng.uniform(-3, W + 2, (n, s)), rng.uniform(-3, H + 2, (n, s))], -1)
    flat = loc.reshape(-1, 2)
    special = [[W - 1, 5.5], [7.25, H - 1], [W - 1, H - 1], [0, 0], [-1e-7, 3],
               [3, H - 1 + 1e-4], [1e6, -1e6], [np.nan, 4], [4, np.nan], [12, 9]]
    flat[:len(special)] = special
    flat[len(special)::5] = np.round(flat[len(special)::5])
    return loc


def _image(dtype):
    img = smooth_texture(H, W, seed=11)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    img_j = jnp.asarray(img, jd)
    img_t = torch.tensor(img, dtype=td)
    return img_j, jimage.image_gradients(img_j), img_t, timage.image_gradients(img_t)


def _close(got, ref, bound, what, scale=None):
    got, ref = npy(got).astype(np.float64), np.asarray(ref).astype(np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert np.array_equal(np.isnan(got), np.isnan(ref)), what
    ok = ~np.isnan(ref)
    scale = np.abs(ref[ok]).max() if scale is None else scale
    err = np.abs(got[ok] - ref[ok]).max() / max(scale, 1e-300)
    assert err <= bound, f"{what}: {err:.3e} of the magnitude > {bound}"


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("channels", [3, 1])
def test_image_sampler_plain_matches_jax(dtype, channels):
    """K4's plain version against JAX's bilinear_sample of img_ref and of
    both channels of grad_ref: 0 off the image and at NaN, the border
    pixels sampled; C = 1 gives the value alone, the C = 3 value's bits."""
    img_j, grad_j, img_t, grad_t = _image(dtype)
    loc = _positions(6, 40)
    loc_t = torch.tensor(loc, dtype=getattr(torch, dtype))
    loc_j = jnp.asarray(loc, getattr(jnp, dtype))
    got = timage.image_bilinear_lk_plain(img_t, grad_t, loc_t, channels)
    refs = [jimage.bilinear_sample(img_j, loc_j), jimage.bilinear_sample(grad_j[..., 0], loc_j),
            jimage.bilinear_sample(grad_j[..., 1], loc_j)]
    outs = (got,) if channels == 1 else got
    assert len(outs) == channels
    for name, o, r in zip(("val", "gx", "gy"), outs, refs):
        assert tuple(o.shape) == (6, 40) and not torch.isnan(o).any()
        _close(o, r, BOUNDS[dtype], f"{name}, {dtype}")
    off = ~np.asarray(jimage.in_bounds(loc_j, H, W))
    assert off.any() and (npy(outs[0])[off] == 0).all()
    other = timage.image_bilinear_lk_plain(img_t, grad_t, loc_t, 4 - channels)
    assert torch.equal(outs[0], other if channels == 3 else other[0])
    # the dispatcher takes the plain version on CPU tensors
    again = timage.image_bilinear_lk(img_t, grad_t, loc_t, channels)
    for a, b in zip((again,) if channels == 1 else again, outs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_image_sampler_gradient_is_sample_lks_jvp(dtype):
    """gx dx + gy dy of K4's plain version is JAX's sample_lk JVP along
    (dx, dy): the Lucas-Kanade derivative the blur rows sum."""
    img_j, grad_j, img_t, grad_t = _image(dtype)
    loc = _positions(4, 30, seed=1)
    d = np.random.default_rng(2).normal(0, 1, loc.shape)
    jd = getattr(jnp, dtype)
    val_j, tan_j = jax.jvp(lambda xy: jimage.sample_lk(img_j, grad_j, xy),
                           (jnp.asarray(loc, jd),), (jnp.asarray(d, jd),))
    td = getattr(torch, dtype)
    val, gx, gy = timage.image_bilinear_lk_plain(img_t, grad_t, torch.tensor(loc, dtype=td))
    dt = torch.tensor(d, dtype=td)
    _close(val, val_j, BOUNDS[dtype], "value")
    _close(gx * dt[..., 0] + gy * dt[..., 1], tan_j, BOUNDS[dtype], "tangent")


def test_image_sampler_kernel_takes_only_cuda_tensors():
    """The CPU tensors above went to the plain version; the kernel's wrapper
    raises on them instead of falling back (it builds nothing)."""
    from mba_vo_tpu_torch.ops import cuda_image

    _, _, img_t, grad_t = _image("float64")
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_image.image_bilinear_cuda(img_t, grad_t, torch.zeros((2, 3, 2), dtype=torch.float64))


# (case, degree, knots, frames): the frame's 2 knots, a degree-4 window of 5
# knots over two frames, and a standing start (identity knots, integer
# keypoints, some on the image's border)
CASES = [("degree 2, one frame", 2, 2, 1), ("degree 4, two frames", 4, 5, 2),
         ("standing start", 2, 2, 1)]


def _problem(case, dtype):
    """(JAX knots, JAX level data, port knots, port level data) in ``dtype``."""
    from mba_vo_tpu.core.spline import make_knots as jmake
    from mba_vo_tpu.ops.residual import TrackingLevelData as JData
    from mba_vo_tpu_torch.core.spline import make_knots as tmake

    name, degree, K, F = next(c for c in CASES if c[0] == case)
    a = level_arrays(seed=8 + F, frames=F)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    if case == "standing start":
        rng = np.random.default_rng(5)
        kp = rng.integers(4, [W - 4, H - 4], (a["kp_xy"].shape[0], 2)).astype(np.float64)
        kp[:4] = [[0, 10], [W - 1, 20], [30, 0], [40, H - 1]]
        a["kp_xy"] = kp
        kj, kt = j_identity_knots(K, 0.085, 0.1, jd), identity_knots(K, 0.085, 0.1, td)
    else:
        t, q, t0, dt = knots_arrays(seed=3 + K, num_knots=K, t0=0.05, dt=0.1)
        kj = jmake(jnp.asarray(t, jd), jnp.asarray(q, jd), t0, dt)
        kt = tmake(torch.tensor(t, dtype=td), torch.tensor(q, dtype=td), t0, dt)
    img_j, img_t = jnp.asarray(a["img_ref"], jd), torch.tensor(a["img_ref"], dtype=td)
    fields = ("cur_imgs", "cap_times", "exp_times", "kp_xy", "kp_z", "kp_mask", "K")
    dj = JData(img_ref=img_j, grad_ref=jimage.image_gradients(img_j),
               pattern=jnp.asarray(PATTERN), **{k: jnp.asarray(a[k], jd) for k in fields})
    dt_ = tres.TrackingLevelData(img_ref=img_t, grad_ref=timage.image_gradients(img_t),
                                 pattern=torch.as_tensor(PATTERN),
                                 **{k: torch.tensor(a[k], dtype=td) for k in fields})
    return kj, dj, kt, dt_, degree


_JAX = {}


def _jax_reference(case, dtype):
    """JAX's compute_residuals with J, without the affine elimination, on
    the case's inputs, computed once: (port knots, port data, degree, r, J,
    valid). Jitted; from a standing start in float64 the jitted function
    takes the anchors of its op-by-op run, and in float32, where the jitted
    warp also rounds samples on the image's border otherwise than op by op,
    it runs op by op."""
    if (case, dtype) not in _JAX:
        kj, dj, kt, dt, degree = _problem(case, dtype)
        if case != "standing start":
            out = j_direct(kj, dj, 5, degree, True, False)
        elif dtype == "float32":
            with jax.disable_jit():
                out = jres.compute_residuals(kj, dj, 5, degree, True, False)
        else:
            with jax.disable_jit():
                pt, pq = jres.sample_virtual_poses(kj, dj.cap_times, dj.exp_times, 5, degree)
                anchors = jres.patch_anchors(pt[:, 2], pq[:, 2], dj.kp_xy, dj.kp_z, dj.K)
            saved = jres.patch_anchors
            try:
                jres.patch_anchors = lambda *a: anchors
                # a function of its own: a trace that no other case shares
                out = jax.jit(lambda k, d: jres.compute_residuals(k, d, 5, degree, True,
                                                                  False))(kj, dj)
            finally:
                jres.patch_anchors = saved
        _JAX[case, dtype] = (kt, dt, degree) + tuple(np.asarray(o) for o in out)
    return _JAX[case, dtype]


j_affine = jax.jit(jres.affine_correct)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_direct_composition_matches_jax(case, dtype, affine):
    """The card's composition of the direct path, run with the plain entries
    (layout, warp_tangents_plain at zero window corners, K4's plain version,
    blur_rows_plain), against JAX's compute_residuals: r, J and valid, with
    J and cost-only. JAX's affine=True is affine_correct of its prediction
    with the same J: its r here is JAX's affine_correct of the prediction
    (r + obs where valid) of its run without."""
    kt, dt, degree, rj, Jj, vj = _jax_reference(case, dtype)
    bound = BOUNDS[dtype]
    _, _, obs = tres.prepare_frame_layout_plain(kt, dt, 5, degree)
    if affine:
        rj = np.asarray(j_affine(jnp.asarray(rj) + jnp.asarray(npy(obs)),
                                 jnp.asarray(npy(obs)), jnp.asarray(vj)))
    r_scale = float(np.abs(npy(dt.cur_imgs)).max())
    r, J, valid = tres.compute_residuals_direct(kt, dt, 5, degree, True, affine)
    np.testing.assert_array_equal(npy(valid), vj)
    assert 0 < npy(valid).mean() < 1
    _close(r, rj, bound, f"r, {case}, {dtype}", scale=r_scale)
    _close(J, Jj, bound, f"J, {case}, {dtype}")
    assert np.abs(npy(J)).max() > 1.0 and tuple(J.shape) == Jj.shape
    rc, Jc, vc = tres.compute_residuals_direct(kt, dt, 5, degree, False, affine)
    assert Jc is None and torch.equal(vc, valid)
    assert torch.equal(rc, r)
    if affine:
        r0, J0, _ = tres.compute_residuals_direct(kt, dt, 5, degree, True, False)
        assert torch.equal(J, J0)
        assert np.abs(npy(r) - npy(r0)).max() > 1e-3      # the elimination did something


def test_direct_dispatcher_takes_the_plain_chain_on_the_cpu():
    """On CPU tensors compute_residuals is compute_residuals_plain, bit for
    bit (today's chain, which the other differential tests hold), and the
    card's composition gives its r to the bit and its J within 1e-13 of the
    magnitude (the blur is summed over the knot tangents, not the 7 pose
    components)."""
    kj, dj, kt, dt, degree = _problem("degree 4, two frames", "float64")
    for affine in (False, True):
        got = tres.compute_residuals(kt, dt, 5, degree, True, affine)
        ref = tres.compute_residuals_plain(kt, dt, 5, degree, True, affine)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        r, J, valid = tres.compute_residuals_direct(kt, dt, 5, degree, True, affine)
        assert torch.equal(r, ref[0]) and torch.equal(valid, ref[2])
        _close(J, npy(ref[1]), 1e-13, "J")
    # the layout's dispatcher takes its plain version likewise
    for a, b in zip(tres.prepare_frame_layout(kt, dt, 5, degree),
                    tres.prepare_frame_layout_plain(kt, dt, 5, degree)):
        assert torch.equal(a, b)
