"""The port's tracker/sparse_features.py and detector.refine_subpixel
against the JAX package, float64 on the CPU: a smoothed random texture and
its warped copy through detect_sparse (keypoints, responses, orientation
to 1e-9, masks and descriptors exact), match_descriptors (exact, ties
included: both return the first index of a tie), the batched matching the
backend's loop detection uses, and the float32 detection the backend runs
(keypoints to float32 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mba_vo_tpu.data.synthetic import warp_image
from mba_vo_tpu.tracker import detector as jdet
from mba_vo_tpu.tracker import sparse_features as jsf
from mba_vo_tpu_torch.tracker import detector as tdet
from mba_vo_tpu_torch.tracker import sparse_features as tsf

from torch_port_common import npy, smooth_texture, t64

H, W = 96, 128
KVEC = np.array([90.0, 90.0, 63.5, 47.5])
OPTS = dict(score_threshold=1.0, cell_h=12, cell_w=12, max_keypoints=96)
TOL = 1e-9


def image_pair():
    img = smooth_texture(H, W, seed=3)
    q = np.array([0.0, 0.01, 0.005, 1.0])
    warped = np.asarray(warp_image(jnp.asarray(img), jnp.asarray([0.03, 0.01, 0.0]),
                                   jnp.asarray(q / np.linalg.norm(q)), 2.0,
                                   jnp.asarray(KVEC)))
    return img, warped


@pytest.fixture(scope="module")
def features():
    """JAX and port features of both images, float64."""
    jd, td = jdet.DetectorOptions(**OPTS), tdet.DetectorOptions(**OPTS)
    out = []
    for img in image_pair():
        out.append((jsf.detect_sparse(jnp.asarray(img), jd),
                    tsf.detect_sparse(t64(img), td)))
    return out


def test_brief_pattern_is_the_same():
    np.testing.assert_array_equal(tsf.brief_pattern(), jsf.brief_pattern())
    np.testing.assert_array_equal(tsf.brief_pattern(3), jsf.brief_pattern(3))


@pytest.mark.parametrize("which", [0, 1])
def test_detect_sparse_matches_jax(features, which):
    fj, ft = features[which]
    np.testing.assert_allclose(npy(ft.kp_xy), np.asarray(fj.kp_xy), rtol=0, atol=TOL)
    np.testing.assert_allclose(npy(ft.response), np.asarray(fj.response), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(npy(ft.mask), np.asarray(fj.mask))
    np.testing.assert_allclose(npy(ft.orientation), np.asarray(fj.orientation), rtol=0,
                               atol=TOL)
    np.testing.assert_array_equal(npy(ft.descriptors), np.asarray(fj.descriptors))
    assert 40 < npy(ft.mask).sum() <= OPTS["max_keypoints"]


def test_shi_tomasi_and_orientation_match_jax():
    img = image_pair()[0]
    rj = np.asarray(jsf.shi_tomasi_response(jnp.asarray(img)))
    rt = npy(tsf.shi_tomasi_response(t64(img)))
    np.testing.assert_allclose(rt, rj, rtol=0, atol=TOL * max(1.0, np.abs(rj).max()))
    kp = np.random.default_rng(1).uniform([0, 0], [W - 1, H - 1], (50, 2))
    kp[:3] = [[0.0, 0.0], [W - 1.0, 3.5], [2.25, H - 1.0]]     # disc spills off the image
    oj = np.asarray(jsf.orientation_ic(jnp.asarray(img), jnp.asarray(kp)))
    ot = npy(tsf.orientation_ic(t64(img), t64(kp)))
    np.testing.assert_allclose(ot, oj, rtol=0, atol=TOL)
    pat = jsf.brief_pattern()
    dj = np.asarray(jsf.brief_descriptors(jnp.asarray(img), jnp.asarray(kp), jnp.asarray(oj),
                                          jnp.asarray(pat)))
    dt = npy(tsf.brief_descriptors(t64(img), t64(kp), t64(oj), torch.as_tensor(pat)))
    np.testing.assert_array_equal(dt, dj)


def test_refine_subpixel_matches_jax():
    rng = np.random.default_rng(2)
    resp = rng.normal(0, 1, (20, 30)) ** 2
    resp[5, :] = 1.0                                   # flat rows: zero denominator
    kp = rng.integers(0, [30, 20], (40, 2)).astype(np.float64)
    kp[:4] = [[0, 0], [29, 19], [3, 5], [29, 0]]       # clamped to the interior
    mask = (rng.random(40) > 0.2).astype(np.float64)
    rj = np.asarray(jdet.refine_subpixel(jnp.asarray(resp), jnp.asarray(kp), jnp.asarray(mask)))
    rt = npy(tdet.refine_subpixel(t64(resp), t64(kp), t64(mask)))
    np.testing.assert_allclose(rt, rj, rtol=0, atol=TOL)
    assert np.abs(rt - kp).max() <= 0.5


@pytest.mark.parametrize("params", [(80.0, 0.8), (96.0, 0.85), (256.0, 1.0)])
def test_match_descriptors_matches_jax(features, params):
    (aj, at), (bj, bt) = features
    mj, dj = jsf.match_descriptors(aj, bj, *params)
    mt, dt = tsf.match_descriptors(at, bt, *params)
    assert mt.dtype == torch.int32
    np.testing.assert_array_equal(npy(mt), np.asarray(mj))
    np.testing.assert_array_equal(npy(dt), np.asarray(dj))
    assert (npy(mt) >= 0).sum() > 10


def tie_features(seed=0, n=24):
    """Descriptors with exact Hamming ties: duplicated rows in both sets and
    rows one bit apart, so argmin meets equal minima along both axes."""
    rng = np.random.default_rng(seed)
    base = np.where(rng.random((8, 256)) < 0.5, 1.0, -1.0)
    a = base[rng.integers(0, 8, n)].copy()
    b = base[rng.integers(0, 8, n)].copy()
    b[::3, :2] *= -1                                     # 2 bits off: ties at distance 2
    mask_a = np.ones(n)
    mask_a[-2:] = 0
    mask_b = np.ones(n)
    mask_b[5] = 0
    kp = rng.uniform(0, 50, (n, 2))
    make = lambda d, m: dict(kp_xy=kp, response=np.ones(n), mask=m,  # noqa: E731
                             orientation=np.zeros(n), descriptors=d * m[:, None])
    return make(a, mask_a), make(b, mask_b)


@pytest.mark.parametrize("seed", range(3))
def test_match_ties_take_the_first_index_like_jax(seed):
    fa, fb = tie_features(seed)
    ja = jsf.SparseFeatures(**{k: jnp.asarray(v) for k, v in fa.items()})
    jb = jsf.SparseFeatures(**{k: jnp.asarray(v) for k, v in fb.items()})
    ta = tsf.SparseFeatures(**{k: t64(v) for k, v in fa.items()})
    tb = tsf.SparseFeatures(**{k: t64(v) for k, v in fb.items()})
    for params in ((96.0, 0.85), (96.0, 1.0)):
        mj, dj = jsf.match_descriptors(ja, jb, *params)
        mt, dt = tsf.match_descriptors(ta, tb, *params)
        np.testing.assert_array_equal(npy(mt), np.asarray(mj))
        np.testing.assert_array_equal(npy(dt), np.asarray(dj))
    # the ties are real: some row's best distance repeats in that row
    ham = 0.5 * (256 - fa["descriptors"] @ fb["descriptors"].T)
    assert any((row == row.min()).sum() > 1 for row in ham)


def test_batched_matching_equals_one_at_a_time(features):
    """match_descriptors with a leading batch axis on ``a`` (the backend's
    loop detection) gives each entry's own result."""
    (_, a), (_, b) = features
    fa, fb = tie_features(1, n=a.kp_xy.shape[0])
    c = tsf.SparseFeatures(**{k: t64(v) for k, v in fa.items()})
    stacked = tsf.SparseFeatures(*(torch.stack(f) for f in zip(a, b, c)))
    mb, db = tsf.match_descriptors(stacked, b, 96.0, 0.85)
    for k, one in enumerate((a, b, c)):
        m1, d1 = tsf.match_descriptors(one, b, 96.0, 0.85)
        assert torch.equal(mb[k], m1) and torch.equal(db[k], d1)


def test_float32_detection_as_the_backend_runs_it():
    """The backend detects in float32 in both packages: XLA and torch round
    the float32 box sums and moments differently, so keypoints agree to
    float32 rounding; masks, descriptors and matches are the same here."""
    jd, td = jdet.DetectorOptions(**OPTS), tdet.DetectorOptions(**OPTS)
    fj = [jax.jit(jsf.detect_sparse, static_argnums=(1, 2))(jnp.asarray(x, jnp.float32), jd)
          for x in image_pair()]
    ft = [tsf.detect_sparse(torch.tensor(x, dtype=torch.float32), td) for x in image_pair()]
    for a, b in zip(fj, ft):
        assert b.kp_xy.dtype == torch.float32
        np.testing.assert_allclose(npy(b.kp_xy), np.asarray(a.kp_xy), rtol=0, atol=1e-4)
        np.testing.assert_array_equal(npy(b.mask), np.asarray(a.mask))
        np.testing.assert_array_equal(npy(b.descriptors), np.asarray(a.descriptors))
    mj, _ = jsf.match_descriptors(*fj, 96.0, 0.85)
    mt, _ = tsf.match_descriptors(*ft, 96.0, 0.85)
    np.testing.assert_array_equal(npy(mt), np.asarray(mj))
