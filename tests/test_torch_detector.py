"""The port's tracker/detector.py, tracker/patterns.py and utils/failure.py
against the JAX package.

``detect_semidense`` ranks grid cells with ``jax.lax.top_k``, which breaks
ties by index; most cells of a textureless region tie at response 0, so the
port must reproduce that order exactly for the keypoint slots to line up.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mba_vo_tpu.ops.image import gradient_magnitude, image_gradients
from mba_vo_tpu.tracker import detector as jdet
from mba_vo_tpu.tracker.patterns import PATTERNS as JPATTERNS
from mba_vo_tpu.utils import failure as jfail
from mba_vo_tpu_torch.tracker import detector as tdet
from mba_vo_tpu_torch.tracker.patterns import PATTERNS as TPATTERNS
from mba_vo_tpu_torch.utils import failure as tfail

from torch_port_common import npy, smooth_texture, t64


def test_tie_order_is_top_k_order():
    """lax.top_k puts equal values in index order; the port's stable
    descending sort does the same (torch.topk promises no order for ties)."""
    x = np.array([0.0, 3.0, 0.0, 3.0, 0.0, 1.0, 0.0])
    _, idx = jax.lax.top_k(jnp.asarray(x), 7)
    np.testing.assert_array_equal(np.asarray(idx), [1, 3, 5, 0, 2, 4, 6])
    kp, resp, mask = tdet.detect_semidense(t64(x[None]), 0, tdet.DetectorOptions(
        score_threshold=0.5, cell_h=1, cell_w=1, max_keypoints=7))
    np.testing.assert_array_equal(npy(kp[:3, 0]), [1.0, 3.0, 5.0])
    np.testing.assert_array_equal(npy(resp), x[np.asarray(idx)])


def _magnitude(h, w, seed, flat_rows=0):
    img = smooth_texture(h, w, seed=seed, passes=1) * 2.0
    if flat_rows:
        img[:flat_rows] = 7.0   # a textureless band: its cells all tie at 0
    return np.asarray(gradient_magnitude(image_gradients(jnp.asarray(img))))


@pytest.mark.parametrize("h,w,level,cell,max_kp,thresh,flat", [
    (64, 80, 0, 8, 96, 5.0, 24),     # more cells than slots, many zero ties
    (64, 80, 1, 8, 256, 25.0, 16),   # level-1 cell size, slots left empty
    (32, 40, 2, 30, 64, 5.0, 10),    # fewer cells than slots: zero padding
    (120, 160, 0, 30, 512, 5.0, 0),  # the tracker's options on a small frame
])
def test_detect_semidense_matches(h, w, level, cell, max_kp, thresh, flat):
    mag = _magnitude(h, w, seed=h + level, flat_rows=flat)
    jo = jdet.DetectorOptions(score_threshold=thresh, cell_h=cell, cell_w=cell,
                              max_keypoints=max_kp)
    to = tdet.DetectorOptions(**dataclasses.asdict(jo))
    kj, rj, mj = jdet.detect_semidense(jnp.asarray(mag), level, jo)
    kt, rt, mt = tdet.detect_semidense(t64(mag), level, to)
    np.testing.assert_array_equal(npy(kt), np.asarray(kj))
    np.testing.assert_array_equal(npy(rt), np.asarray(rj))
    np.testing.assert_array_equal(npy(mt), np.asarray(mj))
    assert 0 < npy(mt).sum() < max_kp


@pytest.mark.parametrize("level", range(5))
def test_cell_size_at_level(level):
    for cell in (1, 7, 30):
        assert tdet._cell_size_at_level(cell, level) == jdet._cell_size_at_level(cell, level)


def test_detector_options_defaults():
    assert dataclasses.asdict(tdet.DetectorOptions()) == dataclasses.asdict(
        jdet.DetectorOptions())


def test_patterns_are_the_same():
    assert sorted(TPATTERNS) == sorted(JPATTERNS)
    for name in JPATTERNS:
        np.testing.assert_array_equal(TPATTERNS[name](), JPATTERNS[name]())


@pytest.mark.parametrize("stats", [
    (3.0, 0.5, 1e4, 0.1),
    (np.nan, 0.5, 1e4, 0.1),
    (3.0, np.inf, 1e4, 0.1),
    (3.0, 0.5, 1e4, np.nan),
    (2e4, 0.5, 1e4, 0.1),
])
def test_stats_healthy(stats):
    assert tfail.stats_healthy(*stats) == jfail.stats_healthy(*stats)
    assert [f.name for f in dataclasses.fields(tfail.FailureEvent)] == [
        f.name for f in dataclasses.fields(jfail.FailureEvent)]
