"""The port's utils/viz.py and utils/profiling.py: the numpy drawing
helpers equal the JAX package's; blur_kernel_segments from the port's
knots agrees with the reference's to 1e-10 px in float64 and 1e-4 px from
float32 knots; save_png writes RGB through data/png.py, which PIL reads
back equal; StageTimer and profile_trace on the CPU."""

import json
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from mba_vo_tpu.core.spline import make_knots as jmake
from mba_vo_tpu.utils import viz as jviz
from mba_vo_tpu_torch.core.spline import make_knots as tmake
from mba_vo_tpu_torch.data import png
from mba_vo_tpu_torch.utils import profiling
from mba_vo_tpu_torch.utils import viz as tviz

from torch_port_common import KVEC, knots_arrays, knots_pair

RNG = np.random.default_rng(41)


def test_colour_maps():
    for v in (-0.5, 0.0, 0.1, 0.37, 0.5, 0.8, 1.0, 2.0):
        np.testing.assert_array_equal(tviz.jet_color(v), jviz.jet_color(v))
    for args in ((3.0, 1.0, 5.0), (3.0, 5.0, 5.0), (-1.0, 0.0, 2.0)):
        np.testing.assert_array_equal(tviz.scalar_to_color(*args), jviz.scalar_to_color(*args))


def test_drawing_helpers():
    gray = RNG.uniform(-20, 280, (40, 50))
    np.testing.assert_array_equal(tviz.to_rgb(gray), jviz.to_rgb(gray))
    img = jviz.to_rgb(gray)
    # half-pixel points: int(round(x)) rounds half to even in both
    pts = np.concatenate([RNG.uniform(-3, 53, (30, 2)), [[2.5, 3.5], [48.5, 39.5]]])
    for radius in (0, 1, 2):
        np.testing.assert_array_equal(tviz.draw_points(img, pts, radius=radius),
                                      jviz.draw_points(img, pts, radius=radius))
    segs = [RNG.uniform(-5, 55, (3, 2)) for _ in range(8)] + [np.array([[1.5, 1.5], [1.5, 1.5]])]
    np.testing.assert_array_equal(tviz.draw_segments(img, segs, color=(1, 2, 3)),
                                  jviz.draw_segments(img, segs, color=(1, 2, 3)))


def keypoints(n=20):
    return RNG.uniform(5, [75, 59], (n, 2)), RNG.uniform(1.5, 2.5, n)


@pytest.mark.parametrize("num_samples", [3, 5])
def test_blur_kernel_segments_float64(num_samples):
    jk, tk = knots_pair(knots_arrays(seed=2, num_knots=3, t0=0.0, dt=0.1))
    xy, z = keypoints()
    a = jviz.blur_kernel_segments(jk, xy, z, KVEC, 0.12, 0.03, 2, num_samples)
    b = tviz.blur_kernel_segments(tk, xy, z, KVEC, 0.12, 0.03, 2, num_samples)
    assert len(b) == len(a) == len(xy)
    for sa, sb in zip(a, b):
        assert sb.shape == (num_samples, 2)
        np.testing.assert_allclose(sb, sa, atol=1e-10, rtol=0)


def test_blur_kernel_segments_float32_knots():
    """The command line's float32 tracker hands float32 knots and keypoints:
    the points are lifted in float64 in both packages, the poses stay
    float32; the polylines agree to 1e-4 px."""
    t, q, t0, dt = knots_arrays(seed=2, num_knots=3, t0=0.0, dt=0.1)
    jk = jmake(jnp.asarray(t, jnp.float32), jnp.asarray(q, jnp.float32), t0, dt)
    tk = tmake(torch.tensor(t, dtype=torch.float32), torch.tensor(q, dtype=torch.float32), t0, dt)
    xy, z = (a.astype(np.float32) for a in keypoints())
    a = jviz.blur_kernel_segments(jk, xy, z, KVEC, 0.12, 0.03, 2)
    b = tviz.blur_kernel_segments(tk, xy, z, KVEC, 0.12, 0.03, 2)
    np.testing.assert_allclose(np.stack(b), np.stack(a), atol=1e-4, rtol=0)


def test_save_png_writes_rgb_that_pil_reads_back(tmp_path):
    img = RNG.integers(0, 256, (23, 37, 3)).astype(np.uint8)
    tviz.save_png(str(tmp_path / "o.png"), img)
    back = PILImage.open(tmp_path / "o.png")
    assert back.mode == "RGB"
    np.testing.assert_array_equal(np.asarray(back), img)
    # an int array is cast to uint8, as the reference's save_png does
    tviz.save_png(str(tmp_path / "i.png"), img.astype(np.int64))
    np.testing.assert_array_equal(np.asarray(PILImage.open(tmp_path / "i.png")), img)
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.write_png(str(tmp_path / "x.png"), img.astype(np.uint16))


def test_stage_timer_on_the_cpu():
    timer = profiling.StageTimer()
    out = []
    for _ in range(3):
        with timer.stage("work", sync_on=out):
            time.sleep(0.01)
            out.append(torch.ones(3))
    with timer.stage("other", sync_on=torch.zeros(2)):
        pass
    assert timer.counts["work"] == 3 and timer.counts["other"] == 1
    assert timer.totals["work"] >= 0.03
    assert timer.mean_ms("work") >= 10.0
    lines = timer.report().splitlines()
    assert lines[0].startswith("work") and "calls     3" in lines[0]
    assert profiling._cuda_devices({"a": [torch.ones(1), (torch.ones(1),)]}, set()) == set()


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
