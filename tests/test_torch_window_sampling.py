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
import torch

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


def test_tiled_cuda_wrapper_refuses_cpu_tensors():
    """K1-v's wrapper has no plain path of its own at all: a CPU tensor is
    an error, it counts no launch, and the tracker's window_bilinear never
    routes to it."""
    w, xy, v = problem(2, 1, 8, 8, 3)
    before = cuda_sampling.LAUNCHES_TILED
    with pytest.raises(ValueError, match="window_bilinear_tiled_cuda: windows is on cpu"):
        cuda_sampling.window_bilinear_tiled_cuda(t64(w), t64(xy), t64(v), 4, 128)
    assert cuda_sampling.LAUNCHES_TILED == before
    tws.window_bilinear(t64(w), t64(xy), t64(v))
    assert cuda_sampling.LAUNCHES_TILED == before


def test_shared_memory_budget_of_the_sweeps_tiles():
    """Every variant of the sweep fits a block's 232,448 bytes at the
    tracker's window set [3, 32, 32], in float32 and float64: K1-v's ring
    holds 2 stages of one window and its samples whatever the tile (up to
    S = 320); K1's bands fit at up to 1024 threads in float32 and 512 in
    float64; the staged first design of K1-v holds a whole tile, at most 18
    float32 windows."""
    from mba_vo_tpu_torch.experiments import kernel_variants as kv

    per_window = 3 * 32 * 32
    for item in (4, 8):
        ring = cuda_sampling.ring_shared_bytes(3, 32, 32, max(kv.SAMPLES), item)
        assert ring == 128 + 2 * (per_window * item + 3 * max(kv.SAMPLES) * item)
        assert ring <= cuda_sampling.MAX_SHARED_BYTES
    # K1's bands: float32 at up to 1024 threads, float64 at up to 512
    bands = cuda_sampling.band_shared_bytes
    assert bands(1024, 3, 32, 32, 4) <= cuda_sampling.MAX_SHARED_BYTES
    assert bands(512, 3, 32, 32, 8) <= cuda_sampling.MAX_SHARED_BYTES < bands(1024, 3, 32, 32, 8)
    assert max(kv.TILES) * per_window * 8 <= cuda_sampling.MAX_SHARED_BYTES
    assert 18 * per_window * 4 <= cuda_sampling.MAX_SHARED_BYTES < 19 * per_window * 4
    assert kv.TILES == (1, 2, 4, 8) and kv.THREADS == (64, 128, 256)


@pytest.mark.parametrize("threads,c,win_h,win_w,item,want", [
    (128, 3, 32, 32, 4, 32 + 4 * 3 * 12 * 32 * 4),    # the tracker's shape
    (64, 1, 20, 30, 4, 16 + 2 * 1 * 12 * 30 * 4),     # 1,440-byte planes
    (32, 3, 6, 9, 4, 16 + 3 * 92 * 4),                # (4 + 6) x 9 = 90 -> 92
    (96, 3, 5, 7, 8, 32 + 3 * 3 * 64 * 8),            # (4 + 5) x 7 = 63 -> 64
])
def test_band_shared_bytes(threads, c, win_h, win_w, item, want):
    """K1's block holds an mbarrier per warp (padded to 16 bytes), then per
    warp C planes of min(TOP_ROWS, win_h) + min(BAND_ROWS, win_h) rows, each
    padded to 16 bytes."""
    assert (cuda_sampling.TOP_ROWS, cuda_sampling.BAND_ROWS) == (4, 8)
    assert cuda_sampling.band_shared_bytes(threads, c, win_h, win_w, item) == want


def test_keypoint_stride_reads_the_c1_slice_in_place():
    """The cost-only call's slice windows[:, :1] goes to the kernels as it
    is, with the C = 3 cache's keypoint stride; a layout whose keypoint
    blocks are not contiguous is copied by kernel_windows and refused by
    keypoint_stride."""
    w = torch.zeros((5, 3, 6, 7), dtype=torch.float64)
    assert cuda_sampling.keypoint_stride(w) == 3 * 6 * 7
    one = w[:, :1]
    assert not one.is_contiguous()
    assert cuda_sampling.keypoint_stride(one) == 3 * 6 * 7
    assert cuda_sampling.kernel_windows(one) is one
    assert cuda_sampling.keypoint_stride(w[2:4]) == 3 * 6 * 7
    assert cuda_sampling.keypoint_stride(w[:1, 1:]) == 2 * 6 * 7
    for bad in (w[:, ::2], w[..., :5], w.transpose(2, 3)):
        with pytest.raises(ValueError, match="contiguous"):
            cuda_sampling.keypoint_stride(bad)
        copy = cuda_sampling.kernel_windows(bad)
        assert copy.is_contiguous() and torch.equal(copy, bad)
    with pytest.raises(ValueError, match="win_h, win_w"):
        cuda_sampling.keypoint_stride(w[0])


def _small_tracker(virtual_poses=(5, 3)):
    """A two-level CPU tracker on a 48x64 scene after its keyframe, and the
    next blurred frame."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import smooth_shapes_image, synthesize_blurred_image
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker, TrackerConfig
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    h, w = 48, 64
    K = np.array([45.0, 45.0, (w - 1) / 2, (h - 1) / 2])
    img = smooth_shapes_image(h, w, sigma=3.0, dtype=np.float64)
    traj = make_knots(t64([[0.0, 0, 0], [0.004, -0.002, 0.001]]),
                      t64([[0.0, 0, 0, 1], [0.0, 0, 0, 1]]), 0.0, 0.1)
    cfg = TrackerConfig(num_pyramid_levels=2, num_virtual_poses=virtual_poses,
                        max_num_iterations=3,
                        detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                                 max_keypoints=32))
    tracker = BlurAwareTracker(cfg, K, (h, w), device="cpu")
    tracker.track_frame(img, img, 0.0, 0.03, np.full((h, w), 2.0))
    blur = synthesize_blurred_image(t64(img), traj, 2, 0.1, 0.03, 5, 2.0, t64(K)).numpy()
    return tracker, blur


def test_recorder_records_the_trackers_sampler_calls():
    """Recording one tracked frame: one C = 3 call of S = P x V per LM
    evaluation (V of the call's level), one shared windows copy per level;
    the tracker's result is unchanged and window_bilinear is restored."""
    from mba_vo_tpu_torch.experiments import kernel_variants as kv

    original = tws.window_bilinear
    tracker, blur = _small_tracker()
    with kv.record_sampler_calls() as calls:
        pose = tracker.track_frame(None, blur, 0.1, 0.03)
    assert tws.window_bilinear is original
    again, blur = _small_tracker()
    plain_pose = again.track_frame(None, blur, 0.1, 0.03)
    assert torch.equal(pose.t, plain_pose.t) and torch.equal(pose.q, plain_pose.q)

    evaluations = {lv: 1 + s.num_iterations for lv, s in tracker.last_summaries}
    assert [c.C for c in calls] == [3] * len(calls)
    assert {lv: sum(c.level == lv for c in calls) for lv in evaluations} == evaluations
    for c in calls:
        assert c.S == 8 * (5, 3)[c.level] and c.valid.shape == (c.windows.shape[0], c.S)
        assert c.local_xy.shape == (c.windows.shape[0], c.S, 2)
    per_level = {lv: {c.windows.data_ptr() for c in calls if c.level == lv} for lv in (0, 1)}
    assert all(len(ptrs) == 1 for ptrs in per_level.values())
    # the copies replay to the tracker's own samples
    for c in calls[:3]:
        np.testing.assert_array_equal(
            npy(tws.window_bilinear(*c.args)), npy(tws.window_bilinear_plain(*c.args)))


def test_recorder_restores_window_bilinear_on_an_exception():
    from mba_vo_tpu_torch.experiments import kernel_variants as kv

    original = tws.window_bilinear
    with pytest.raises(RuntimeError, match="inside"):
        with kv.record_sampler_calls() as calls:
            assert tws.window_bilinear is not original
            w, xy, v = problem(2, 3, 8, 8, 4)
            tws.sample_windows_lk(t64(w), t64(xy), t64(v))
            raise RuntimeError("inside")
    assert tws.window_bilinear is original
    assert len(calls) == 1 and calls[0].level is None


def test_recorder_keeps_the_c1_slice_strided():
    """A cost-only call records windows[:, :1] as a strided slice of a copy
    of the C = 3 cache, which the kernels read in place as they would the
    tracker's."""
    from mba_vo_tpu_torch.experiments import kernel_variants as kv

    w, xy, v = problem(4, 3, 8, 8, 5)
    with kv.record_sampler_calls() as calls:
        tws.sample_windows(t64(w), t64(xy), t64(v))
        tws.sample_windows_lk(t64(w), t64(xy), t64(v))
    one, three = calls
    assert one.windows.stride() == (3 * 64, 64, 8, 1) and one.C == 1
    assert cuda_sampling.keypoint_stride(one.windows) == 3 * 64
    np.testing.assert_array_equal(npy(one.windows), w[:, :1])
    np.testing.assert_array_equal(npy(three.windows), w)


def test_needed_bytes_of_the_trackers_inputs_are_few():
    """On the tracker's own inputs the function needs a small share of the
    window elements (the samples cluster around the keypoint), so its bound
    lies well below the whole-window copy, and the tap rows cluster at the
    window's centre: the band K1 stages holds most of them."""
    from mba_vo_tpu_torch.experiments import kernel_variants as kv

    tracker, blur = _small_tracker(virtual_poses=(5, 5))
    with kv.record_sampler_calls() as calls:
        tracker.track_frame(None, blur, 0.1, 0.03)
    fine = [c for c in calls if c.level == 0]
    for c in fine:
        need = kv.needed_window_elements(*c.args)
        assert 0 < need < c.windows.numel() // 4
        assert kv.needed_bytes(*c.args) < c.windows.numel() * c.windows.element_size()
        assert kv.bound_ms(*c.args)[0] < kv.bound_ms(*c.args, staged=True)[0]
    hist, cover = kv.tap_row_histogram(fine)
    assert sum(hist.values()) == sum(2 * int((~torch.isnan(c.local_xy).any(-1)).sum())
                                     for c in fine)
    assert max(hist, key=hist.get) in (-2, -1, 0, 1)
    assert len(cover) == len(kv.TOPS) * len(kv.BANDS)
    assert cover[0, 16] > cover[0, 2] > 0.2 and cover[4, 8] >= cover[0, 8]


def test_tap_row_histogram_and_staged_rows():
    """Rows as the kernels read them: two taps a sample, a row outside the
    window reads row 0, NaN samples read none; the centre band is centred on
    the keypoint's own two tap rows and clamped into the window, and merges
    with the top band where the two meet."""
    from mba_vo_tpu_torch.experiments import kernel_variants as kv

    assert [kv.staged_rows(32, 0, b) for b in (2, 8, 16)] == [(0, 16, 2), (0, 13, 8),
                                                              (0, 9, 16)]
    assert kv.staged_rows(32, 4, 8) == (4, 13, 8)
    assert kv.staged_rows(6, 4, 8) == (0, 0, 6) and kv.staged_rows(12, 4, 8) == (0, 0, 11)
    assert kv.staged_rows(9, 0, 8) == (0, 1, 8) and kv.staged_rows(20, 2, 8) == (2, 7, 8)
    w = torch.zeros((1, 1, 32, 32), dtype=torch.float64)
    xy = t64([[[3.0, 16.5], [3.0, 13.0], [3.0, 31.5], [3.0, -3.0], [np.nan, 4.0]]])
    call = kv.SamplerCall(w, xy, torch.ones((1, 5), dtype=torch.float64), 0)
    hist, cover = kv.tap_row_histogram([call], bands=(2, 8), tops=(0, 4))
    # rows 16, 17 | 13, 14 | 31, (32 -> 0) | (-3 -> 0), (-2 -> 0)
    assert hist == {-16: 3, -3: 1, -2: 1, 0: 1, 1: 1, 15: 1}
    assert cover == {(0, 2): 2 / 8, (0, 8): 4 / 8, (4, 2): 5 / 8, (4, 8): 7 / 8}


@pytest.mark.parametrize("c,win_h,win_w,s", [(3, 8, 8, 5), (1, 6, 9, 40), (3, 32, 32, 40)])
def test_sweeps_bound_counts_the_bytes_these_inputs_need(c, win_h, win_w, s):
    """The sweep's bound reads, per keypoint, the distinct pixels under a tap
    of non-zero weight of an unmasked sample, times the channels: held
    against a loop over the samples. Integer coordinates need one tap, a
    NaN or masked sample none, and ``staged`` counts every window."""
    from mba_vo_tpu_torch.experiments import kernel_variants as kv

    w, xy, v = problem(4, c, win_h, win_w, s)
    xy[0, 0] = [2.0, 3.0]            # on a pixel: one tap
    xy[1, 1] = [np.nan, 1.5]
    xy[2, 2] = [win_w - 1.0, 0.5]    # on the last column: two taps
    v[0, 0] = v[2, 2] = 1.0
    want = 0
    for n in range(xy.shape[0]):
        px = set()
        for (x, y), m in zip(xy[n], v[n]):
            if m == 0 or np.isnan(x) or np.isnan(y):
                continue
            for ty in (np.floor(y), np.floor(y) + 1):
                for tx in (np.floor(x), np.floor(x) + 1):
                    if (0 <= tx <= win_w - 1 and 0 <= ty <= win_h - 1
                            and abs(x - tx) < 1 and abs(y - ty) < 1):
                        px.add((int(ty), int(tx)))
        want += len(px) * c
    args = (t64(w), t64(xy), t64(v))
    assert kv.needed_window_elements(*args) == want
    assert 0 < want < w.size
    moved = (want + xy.size + v.size + 4 * c * s) * 8
    ms, by = kv.bound_ms(*args)
    assert by == "bytes" and ms == pytest.approx(1e3 * moved / kv.HBM_BYTES_PER_S, rel=1e-12)
    staged, _ = kv.bound_ms(*args, staged=True)
    assert staged == pytest.approx(
        1e3 * (moved + (w.size - want) * 8) / kv.HBM_BYTES_PER_S, rel=1e-12)


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
