"""Kernels K1 (csrc/window_bilinear.cu: one thread a sample, which the
tracker launches, and the band design) and K1-v
(csrc/window_bilinear_tiled.cu: the ring design and the staged first
design) against the plain PyTorch version, on the card. Every test here carries the ``cuda`` marker and skips where no
CUDA device is visible.

The module imports only torch and numpy, so it also runs where JAX is not
installed. Run it on a machine with the card, without the JAX test
configuration:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _problem(n, c, win_h, win_w, s, dtype, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 50.0, (n, c, win_h, win_w))
    xy = np.stack([rng.uniform(-3, win_w + 2, (n, s)), rng.uniform(-3, win_h + 2, (n, s))], -1)
    xy[:, :4] = np.round(xy[:, :4])           # integer coordinates
    xy[:, 4, 0] = -0.5                        # half a pixel left of the window
    xy[::5, 5, 1] = np.nan                    # NaN
    v = rng.integers(0, 2, (n, s)).astype(np.float64)
    return [torch.tensor(a, dtype=dtype, device="cuda") for a in (w, xy, v)]


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("c,win_h,win_w,s", [(3, 32, 32, 40), (1, 32, 32, 40), (3, 20, 32, 40)])
def test_kernel_matches_plain(cuda, dtype, bound, c, win_h, win_w, s):
    from mba_vo_tpu_torch.ops import cuda_sampling
    from mba_vo_tpu_torch.ops.window_sampling import window_bilinear, window_bilinear_plain

    w, xy, v = _problem(512, c, win_h, win_w, s, dtype)
    before = cuda_sampling.LAUNCHES
    out = window_bilinear(w, xy, v)
    torch.cuda.synchronize()
    assert cuda_sampling.LAUNCHES == before + 1
    ref = window_bilinear_plain(w, xy, v)
    assert torch.equal(torch.isnan(out), torch.isnan(ref))
    ok = ~torch.isnan(ref)
    scale = w.abs().max().item() if dtype == torch.float32 else 1.0
    assert (out[ok] - ref[ok]).abs().max().item() <= bound * scale


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 1e-5), (torch.float64, 1e-12)])
@pytest.mark.parametrize("tile", [1, 2, 4, 8])
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_tiled_kernel_matches_plain(cuda, dtype, bound, tile, threads):
    """Every variant of the sweep, at the per-frame shape, a rectangular
    window and a joint chunk's S = 160 (N = 509 leaves a ragged last tile)."""
    from mba_vo_tpu_torch.ops import cuda_sampling
    from mba_vo_tpu_torch.ops.window_sampling import window_bilinear_plain

    for c, win_h, win_w, s in [(3, 32, 32, 40), (1, 20, 32, 40), (3, 32, 32, 160)]:
        w, xy, v = _problem(509, c, win_h, win_w, s, dtype)
        before = cuda_sampling.LAUNCHES_TILED
        out = cuda_sampling.window_bilinear_tiled_cuda(w, xy, v, tile, threads)
        torch.cuda.synchronize()
        assert cuda_sampling.LAUNCHES_TILED == before + 1
        ref = window_bilinear_plain(w, xy, v)
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        ok = ~torch.isnan(ref)
        scale = w.abs().max().item() if dtype == torch.float32 else 1.0
        assert (out[ok] - ref[ok]).abs().max().item() <= bound * scale


def test_a_call_recorded_into_a_graph_counts_no_launch(cuda):
    """During a CUDA graph capture a wrapper records its kernel and launches
    nothing, so its count stays; the replay computes the same output. K1-v's
    ring in float64 at [3, 32, 32] and S = 40 is 51,200 bytes of shared
    memory: the opt-in above 48 KB is made inside the capture too."""
    from mba_vo_tpu_torch.ops import cuda_sampling as cs

    w, xy, v = _problem(64, 3, 32, 32, 40, torch.float64)
    ref_k1 = cs.window_bilinear_cuda(w, xy, v)
    ref_tiled = cs.window_bilinear_tiled_cuda(w, xy, v, 8, 256)
    torch.cuda.synchronize()
    before = (cs.LAUNCHES, cs.LAUNCHES_TILED)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_k1 = cs.window_bilinear_cuda(w, xy, v)
        out_tiled = cs.window_bilinear_tiled_cuda(w, xy, v, 8, 256)
    assert (cs.LAUNCHES, cs.LAUNCHES_TILED) == before
    graph.replay()
    torch.cuda.synchronize()
    for out, ref in ((out_k1, ref_k1), (out_tiled, ref_tiled)):
        assert torch.equal(torch.isnan(out), torch.isnan(ref)) and torch.isnan(ref).any()
        assert torch.equal(torch.nan_to_num(out), torch.nan_to_num(ref))
    assert (cs.LAUNCHES, cs.LAUNCHES_TILED) == before


def test_tiled_wrapper_checks_its_inputs(cuda):
    from mba_vo_tpu_torch.ops import cuda_sampling
    from mba_vo_tpu_torch.ops.cuda_sampling import window_bilinear_tiled_cuda

    w, xy, v = _problem(40, 3, 32, 32, 6, torch.float32)
    with pytest.raises(ValueError, match="not CUDA"):
        window_bilinear_tiled_cuda(w.cpu(), xy.cpu(), v.cpu(), 4, 128)
    # the ring holds 2 stages of one window, whatever the tile: two windows
    # of [3, 70, 70] doubles are 235,200 bytes, more than a block may use,
    # and the wrapper does not shrink them
    big, bxy, bv = _problem(3, 3, 70, 70, 6, torch.float64)
    need = cuda_sampling.ring_shared_bytes(3, 70, 70, 6, 8)
    before = cuda_sampling.LAUNCHES_TILED
    with pytest.raises(ValueError, match=f"needs {need} bytes of shared memory"):
        window_bilinear_tiled_cuda(big, bxy, bv, 1, 128)
    assert cuda_sampling.LAUNCHES_TILED == before
    window_bilinear_tiled_cuda(big.float(), bxy.float(), bv.float(), 1, 128)   # 117,888 B
    window_bilinear_tiled_cuda(w, xy, v, 19, 128)          # a tile of 19 fits now
    torch.cuda.synchronize()
    for threads in (32, 100):
        with pytest.raises(ValueError, match="threads must be"):
            window_bilinear_tiled_cuda(w, xy, v, 4, threads)
    with pytest.raises(ValueError, match="tile must be"):
        window_bilinear_tiled_cuda(w, xy, v, 0, 128)
    with pytest.raises(ValueError, match="contiguous"):
        window_bilinear_tiled_cuda(w[:, ::2], xy, v, 4, 128)


def test_k1_block_sizes_agree(cuda):
    """K1's threads per block change the launch, not one bit of the result."""
    from mba_vo_tpu_torch.ops.cuda_sampling import window_bilinear_cuda

    w, xy, v = _problem(512, 3, 32, 32, 40, torch.float32)
    ref = torch.nan_to_num(window_bilinear_cuda(w, xy, v), nan=-1.0)
    for threads in (64, 256, 1024):
        out = torch.nan_to_num(window_bilinear_cuda(w, xy, v, threads=threads), nan=-1.0)
        assert torch.equal(out, ref)


def test_multiframe_paths_run_through_the_kernel(cuda):
    """track_frames and track_frames_joint on the card launch K1 and return
    finite poses on the card."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import smooth_shapes_image, synthesize_blurred_image
    from mba_vo_tpu_torch.ops import cuda_sampling
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker, TrackerConfig
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    h, w = 96, 128
    K = np.array([90.0, 90.0, (w - 1) / 2, (h - 1) / 2])
    img = smooth_shapes_image(h, w, sigma=3.0, dtype=np.float64)
    step = np.array([0.004, -0.002, 0.001])
    traj = make_knots(torch.tensor(np.outer(np.arange(8), step)),
                      torch.tensor([[0.0, 0, 0, 1]] * 8, dtype=torch.float64), 0.0, 0.1)
    caps = [0.1 * i for i in range(1, 5)]
    blurred = [synthesize_blurred_image(torch.tensor(img), traj, 2, c, 0.03, 5, 2.0,
                                        torch.tensor(K)).numpy() for c in caps]
    cfg = TrackerConfig(num_pyramid_levels=2, num_virtual_poses=(5, 5), max_num_iterations=6,
                        detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                                 max_keypoints=128))
    for method in ("track_frames", "track_frames_joint"):
        tracker = BlurAwareTracker(cfg, K, (h, w), device="cuda")
        tracker.track_frame(img, img, 0.0, 0.03, np.full((h, w), 2.0))
        before = cuda_sampling.LAUNCHES
        poses = getattr(tracker, method)(blurred, caps, [0.03] * 4, chunk=4)
        torch.cuda.synchronize()
        assert cuda_sampling.LAUNCHES > before
        assert len(poses) == 4 and all(p.t.is_cuda and torch.isfinite(p.t).all() for p in poses)
        assert float((poses[-1].t.cpu() - torch.tensor(4 * step)).abs().max()) < 2e-3


def test_wrapper_checks_its_inputs(cuda):
    from mba_vo_tpu_torch.ops.cuda_sampling import window_bilinear_cuda

    w, xy, v = _problem(4, 3, 8, 8, 6, torch.float32)
    with pytest.raises(ValueError, match="local_xy is torch.float64"):
        window_bilinear_cuda(w, xy.double(), v)
    with pytest.raises(ValueError, match="contiguous"):
        window_bilinear_cuda(w[:, ::2], xy, v)
    with pytest.raises(ValueError, match="valid"):
        window_bilinear_cuda(w, xy, v[:, :3].contiguous())
    with pytest.raises(ValueError, match="unsupported dtype"):
        window_bilinear_cuda(w.half(), xy.half(), v.half())


def test_tracker_runs_through_the_kernel(cuda):
    """A few frames of the tracker on the card launch K1."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import smooth_shapes_image, synthesize_blurred_image
    from mba_vo_tpu_torch.ops import cuda_sampling
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker, TrackerConfig
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    h, w = 96, 128
    K = np.array([90.0, 90.0, (w - 1) / 2, (h - 1) / 2])
    img = smooth_shapes_image(h, w, sigma=3.0, dtype=np.float64)
    traj = make_knots(torch.tensor([[0.0, 0, 0], [0.004, -0.002, 0.001]], dtype=torch.float64),
                      torch.tensor([[0.0, 0, 0, 1], [0.0, 0, 0, 1]], dtype=torch.float64),
                      0.0, 0.1)
    cfg = TrackerConfig(num_pyramid_levels=2, num_virtual_poses=(5, 5),
                        detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                                 max_keypoints=128))
    tracker = BlurAwareTracker(cfg, K, (h, w), device="cuda")
    tracker.track_frame(img, img, 0.0, 0.03, np.full((h, w), 2.0))
    before = cuda_sampling.LAUNCHES
    blur = synthesize_blurred_image(torch.tensor(img), traj, 2, 0.1, 0.03, 5, 2.0,
                                    torch.tensor(K)).numpy()
    pose = tracker.track_frame(None, blur, 0.1, 0.03)
    torch.cuda.synchronize()
    assert cuda_sampling.LAUNCHES > before
    assert pose.t.is_cuda and torch.isfinite(pose.t).all()


# ------------------------------------------------ the redesigned samplers


def _kernels():
    """(name, fn) of both designs of K1 and of K1-v, K1-v at a tile of 1,
    a tile that leaves a ragged last tile and a tile of 8."""
    from mba_vo_tpu_torch.ops import cuda_sampling as cs

    return [
        ("K1", lambda w, xy, v: cs.window_bilinear_cuda(w, xy, v)),
        ("K1 band", lambda w, xy, v: cs.window_bilinear_band_cuda(w, xy, v)),
        ("K1-v tile=1", lambda w, xy, v: cs.window_bilinear_tiled_cuda(w, xy, v, 1, 64)),
        ("K1-v tile=3", lambda w, xy, v: cs.window_bilinear_tiled_cuda(w, xy, v, 3, 128)),
        ("K1-v tile=8", lambda w, xy, v: cs.window_bilinear_tiled_cuda(w, xy, v, 8, 256)),
        ("K1-v staged", lambda w, xy, v: cs.window_bilinear_staged_cuda(
            w.contiguous(), xy, v, 2, 128)),
    ]


def _hold(w, xy, v, label=""):
    """Every kernel against the plain version: NaN positions equal, f32
    within 1e-5 max|W|, f64 within 1e-12; returns the outputs by name."""
    from mba_vo_tpu_torch.ops.window_sampling import window_bilinear_plain

    ref = window_bilinear_plain(w, xy, v)
    bound = 1e-5 * w.abs().max().item() if w.dtype == torch.float32 else 1e-12
    outs = {}
    for name, fn in _kernels():
        out = fn(w, xy, v)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(out), torch.isnan(ref)), f"{label} {name}"
        ok = ~torch.isnan(ref)
        err = (out[ok] - ref[ok]).abs().max().item() if ok.any() else 0.0
        assert err <= bound, f"{label} {name}: {err} > {bound}"
        outs[name] = out
    return outs


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("win_h,win_w", [(32, 32), (20, 32), (20, 30)])
@pytest.mark.parametrize("c", [1, 3])
def test_redesigned_kernels_match_plain(cuda, dtype, win_h, win_w, c):
    """Both designs of K1 and K1-v at S = 1, 40, 160 and 320 on windows
    whose bands the bulk copy takes (32x32, 20x32) and does not (20x30: rows
    of 120 bytes), N = 509 (a ragged last tile)."""
    for s in (1, 40, 160, 320):
        w, xy, v = _problem(509, c, win_h, win_w, max(s, 6), dtype, seed=s)
        _hold(w, xy[:, :s].contiguous(), v[:, :s].contiguous(), f"S={s}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_redesigned_kernels_edge_cases(cuda, dtype):
    """The strided C = 1 slice read in place, all-zero valid, coordinates
    off K1's band (rows 0-4 and 27-31) and off the window, windows smaller
    than the band or with planes of odd size."""
    from mba_vo_tpu_torch.ops import cuda_sampling as cs
    from mba_vo_tpu_torch.ops.window_sampling import sample_windows, window_bilinear_plain

    w, xy, v = _problem(512, 3, 32, 32, 40, dtype)
    _hold(w[:, :1], xy, v, "C=1 slice")
    before = cs.LAUNCHES
    one = sample_windows(w, xy, v)
    assert cs.LAUNCHES == before + 1
    ref = window_bilinear_plain(w[:, :1], xy, v)[:, 0]
    assert torch.equal(torch.isnan(one), torch.isnan(ref))
    for out in _hold(w, xy, torch.zeros_like(v), "all-zero valid").values():
        assert bool((out[~torch.isnan(out)] == 0).all())
    rng = np.random.default_rng(5)
    far = xy.clone()
    far[..., 1] = torch.tensor(np.where(rng.random((512, 40)) < 0.5,
                                        rng.uniform(-1.5, 4.0, (512, 40)),
                                        rng.uniform(27.0, 32.5, (512, 40))), dtype=dtype)
    far[:, ::7] += 40.0
    _hold(w, far, v, "off the band")
    for shape in ((6, 9), (21, 31), (5, 7)):
        sw, sxy, sv = _problem(64, 3, *shape, 40, dtype, seed=shape[0])
        _hold(sw, sxy, sv, f"{shape}")


def test_band_design_agrees_with_k1_bit_for_bit(cuda):
    """K1's band design keeps the arithmetic of the design the tracker
    launches: the two agree bit for bit (NaN where the other is NaN), in
    float32 and float64, with and without its bands' bulk copies (20x30
    rows of 120 bytes are staged with ordinary loads)."""
    from mba_vo_tpu_torch.ops import cuda_sampling as cs

    report = []
    for dtype in (torch.float32, torch.float64):
        for c, h, w_, s in ((3, 32, 32, 40), (1, 32, 32, 40), (3, 32, 32, 160), (3, 20, 30, 40)):
            w, xy, v = _problem(512, c, h, w_, s, dtype)
            k1 = cs.window_bilinear_cuda(w, xy, v)
            band = cs.window_bilinear_band_cuda(w, xy, v)
            torch.cuda.synchronize()
            assert torch.equal(torch.isnan(band), torch.isnan(k1))
            assert torch.equal(band.nan_to_num(), k1.nan_to_num()), (dtype, c, h, w_, s)
            report.append(f"{dtype} C={c} {h}x{w_} S={s}")
    print("bit for bit: " + "; ".join(report))


def test_trackers_recorded_inputs(cuda):
    """The sampler calls of a few tracked frames on the card, recorded and
    replayed through every kernel against the plain version."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import smooth_shapes_image, synthesize_blurred_image
    from mba_vo_tpu_torch.experiments import kernel_variants as kv
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker, TrackerConfig
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    h, w = 96, 128
    K = np.array([90.0, 90.0, (w - 1) / 2, (h - 1) / 2])
    img = smooth_shapes_image(h, w, sigma=3.0, dtype=np.float64)
    step = np.array([0.004, -0.002, 0.001])
    traj = make_knots(torch.tensor(np.outer(np.arange(6), step)),
                      torch.tensor([[0.0, 0, 0, 1]] * 6, dtype=torch.float64), 0.0, 0.1)
    for dtype in ("float32", "float64"):
        cfg = TrackerConfig(num_pyramid_levels=2, num_virtual_poses=(5, 5), dtype=dtype,
                            detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                                     max_keypoints=128))
        tracker = BlurAwareTracker(cfg, K, (h, w), device="cuda")
        tracker.track_frame(img, img, 0.0, 0.03, np.full((h, w), 2.0))
        with kv.record_sampler_calls() as calls:
            for i in (1, 2, 3):
                blur = synthesize_blurred_image(torch.tensor(img), traj, 2, 0.1 * i, 0.03, 5,
                                                2.0, torch.tensor(K)).numpy()
                tracker.track_frame(None, blur, 0.1 * i, 0.03)
        assert len(calls) >= 6 and {c.level for c in calls} == {0, 1}
        for i, call in enumerate(calls):
            assert call.windows.is_cuda
            _hold(*call.args, f"{dtype} call {i}")
