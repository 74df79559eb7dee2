"""Kernels K1 (csrc/window_bilinear.cu) and K1-v
(csrc/window_bilinear_tiled.cu) against the plain PyTorch version, on the
card. Every test here carries the ``cuda`` marker and skips where no
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
    nothing, so its count stays; the replay computes the same output. Tile 8
    in float64 is 196,608 bytes of shared memory: the opt-in above 48 KB is
    made inside the capture too."""
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
    # 19 windows of [3, 32, 32] floats are 233,472 bytes: one block cannot
    # hold them, and the wrapper does not shrink the tile
    before = cuda_sampling.LAUNCHES_TILED
    with pytest.raises(ValueError, match="233472 bytes of shared memory"):
        window_bilinear_tiled_cuda(w, xy, v, 19, 128)
    with pytest.raises(ValueError, match="needs 393216 bytes"):
        window_bilinear_tiled_cuda(w.double(), xy.double(), v.double(), 16, 128)
    assert cuda_sampling.LAUNCHES_TILED == before
    window_bilinear_tiled_cuda(w, xy, v, 18, 128)          # 221,184 bytes fit
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="threads must be"):
        window_bilinear_tiled_cuda(w, xy, v, 4, 100)
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
