"""Kernels K1 (csrc/window_bilinear.cu: one thread a sample, which the
tracker launches, and the band design) and K1-v
(csrc/window_bilinear_tiled.cu: the ring design and the staged first
design) against the plain PyTorch version, on the card; K2
(csrc/residual_rows.cu: warp_tangents from the knots and its earlier
thread design, blur_rows) and K3 (csrc/normal_equations.cu) against
theirs, warp_tangents against the old path (the torch chain of the pose
Jacobian, then the thread design) on the tracker's shapes, and the new
designs of blur_rows and K3 against their earlier designs, bit for bit, on
edge shapes; the patch layout K5 (csrc/frame_layout.cu) and the direct
path's sampler K4 (csrc/image_bilinear.cu) against their plain versions bit
for bit, K5's staged design against its serial design and K4's select
design (at every block shape, and its interleaved row) against its branch
design bit for bit on edge shapes, and the direct path on the kernels
against its plain chain; the LM's kernels K6-K8 (csrc/lm_step.cu) against
its plain stages, and the joint path's knot prior K9
(csrc/knot_prior.cu) against its plain version, bit for bit as the
target, directly and through a level's binding, with the joint tracker's
K9 launches. Every test here carries the ``cuda`` marker and
skips where no CUDA device is visible.

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


# ------------------------------------------------------------- the backend


def _ba_arrays(W=7, M=512, seed=0):
    """A window of W cameras over M landmark slots (60 live) with noisy
    observations, odometry priors and perturbed starts (numpy only)."""
    rng = np.random.default_rng(seed)
    live = 60
    X = np.stack([rng.uniform(-1.5, 1.5, M), rng.uniform(-1, 1, M), rng.uniform(3, 6, M)], -1)
    ts = np.stack([[0.15 * w, 0.02 * w, 0.05 * w] for w in range(W)])
    K = np.array([400.0, 400.0, 319.5, 239.5])
    obs = np.stack([np.stack([(X[:, 0] - t[0]) / (X[:, 2] - t[2]) * K[0] + K[2],
                              (X[:, 1] - t[1]) / (X[:, 2] - t[2]) * K[1] + K[3]], -1)
                    for t in ts]) + rng.normal(0, 0.5, (W, M, 2))
    point_mask = (np.arange(M) < live).astype(np.float64)
    obs_mask = (rng.random((W, M)) > 0.2) * point_mask[None]
    q = np.tile([0.0, 0.0, 0.0, 1.0], (W, 1))
    odom = (np.diff(ts, axis=0) + rng.normal(0, 1e-3, (W - 1, 3)),
            np.tile([0.0, 0.0, 0.0, 1.0], (W - 1, 1)), np.full(W - 1, 1e3))
    return dict(pose_t=ts + rng.normal(0, 0.02, ts.shape) * (np.arange(W) > 0)[:, None],
                pose_q=q, points=X + rng.normal(0, 0.05, X.shape), obs_xy=obs,
                obs_mask=obs_mask, K=K, point_mask=point_mask, odom=odom,
                pose_mask=np.ones(W))


def test_backend_solvers_f64_cuda_match_cpu(cuda):
    """BA at window 7 with 512 landmark slots, the pose graph at 64 nodes and
    PnP: float64 on the card against the CPU, iteration counts exact."""
    from mba_vo_tpu_torch import interop
    from mba_vo_tpu_torch.backend import ba, geometry, pose_graph
    from mba_vo_tpu_torch.core.transform import Pose

    a = _ba_arrays()
    runs = [ba.run_bundle_adjustment(interop.ba_problem_from_arrays(**a, device=d),
                                     ba.BAOptions()) for d in ("cuda", "cpu")]
    (rc, sc), (rh, sh) = runs
    assert sc.num_iterations == sh.num_iterations
    for x, y in ((rc.poses.t, rh.poses.t), (rc.map.points, rh.map.points)):
        assert (x.cpu() - y).abs().max().item() <= 1e-8

    rng = np.random.default_rng(1)
    n = 64
    t = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (n, 1))
    i = np.concatenate([np.arange(n - 1), [0, 5]])
    j = np.concatenate([np.arange(1, n), [n - 1, n - 2]])
    t_ij = t[j] - t[i] + rng.normal(0, 0.01, (len(i), 3))
    w = np.concatenate([np.ones(n - 1), [5.0, 5.0]])
    outs = []
    for d in ("cuda", "cpu"):
        e = interop.pose_graph_edges_from_arrays(i, j, t_ij, np.tile(q[:1], (len(i), 1)), w,
                                                 device=d)
        outs.append(pose_graph.optimize_pose_graph_counted(
            Pose(*(torch.tensor(x, dtype=torch.float64, device=d) for x in (t, q))), e))
    assert outs[0][2] == outs[1][2]
    assert (outs[0][0].t.cpu() - outs[1][0].t).abs().max().item() <= 1e-8

    pts = a["points"][:60] - np.array([0.3, 0.0, 0.0])
    obs = a["obs_xy"][2, :60]
    poses = []
    for d in ("cuda", "cpu"):
        f = lambda x: torch.tensor(x, dtype=torch.float64, device=d)  # noqa: E731
        p, c = geometry.solve_pnp(f(pts), f(obs), f(np.ones(60)), f(a["K"]),
                                  Pose(f([0.0, 0.0, 0.0]), f([0.0, 0.0, 0.0, 1.0])))
        poses.append(torch.cat([p.t, p.q]).cpu())
    assert (poses[0] - poses[1]).abs().max().item() <= 1e-8


def test_match_ties_take_the_first_index_on_cuda(cuda):
    """Duplicated descriptors make exact Hamming ties; torch.argmin on the
    card returns the first index of a tie as on the CPU (and as jnp.argmin)."""
    from mba_vo_tpu_torch.tracker.sparse_features import SparseFeatures, match_descriptors

    rng = np.random.default_rng(0)
    base = np.where(rng.random((8, 256)) < 0.5, 1.0, -1.0)
    a, b = base[rng.integers(0, 8, 300)], base[rng.integers(0, 8, 300)].copy()
    b[::3, :2] *= -1
    outs = []
    for d in ("cuda", "cpu"):
        f = lambda x: torch.tensor(x, dtype=torch.float32, device=d)  # noqa: E731
        mk = lambda desc: SparseFeatures(f(np.zeros((300, 2))), f(np.ones(300)),  # noqa: E731
                                         f(np.ones(300)), f(np.zeros(300)), f(desc))
        m, dist = match_descriptors(mk(a), mk(b), 96.0, 1.0)
        outs.append((m.cpu(), dist.cpu()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    ham = torch.cdist(torch.tensor(a), torch.tensor(b), p=1) / 2
    first = torch.argmin(ham, dim=1)
    assert bool((ham == ham.min(dim=1, keepdim=True).values).sum(dim=1).gt(1).any())
    assert torch.equal(torch.argmin(ham.cuda(), dim=1).cpu(), first)


def _cameras(device, dtype):
    from mba_vo_tpu_torch.models.camera import PinholeCamera, RadTanDistortion, UnifiedCamera

    K = torch.tensor([480.0, 480.0, 319.5, 239.5], dtype=dtype, device=device)
    dist = RadTanDistortion(*(torch.tensor(c, dtype=dtype, device=device)
                              for c in (-0.12, 0.04, 0.001, -0.002)))
    return (PinholeCamera(K=K, height=480, width=640, distortion=dist),
            UnifiedCamera(K=K, xi=torch.tensor(0.8, dtype=dtype, device=device), height=480,
                          width=640),
            PinholeCamera(K=K, height=480, width=640))


def test_undistort_map_and_remap_cuda_match_cpu(cuda):
    """The VGA undistortion maps (rad-tan pinhole, unified) in float64 on
    the card equal the CPU's to 1e-10 px; the remap of an image through
    them to 1e-9 grey levels, and through the rounded map (depth's nearest
    neighbour) exactly."""
    from mba_vo_tpu_torch.ops.image import build_undistort_map, remap

    gpu, cpu = _cameras(cuda, torch.float64), _cameras("cpu", torch.float64)
    img = torch.tensor(np.random.default_rng(2).uniform(0, 255, (480, 640)))
    for g, c in zip(gpu[:2], cpu[:2]):
        mg, mc = build_undistort_map(g, gpu[2]), build_undistort_map(c, cpu[2])
        assert mg.device.type == "cuda"
        assert (mg.cpu() - mc).abs().max().item() <= 1e-10
        assert (remap(img.to(cuda), mg).cpu() - remap(img, mc)).abs().max().item() <= 1e-9
        mg_nn, mc_nn = torch.round(mg), torch.round(mc)
        same = (mg_nn.cpu() == mc_nn).all(dim=-1)
        assert torch.equal(remap(img.to(cuda), mg_nn).cpu()[same], remap(img, mc_nn)[same])


def test_scene_render_cuda_matches_cpu(cuda):
    """A batch of renders of the default scene at 120 x 160, float64: the
    card's depth equals the CPU's to 1e-10 and the image to 1e-10 relative
    (sin on the card and the CPU differ in the last bit)."""
    from mba_vo_tpu_torch.data import scene3d

    tex = np.random.default_rng(5).uniform(0, 255, (120, 160))
    K = np.array([120.0, 120.0, 79.5, 59.5])
    pt = np.array([[0.0, 0.0, 0.0], [0.02, -0.01, 0.015]])
    pq = np.array([[0.0, 0.0, 0.0, 1.0], [0.002, -0.004, 0.003, 1.0]])
    pq /= np.linalg.norm(pq, axis=1, keepdims=True)
    out = []
    for dev in (cuda, torch.device("cpu")):
        s = scene3d.default_scene(tex, dtype=torch.float64, device=dev)
        f = lambda a: torch.tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        out.append([x.cpu() for x in scene3d.render_scene(s, f(pt), f(pq), f(K), 120, 160)])
    (ig, zg), (ic, zc) = out
    assert (zg - zc).abs().max().item() <= 1e-10
    assert ((ig - ic).abs() / ic.abs()).max().item() <= 1e-10


# --------------------------------------- K2 (residual rows) and K3 (normal equations)

# (frames, virtual poses, knot tangents): the per-frame path, a joint chunk
# of 4 at degree 4, a joint chunk of 8 at degree 4
K2_SHAPES = [(1, 5, 12), (4, 5, 42), (8, 5, 66)]


def _k2_problem(F, V, D, dtype, N=512, P=8, H=480, W=640, seed=0):
    """Inputs of warp_tangents' thread design as the tracker gives them:
    poses near the identity, pixels around the keypoints (some off the
    image, one NaN), window corners, random pose tangents."""
    rng = np.random.default_rng(seed)
    q = np.concatenate([rng.normal(0, 0.01, (F, V, 3)), np.ones((F, V, 1))], -1)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    kp = rng.uniform([-10, -10], [W + 10, H + 10], (N, 2))
    pix = np.floor(kp)[None, :, None, :] + rng.integers(-2, 3, (F, N, P, 2))
    pix[0, 3, 2, 0] = np.nan
    starts = np.clip(np.floor(kp) - 16, 0, [W - 32, H - 32]).astype(np.int64)
    t = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    return (t(rng.normal(0, 0.02, (F, V, 3))), t(q), t(rng.normal(0, 1, (D, F, V, 7))),
            t(rng.uniform(1.5, 2.5, N)), t([480.0, 480.0, 319.5, 239.5]), t(pix),
            torch.tensor(starts, device="cuda"), H, W)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("F,V,D", K2_SHAPES)
def test_k2_matches_plain(cuda, dtype, F, V, D):
    """warp_tangents' thread design (the sweep row, from given poses) and
    blur_rows (masked and affine) against their plain versions, within
    experiments/residual_kernels.py's tolerances; each wrapper counts one
    launch a call."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr
    from mba_vo_tpu_torch.ops import residual as tres

    args = _k2_problem(F, V, D, dtype)
    before = cr.LAUNCHES_WARP_THREADS
    rk.hold(rk.ResidualCall("warp_tangents_threads", args, None))
    torch.cuda.synchronize()
    assert cr.LAUNCHES_WARP_THREADS == before + 1
    loc, vs, dxy = tres.warp_tangents_threads_plain(*args)
    assert 0 < vs.mean().item() < 1 and torch.isnan(loc).any()

    rng = np.random.default_rng(1)
    N, S = vs.shape
    P = S // (F * V)
    samples = torch.tensor(rng.normal(0, 50, (N, 3, S)), dtype=dtype, device="cuda")
    samples[:, :, 7] = samples[:, :, 7] * vs[:, 7, None]
    samples[2, :, 9] = float("nan")
    obs = torch.tensor(rng.normal(100, 30, (F, N, P)), dtype=dtype, device="cuda")
    valid = torch.tensor(rng.uniform(size=(F, N, P)) > 0.2, device="cuda")
    valid[:, 2] = False   # the NaN sample's keypoint: masked to 0
    valid[0, 3, 2] = True   # the NaN pixel (its dxy is NaN): NaN rows
    val, gx, gy = samples[:, 0], samples[:, 1], samples[:, 2]
    for affine in (False, True):
        before = cr.LAUNCHES_BLUR
        rk.hold(rk.ResidualCall("blur_rows", (val, gx, gy, dxy, obs, valid, V, affine), None))
        torch.cuda.synchronize()
        assert cr.LAUNCHES_BLUR == before + 1
        r, J = tres.blur_rows(val, gx, gy, dxy, obs, valid, V, affine)
        assert r.is_contiguous() and J.is_contiguous() and J.shape == (F, N, P, D)
        assert torch.isnan(J[0, 3, 2]).all()
        assert bool(torch.isnan(r[:, 2]).any()) == bool(torch.isnan(J[:, 2]).any()) == affine


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [12, 42, 66])
def test_k3_matches_plain(cuda, dtype, D):
    """normal_equations against its plain version, plain and compensated,
    with and without J, at M = 4,096-32,768 rows; a run repeats bit for
    bit."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr
    from mba_vo_tpu_torch.ops import residual as tres

    F = {12: 1, 42: 4, 66: 8}[D]
    rng = np.random.default_rng(D)
    N, P = 512, 8
    r = torch.tensor(rng.normal(0, 20, (F, N, P)), dtype=dtype, device="cuda")
    J = torch.tensor(rng.normal(0, 30, (F, N, P, D)), dtype=dtype, device="cuda")
    kp_w = torch.tensor((rng.uniform(size=N) > 0.1).astype(float), dtype=dtype, device="cuda")
    for compensated in (False, True):
        for jac in (J, None):
            before = cr.LAUNCHES_NORMAL
            rk.hold(rk.ResidualCall("normal_equations", (r, jac, kp_w, 20.0, compensated),
                                    None))
            got = tres.normal_equations(r, jac, kp_w, 20.0, compensated)
            again = tres.normal_equations(r, jac, kp_w, 20.0, compensated)
            torch.cuda.synchronize()
            assert cr.LAUNCHES_NORMAL == before + 3
            for o, a in zip(got, again):
                assert (o is None and a is None) or torch.equal(o, a)
            if jac is not None:
                assert torch.equal(got[3], got[3].T)


def test_k2_k3_wrappers_check_their_inputs(cuda):
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    args = list(_k2_problem(1, 5, 12, torch.float32, N=16))
    warp = cr.warp_tangents_threads_cuda
    with pytest.raises(ValueError, match="pose_q is torch.float64"):
        warp(*args[:1], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="not CUDA"):
        warp(args[0].cpu(), *args[1:])
    with pytest.raises(ValueError, match="pix must be"):
        warp(*args[:5], args[5][:, :8].contiguous(), *args[6:])
    with pytest.raises(ValueError, match="starts is torch.int32"):
        warp(*args[:6], args[6].int(), *args[7:])
    with pytest.raises(ValueError, match="unsupported dtype"):
        warp(*(a.half() if torch.is_tensor(a) and a.is_floating_point() else a for a in args))
    big = torch.zeros((cr.MAX_TANGENTS + 1, 1, 5, 7), device="cuda")
    with pytest.raises(ValueError, match="MAX_TANGENTS"):
        warp(*args[:2], big, *args[3:])
    loc, vs, dxy = warp(*args)
    samples = torch.zeros((16, 3, 40), device="cuda")
    obs = torch.zeros((1, 16, 8), device="cuda")
    valid = torch.ones((1, 16, 8), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="valid is torch.float32"):
        cr.blur_rows_cuda(samples[:, 0], samples[:, 1], samples[:, 2], dxy, obs,
                          valid.float(), 5, False)
    with pytest.raises(ValueError, match="gx must be"):
        cr.blur_rows_cuda(samples[:, 0], samples[:, 1, ::2], samples[:, 2], dxy, obs, valid,
                          5, False)
    with pytest.raises(ValueError, match="dxy must be"):
        cr.blur_rows_cuda(samples[:, 0], samples[:, 1], samples[:, 2],
                          dxy[..., :20].contiguous(), obs, valid, 5, False)
    r = torch.zeros((1, 16, 8), device="cuda")
    with pytest.raises(ValueError, match="kp_w must be"):
        cr.normal_equations_cuda(r, None, torch.ones(15, device="cuda"), 20.0)
    with pytest.raises(ValueError, match="J is torch.float64"):
        cr.normal_equations_cuda(r, torch.zeros((1, 16, 8, 12), dtype=torch.float64,
                                                device="cuda"), torch.ones(16, device="cuda"),
                                 20.0)
    with pytest.raises(ValueError, match="contiguous"):
        cr.normal_equations_cuda(r, torch.zeros((1, 16, 8, 24), device="cuda")[..., ::2],
                                 torch.ones(16, device="cuda"), 20.0)
    with pytest.raises(ValueError, match="MAX_TANGENTS"):
        cr.normal_equations_cuda(r, torch.zeros((1, 16, 8, cr.MAX_TANGENTS + 1),
                                                device="cuda"), torch.ones(16, device="cuda"),
                                 20.0)


def test_tracker_runs_through_k2_and_k3(cuda):
    """track_frame, track_frames and track_frames_joint on the card launch
    K2's two entries and K3, and still K1, once each an LM evaluation; the
    tracker's recorded calls of each (and of the layout K5) equal the plain
    version, and those of blur_rows and K3 their earlier designs bit for
    bit."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import smooth_shapes_image, synthesize_blurred_image
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr
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
    for dtype, degree in (("float32", 2), ("float64", 4)):
        cfg = TrackerConfig(num_pyramid_levels=2, num_virtual_poses=(5, 5), dtype=dtype,
                            spline_degree=degree, max_num_iterations=6,
                            detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                                     max_keypoints=128))
        for method in ("track_frame", "track_frames", "track_frames_joint"):
            tracker = BlurAwareTracker(cfg, K, (h, w), device="cuda")
            tracker.track_frame(img, img, 0.0, 0.03, np.full((h, w), 2.0))
            counts = [cuda_sampling.LAUNCHES, cr.LAUNCHES_WARP, cr.LAUNCHES_BLUR,
                      cr.LAUNCHES_NORMAL]
            with rk.record_residual_calls() as calls:
                if method == "track_frame":
                    poses = [tracker.track_frame(None, b, c, 0.03)
                             for b, c in zip(blurred, caps)]
                else:
                    poses = getattr(tracker, method)(blurred, caps, [0.03] * 4, chunk=4)
            torch.cuda.synchronize()
            k1, warp, blur, normal = (now - then for now, then in zip(
                [cuda_sampling.LAUNCHES, cr.LAUNCHES_WARP, cr.LAUNCHES_BLUR,
                 cr.LAUNCHES_NORMAL], counts))
            assert k1 > 0 and warp == blur == k1 and normal >= k1
            assert len(poses) == 4 and all(torch.isfinite(p.t).all() for p in poses)
            # the windowed path launches every kernel of the residual stage
            # but the direct path's sampler K4
            assert not calls["image_bilinear_lk"]
            for kernel in rk.KERNELS[:4]:
                # warp_tangents' and the layout's first argument is the knots
                assert calls[kernel] and all(
                    (c.args[0].t if kernel in ("warp_tangents", "prepare_frame_layout")
                     else c.args[0]).is_cuda for c in calls[kernel])
                for call in calls[kernel]:
                    rk.hold(call)
                    assert rk.hold_earlier(call) == (kernel in rk.EARLIER)
            # a frame's window has `degree` knots, a joint chunk's chunk + degree - 1
            D = {c.tangents for c in calls["warp_tangents"]}
            if method == "track_frames_joint":
                assert 6 * (3 + degree) in D, D
            else:
                assert D == {6 * degree}, D


# K3's edge shapes (F, N, P): M = 9 (below 16 chunks), 35 (parts of one
# row), 518 (ragged chunks and parts, tiles not multiples of 32 rows), 4,096
# (the frame's) in one cluster of the 16 chunks' CTAs; past CLUSTER_ROWS, a
# CTA a part: 8,193 (ragged chunks and parts; kp_w not staged in float64)
# and 32,768 (a joint chunk of 8 frames: parts of 8 tiles, which one step
# covers only in part where D is large)
K3_ROWS = [(1, 3, 3), (1, 7, 5), (2, 37, 7), (1, 512, 8), (1, 2731, 3), (8, 512, 8)]


def _k3_inputs(F, N, P, D, dtype, seed, zero_weights=False, offset=0):
    """r, J and kp_w on the card; with ``offset`` r and J start that many
    elements into their storage, so that their runs' ends are not 16-byte
    aligned."""
    rng = np.random.default_rng(seed)
    M = F * N * P

    def tensor(a):
        flat = torch.zeros(a.size + offset, dtype=dtype, device="cuda")
        flat[offset:] = torch.tensor(a.reshape(-1), dtype=dtype, device="cuda")
        return flat[offset:].view(a.shape)

    r = tensor(rng.normal(0, 20, (F, N, P)))
    J = tensor(rng.normal(0, 30, (F, N, P, D))) if D else None
    kp_w = (np.zeros(N) if zero_weights else (rng.uniform(size=N) > 0.2).astype(float))
    assert M == r.numel()
    return r, J, torch.tensor(kp_w, dtype=dtype, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [0, 1, 12, 42, 66, 128])
@pytest.mark.parametrize("compensated", [False, True])
def test_k3_cluster_design_equals_split_design(cuda, dtype, D, compensated):
    """The cluster design (one launch), in both its layouts (a cluster of the
    16 chunks' CTAs up to CLUSTER_ROWS rows; 16 clusters of a CTA a part
    past them), equals the split design (two launches) bit for bit and the
    plain version within experiments/residual_kernels.py's tolerance, on M
    below 16 and off multiples of 16 and 32, unaligned rows and every kp_w
    zero; two calls repeat bit for bit; a call counts one launch."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    itemsize = torch.empty((), dtype=dtype).element_size()
    assert {cr.normal_equations_layout(D, itemsize, N, F * N * P).per_chunk
            for F, N, P in K3_ROWS} == {1, cr.SPLIT}
    for i, (F, N, P) in enumerate(K3_ROWS):
        for zero_weights, offset in ((False, 0), (True, 0), (False, 1)):
            args = (*_k3_inputs(F, N, P, D, dtype, i, zero_weights, offset), 20.0, compensated)
            old = cr.normal_equations_split_cuda(*args)
            before = cr.LAUNCHES_NORMAL
            new = cr.normal_equations_cuda(*args)
            again = cr.normal_equations_cuda(*args)
            torch.cuda.synchronize()
            assert cr.LAUNCHES_NORMAL == before + 2
            label = f"M={F * N * P} zero_weights={zero_weights} offset={offset}"
            assert rk.same_bits(new, old), label
            assert rk.same_bits(new, again), label
            if zero_weights:
                assert float(new[0]) == 0.0 and (D == 0 or not new[3].any())
            rk.hold(rk.ResidualCall("normal_equations", args, None))


# blur_rows' edge shapes (F, N, P, V): P not a multiple of 32 (8, 9, 25), V =
# 1, and runs of P V samples whose ends are not 16-byte aligned (9 x 1, 9 x 3)
BLUR_SHAPES = [(1, 37, 8, 5), (3, 11, 9, 1), (2, 13, 25, 3), (1, 64, 9, 3)]


def _blur_inputs(F, N, P, V, D, dtype, seed):
    """K1's samples [N, 3, S] (NaN at invalid pixels of keypoint 1 and at one
    valid pixel), dxy, obs and the mask, on the card."""
    rng = np.random.default_rng(seed)
    S = F * P * V
    samples = torch.tensor(rng.normal(0, 50, (N, 3, S)), dtype=dtype, device="cuda")
    dxy = torch.tensor(rng.normal(0, 2, (2, D, N, S)), dtype=dtype, device="cuda")
    obs = torch.tensor(rng.normal(100, 30, (F, N, P)), dtype=dtype, device="cuda")
    valid = torch.tensor(rng.uniform(size=(F, N, P)) > 0.3, device="cuda")
    valid[:, 1] = False
    samples[1] = float("nan")            # an invalid keypoint whose samples are NaN
    valid[0, 2, 0] = True
    dxy[:, :, 2, :V] = float("nan")      # a valid pixel with NaN tangents
    return samples, dxy, obs, valid


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [0, 1, 12, 42, 66, 128])
@pytest.mark.parametrize("affine", [False, True])
def test_blur_rows_keypoint_design_equals_thread_design(cuda, dtype, D, affine):
    """The keypoint design equals the thread design bit for bit and the plain
    version within experiments/residual_kernels.py's tolerance, its samples
    as K1's interleaved channels, as three contiguous tensors and as three
    views a keypoint stride of 4 S apart; r and J are 0 at invalid pixels
    whose samples are NaN (unless ``affine``); two calls repeat bit for bit;
    a call counts one launch. At D = 128 the tangents of some shapes stream
    in tiles (two stages)."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    itemsize = torch.empty((), dtype=dtype).element_size()
    if D == 128:
        assert any(cr.blur_rows_layout(F, P, V, D, itemsize).stages == 2
                   for F, _, P, V in BLUR_SHAPES)
    for i, (F, N, P, V) in enumerate(BLUR_SHAPES):
        samples, dxy, obs, valid = _blur_inputs(F, N, P, V, D, dtype, i)
        args = (samples[:, 0], samples[:, 1], samples[:, 2], dxy, obs, valid, V, affine)
        # K1's interleaved channels, and three separate [N, S] tensors
        packed = (samples[:, 0].contiguous(), samples[:, 1].contiguous(),
                  samples[:, 2].contiguous(), *args[3:])
        wide = torch.zeros((N, 4, F * P * V), dtype=dtype, device="cuda")
        wide[:, 1:] = samples
        strided = (wide[:, 1], wide[:, 2], wide[:, 3], *args[3:])
        old = cr.blur_rows_threads_cuda(*args)
        for name, a in (("interleaved", args), ("packed", packed), ("strided", strided)):
            before = cr.LAUNCHES_BLUR
            new = cr.blur_rows_cuda(*a)
            again = cr.blur_rows_cuda(*a)
            torch.cuda.synchronize()
            assert cr.LAUNCHES_BLUR == before + 2
            label = f"F={F} N={N} P={P} V={V} {name}"
            assert rk.same_bits(new, old), label
            assert rk.same_bits(new, again), label
        new = cr.blur_rows_cuda(*args)
        r, J = new
        assert bool(torch.isnan(r[:, 1]).all()) == affine, label
        if not affine:
            assert not r[:, 1].any() and not J[:, 1].any(), label
        if D:
            assert torch.isnan(J[0, 2, 0]).all(), label
        rk.hold(rk.ResidualCall("blur_rows", args, None))


def test_k2_k3_calls_recorded_into_a_graph_count_no_launch(cuda):
    """blur_rows and K3, new designs and earlier, recorded into a CUDA graph
    count no launch; the replay gives the eager call's bits."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    samples, dxy, obs, valid = _blur_inputs(2, 64, 8, 5, 42, torch.float32, 0)
    blur = (samples[:, 0], samples[:, 1], samples[:, 2], dxy, obs, valid, 5, False)
    # one cluster of the chunks' CTAs, and a CTA a part (past CLUSTER_ROWS)
    normal = (*_k3_inputs(4, 64, 8, 42, torch.float32, 1), 20.0, True)
    joint = (*_k3_inputs(4, 512, 8, 42, torch.float32, 2), 20.0, True)
    assert 4 * 64 * 8 <= cr.CLUSTER_ROWS < 4 * 512 * 8
    fns = ((cr.blur_rows_cuda, blur), (cr.blur_rows_threads_cuda, blur),
           (cr.normal_equations_cuda, normal), (cr.normal_equations_split_cuda, normal),
           (cr.normal_equations_cuda, joint))
    refs = [fn(*args) for fn, args in fns]
    torch.cuda.synchronize()

    def counts():
        return (cr.launch_counts(), cr.LAUNCHES_WARP_THREADS, cr.LAUNCHES_BLUR_THREADS,
                cr.LAUNCHES_NORMAL_SPLIT)

    before = counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(*args) for fn, args in fns]
    assert counts() == before
    graph.replay()
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert rk.same_bits(out, ref)
    assert counts() == before


def test_k3_calls_on_two_streams_share_the_ticket_in_turn(cuda):
    """Past CLUSTER_ROWS the launches share the device's ticket; calls on two
    streams, made without waiting, run in turn and each gives the bits of
    the split design."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    args = (*_k3_inputs(8, 512, 8, 42, torch.float32, 3), 20.0, True)
    assert cr.normal_equations_layout(42, 4, 512, 8 * 512 * 8).per_chunk == cr.SPLIT
    ref = cr.normal_equations_split_cuda(*args)
    torch.cuda.synchronize()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for i in range(16):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(cr.normal_equations_cuda(*args))
    torch.cuda.synchronize()
    assert all(rk.same_bits(out, ref) for out in outs)


# --------------------------------------------- K2's first entry from the knots

# (knots, degree, frames, virtual poses, float type): the frame's 2 knots at
# degree 2, a joint chunk of 4 (7 knots) and of 8 (11 knots, 6K = 66) at
# degree 4, the last in float64 (the largest tangent table of the bench's
# chunks); V = 1 and a clamped capture time past the spline's end
KNOTS_SHAPES = [(2, 2, 1, 5, torch.float32), (2, 2, 1, 5, torch.float64),
                (7, 4, 4, 5, torch.float32), (7, 4, 4, 5, torch.float64),
                (11, 4, 8, 5, torch.float32), (11, 4, 8, 5, torch.float64),
                (3, 2, 2, 1, torch.float32), (21, 4, 2, 9, torch.float64)]


def _knots_problem(K, degree, F, V, dtype, N=512, P=8, H=480, W=640, seed=0,
                   standing=False, clamped=False):
    """The entry's arguments as the tracker gives them, on the card: a
    moving knot window (identity knots with ``standing``), capture times
    inside its span (past its end with ``clamped``), pixels around the
    keypoints (some off the image), window corners."""
    from mba_vo_tpu_torch.core.spline import make_knots

    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0)
    q = np.concatenate([rng.normal(0, 0.02, (K, 3)), np.ones((K, 1))], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if standing:
        t, q = np.zeros((K, 3)), np.tile([0.0, 0.0, 0.0, 1.0], (K, 1))
    t0, dt = 0.05, 0.1
    caps = t0 + dt * (degree - 1) / 2 + np.sort(rng.uniform(0, dt * (K - degree + 0.5), F))
    if clamped:
        caps[-1] = t0 + dt * (K + 0.5)
    kp = rng.uniform([-3, -3], [W + 3, H + 3], (N, 2))
    if standing:
        kp = np.floor(kp)
        kp[:4] = [[0, 10], [W - 1, 20], [30, 0], [40, H - 1]]
    pix = np.floor(kp)[None, :, None, :] + rng.integers(-2, 3, (F, N, P, 2))
    t_ = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    knots = make_knots(t_(t), t_(q), t0, dt)
    knots = knots._replace(t0=knots.t0.cuda(), dt=knots.dt.cuda())
    return (knots, t_(caps), t_(np.full(F, 0.03)), V, degree, True,
            t_(rng.uniform(1.5, 2.5, N)), t_([480.0, 480.0, (W - 1) / 2, (H - 1) / 2]),
            t_(pix), torch.tensor(np.clip(np.floor(kp) - 16, 0, [W - 32, H - 32]).astype(
                np.int64), device="cuda"), H, W)


@pytest.mark.parametrize("K,degree,F,V,dtype", KNOTS_SHAPES)
def test_knots_entry_matches_plain(cuda, K, degree, F, V, dtype):
    """warp_tangents from the knots against its plain version (the torch
    chain, then the warp) and against the old path (the chain, then the
    thread design), with the tangents and without (D = 0), within
    experiments/residual_kernels.py's tolerances and vs equal entry for
    entry; one launch a call."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    for tangents in (True, False):
        args = list(_knots_problem(K, degree, F, V, dtype, clamped=(V == 1)))
        args[5] = tangents
        call = rk.ResidualCall("warp_tangents", tuple(args), None)
        before = cr.LAUNCHES_WARP
        rk.hold(call)
        assert rk.hold_earlier(call)
        torch.cuda.synchronize()
        assert cr.LAUNCHES_WARP == before + 2
        loc, vs, dxy = cr.warp_tangents_cuda(*args)
        assert dxy.shape == (2, 6 * K if tangents else 0) + tuple(vs.shape)
        assert 0 < vs.mean().item() < 1
        lay = cr.warp_tangents_layout(8, V, 6 * K if tangents else 0, loc.element_size())
        assert lay.smem_bytes <= cr.MAX_SHARED_BYTES


def test_knots_entry_from_a_standing_start(cuda):
    """Identity knots, integer keypoints on the image's border: the
    positions equal the plain version's to the bit and so does every vs
    flag, in float32 and float64."""
    from mba_vo_tpu_torch.ops import cuda_residual as cr
    from mba_vo_tpu_torch.ops import residual as tres

    for dtype in (torch.float32, torch.float64):
        args = _knots_problem(2, 2, 1, 5, dtype, standing=True)
        loc, vs, dxy = cr.warp_tangents_cuda(*args)
        rl, rv, rd = tres.warp_tangents_plain(*args)
        assert torch.equal(loc, rl) and torch.equal(vs, rv)
        assert float((dxy - rd).abs().max()) <= 1e-6 * float(rd.abs().max())


def test_knots_entry_nan_poses(cuda):
    """A NaN knot makes NaN poses where its taps reach: the NaNs fall on the
    plain version's entries exactly, positions and tangents, and their
    samples are out of the image (vs 0)."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    for dtype in (torch.float32, torch.float64):
        args = _knots_problem(7, 4, 4, 5, dtype)
        knots = args[0]
        q = knots.q.clone()
        q[6, 1] = float("nan")
        args = (knots._replace(q=q),) + args[1:]
        call = rk.ResidualCall("warp_tangents", args, None)
        rk.hold(call)
        loc, vs, dxy = rk.kernel_fn("warp_tangents")(*args)
        nan = torch.isnan(loc).any(-1)
        assert nan.any() and not nan.all()
        assert (vs[nan] == 0).all()
        assert torch.isnan(dxy).any()


def test_knots_entry_checks_its_inputs(cuda):
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    args = list(_knots_problem(2, 2, 1, 5, torch.float32, N=16))
    knots = args[0]
    with pytest.raises(ValueError, match="knot_q is torch.float64"):
        cr.warp_tangents_cuda(knots._replace(q=knots.q.double()), *args[1:])
    with pytest.raises(ValueError, match="not CUDA"):
        cr.warp_tangents_cuda(knots._replace(t0=knots.t0.cpu()), *args[1:])
    with pytest.raises(ValueError, match="exp_times must be"):
        cr.warp_tangents_cuda(knots, args[1], args[2][:0], *args[3:])
    with pytest.raises(ValueError, match="pix must be"):
        cr.warp_tangents_cuda(*args[:8], args[8][:, :8].contiguous(), *args[9:])
    with pytest.raises(ValueError, match="contiguous"):
        cr.warp_tangents_cuda(*args[:8], args[8].repeat(1, 1, 1, 2)[..., ::2], *args[9:])
    with pytest.raises(ValueError, match="starts is torch.int32"):
        cr.warp_tangents_cuda(*args[:9], args[9].int(), *args[10:])
    with pytest.raises(ValueError, match="spline degree 3"):
        cr.warp_tangents_cuda(*args[:4], 3, *args[5:])
    with pytest.raises(ValueError, match="spline degree 4 over 2 knots"):
        cr.warp_tangents_cuda(*args[:4], 4, *args[5:])
    wide = knots._replace(t=torch.zeros((22, 3), device="cuda"),
                          q=torch.zeros((22, 4), device="cuda"))
    with pytest.raises(ValueError, match="MAX_TANGENTS"):
        cr.warp_tangents_cuda(wide, *args[1:])
    with pytest.raises(ValueError, match="samples a keypoint"):
        cr.warp_tangents_cuda(*args[:3], 64, *args[4:])
    loc, vs, dxy = cr.warp_tangents_cuda(*args)
    assert dxy.shape == (2, 12, 16, 40)


def test_knots_entry_recorded_into_a_graph(cuda):
    """warp_tangents recorded into a CUDA graph counts no launch (nor does
    the sweep row), and the replay gives the eager call's bits, with and
    without the tangents; the knots are read on the device, so a new knot
    state copied into the graph's tensors moves the replay's result to the
    eager call's at that state."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr

    args = _knots_problem(7, 4, 4, 5, torch.float32)
    no_tangents = args[:5] + (False,) + args[6:]
    threads = rk.chain_args(rk.ResidualCall("warp_tangents", args, None))
    refs = [cr.warp_tangents_cuda(*args), cr.warp_tangents_cuda(*no_tangents),
            cr.warp_tangents_threads_cuda(*threads)]
    torch.cuda.synchronize()
    before = (cr.launch_counts(), cr.LAUNCHES_WARP_THREADS)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [cr.warp_tangents_cuda(*args), cr.warp_tangents_cuda(*no_tangents),
                cr.warp_tangents_threads_cuda(*threads)]
    assert (cr.launch_counts(), cr.LAUNCHES_WARP_THREADS) == before
    graph.replay()
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert rk.same_bits(out, ref)
    knots = args[0]
    knots.t.add_(0.01)
    graph.replay()
    moved = cr.warp_tangents_cuda(*args)
    torch.cuda.synchronize()
    assert rk.same_bits(outs[0], moved) and not rk.same_bits(moved, refs[0])
    assert (cr.launch_counts()["warp_tangents"], cr.LAUNCHES_WARP_THREADS) == (
        before[0]["warp_tangents"] + 1, before[1])


def test_knots_entry_equals_the_old_path_on_the_trackers_calls(cuda):
    """On a tracker's own calls (track_frame at degree 2 in float32, a joint
    chunk at degree 4 in float64), the new entry against the plain version
    and against the old path, every call; compute_residuals_windowed runs
    neither virtual_poses_and_tangents nor sample_virtual_poses itself (the
    patch layout, given here, is where sample_virtual_poses stays)."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import residual as tres

    for dtype, degree in ((torch.float32, 2), (torch.float64, 4)):
        args = _knots_problem(2 if degree == 2 else 7, degree, 1 if degree == 2 else 4, 5,
                              dtype)
        for tangents in (True, False):
            call = rk.ResidualCall("warp_tangents", args[:5] + (tangents,) + args[6:], None)
            rk.hold(call)
            rk.hold_earlier(call)
    # the windowed path, its layout given: no pose chain of its own
    from mba_vo_tpu_torch.core.spline import make_knots

    rng = np.random.default_rng(4)
    h, w, n = 96, 128, 64
    cuda_t = lambda a, dt=torch.float64: torch.tensor(a, dtype=dt, device="cuda")  # noqa
    data = tres.TrackingLevelData(
        img_ref=cuda_t(rng.uniform(0, 255, (h, w))), grad_ref=cuda_t(rng.normal(0, 5, (h, w, 2))),
        cur_imgs=cuda_t(rng.uniform(0, 255, (1, h, w))), cap_times=cuda_t([0.1]),
        exp_times=cuda_t([0.03]), kp_xy=cuda_t(rng.uniform(8, [w - 8, h - 8], (n, 2))),
        kp_z=cuda_t(np.full(n, 2.0)), kp_mask=cuda_t(np.ones(n)),
        pattern=torch.tensor(rng.integers(-2, 3, (8, 2)), device="cuda"),
        K=cuda_t([90.0, 90.0, (w - 1) / 2, (h - 1) / 2]))
    knots = make_knots(cuda_t(rng.normal(0, 0.01, (2, 3))),
                       cuda_t([[0.0, 0, 0, 1], [0.001, 0, 0, 1]]), 0.05, 0.1)
    knots = knots._replace(t0=knots.t0.cuda(), dt=knots.dt.cuda())
    layout = tres.prepare_frame_layout(knots, data, 5, 2)
    chains = []
    saved = {k: getattr(tres, k) for k in ("virtual_poses_and_tangents",
                                             "sample_virtual_poses")}
    try:
        for k, fn in saved.items():
            setattr(tres, k, lambda *a, _k=k, _fn=fn, **kw: chains.append(_k) or _fn(*a, **kw))
        for jac in (True, False):
            tres.compute_residuals_windowed(knots, data, 5, 2, jac, layout=layout)
    finally:
        for k, fn in saved.items():
            setattr(tres, k, fn)
    torch.cuda.synchronize()
    assert chains == []


# ------------------------------------- K5, the patch layout, and K4, the direct
# path's whole-image sampler

# (knots, degree, frames, virtual poses, dtype, case): the frame's 2 knots at
# degree 2, a joint chunk of 4 at degree 4 and of 8 (11 knots) with V = 4
# (the divisor of the exposure's times, 3, has no exact reciprocal); moving,
# from a standing start (integer keypoints on the image's border), and with
# a capture time past the spline's end (the segment index clamps)
LAYOUT_SHAPES = [(2, 2, 1, 5, torch.float32, "moving"), (2, 2, 1, 5, torch.float64, "moving"),
                 (7, 4, 4, 5, torch.float32, "moving"), (7, 4, 4, 5, torch.float64, "moving"),
                 (2, 2, 1, 5, torch.float32, "standing"),
                 (2, 2, 1, 5, torch.float64, "standing"),
                 (7, 4, 4, 5, torch.float64, "standing"),
                 (3, 2, 2, 1, torch.float32, "clamped"),
                 (11, 4, 8, 4, torch.float64, "clamped"),
                 (11, 4, 8, 4, torch.float32, "moving")]


def _layout_problem(K, degree, F, V, dtype, case="moving", N=512, H=480, W=640, seed=0):
    """The layout's arguments as the tracker gives them, on the card:
    (knots, level data, V, degree), the knots moving (identity knots from a
    standing start), capture times inside their span (the last past its end
    where ``clamped``), keypoints around and off the image (integers, some on
    its border, from a standing start), 20 padded slots, the dso8 pattern."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.ops import residual as tres
    from mba_vo_tpu_torch.tracker.patterns import PATTERNS

    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0)
    q = np.concatenate([rng.normal(0, 0.02, (K, 3)), np.ones((K, 1))], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    kp = rng.uniform([-3, -3], [W + 3, H + 3], (N, 2))
    if case == "standing":
        t, q = np.zeros((K, 3)), np.tile([0.0, 0.0, 0.0, 1.0], (K, 1))
        kp = np.floor(kp)
        kp[:4] = [[0, 10], [W - 1, 20], [30, 0], [40, H - 1]]
    t0, dt = 0.05, 0.1
    caps = t0 + dt * (degree - 1) / 2 + np.sort(rng.uniform(0, dt * (K - degree + 0.5), F))
    if case == "clamped":
        caps[-1] = t0 + dt * (K + 0.5)
    mask = np.ones(N)
    mask[-20:] = 0.0
    c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    knots = make_knots(c(t), c(q), t0, dt)
    knots = knots._replace(t0=knots.t0.cuda(), dt=knots.dt.cuda())
    data = tres.TrackingLevelData(
        img_ref=torch.zeros((H, W), dtype=dtype, device="cuda"),
        grad_ref=torch.zeros((H, W, 2), dtype=dtype, device="cuda"),
        cur_imgs=c(rng.uniform(0, 255, (F, H, W))), cap_times=c(caps),
        exp_times=c(np.full(F, 0.03)), kp_xy=c(kp), kp_z=c(rng.uniform(1.5, 2.5, N)),
        kp_mask=c(mask), pattern=torch.as_tensor(PATTERNS["dso8"](), device="cuda"),
        K=c([480.0, 480.0, (W - 1) / 2, (H - 1) / 2]))
    return knots, data, V, degree


def _plain_anchors(knots, data, V, degree):
    """The plain version's patch anchors [F, N, 2] on the card: the mid
    pose of sample_virtual_poses through patch_anchors."""
    from mba_vo_tpu_torch.ops import residual as tres

    pt, pq = tres.sample_virtual_poses(knots, data.cap_times, data.exp_times, V, degree)
    return tres.patch_anchors(pt[:, V // 2], pq[:, V // 2], data.kp_xy, data.kp_z, data.K)


def _kernel_anchors(knots, data, V, degree):
    from mba_vo_tpu_torch.ops import cuda_layout as cl

    H, W = data.img_ref.shape
    return cl.frame_layout_cuda(knots, data.cap_times, data.exp_times, V, degree, data.kp_xy,
                                data.kp_z, data.kp_mask, data.K, data.pattern.int(),
                                data.cur_imgs, H, W, anchors=True)


@pytest.mark.parametrize("K,degree,F,V,dtype,case", LAYOUT_SHAPES)
def test_layout_kernel_matches_plain(cuda, K, degree, F, V, dtype, case):
    """K5's pix, valid and obs equal the plain version run on the card bit
    for bit; one launch a call."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_layout as cl
    from mba_vo_tpu_torch.ops import residual as tres

    args = _layout_problem(K, degree, F, V, dtype, case)
    before = cl.LAUNCHES_LAYOUT
    assert rk.hold(rk.ResidualCall("prepare_frame_layout", args, None)) == (0.0, 0.0)
    torch.cuda.synchronize()
    assert cl.LAUNCHES_LAYOUT == before + 1
    pix, valid, obs = tres.prepare_frame_layout(*args)
    assert pix.dtype == dtype and valid.dtype == torch.bool and obs.dtype == dtype
    assert pix.shape == (F, 512, 8, 2) and 0 < valid.float().mean().item() < 1
    assert not valid[:, -20:].any()


@pytest.mark.parametrize("K,degree,F,V,dtype,case", LAYOUT_SHAPES)
def test_layout_anchors_equal_the_plain_versions(cuda, K, degree, F, V, dtype, case):
    """The anchors K5 floors equal the plain version's on the card bit for
    bit (its mid pose is the one sample_virtual_poses computes), so that no
    integer anchor of a standing start floors onto another pixel."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    args = _layout_problem(K, degree, F, V, dtype, case)
    got = _kernel_anchors(*args)[3]
    ref = _plain_anchors(*args)
    assert rk.same_bits(got, ref), rk._unequal(got, ref)
    if case == "standing":
        # integers up to the last bit: some fall an ulp below theirs
        assert float((ref - ref.round()).abs().max()) < 1e-3
        assert bool((torch.floor(ref) != ref.round()).any())


def test_layout_nan_knots(cuda):
    """A NaN knot makes NaN anchors where its taps reach: the kernel's
    pixels fall on the plain version's NaNs, those pixels are not valid, and
    their observations gather the pixel torch's cast of NaN picks."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import residual as tres

    for dtype in (torch.float32, torch.float64):
        knots, data, V, degree = _layout_problem(7, 4, 4, 5, dtype)
        q = knots.q.clone()
        q[6, 1] = float("nan")
        args = (knots._replace(q=q), data, V, degree)
        rk.hold(rk.ResidualCall("prepare_frame_layout", args, None))
        pix, valid, _ = tres.prepare_frame_layout(*args)
        nan = torch.isnan(pix).any(-1)
        assert nan.any() and not nan.all() and not valid[nan].any()


def test_layout_checks_its_inputs(cuda):
    from mba_vo_tpu_torch.ops import cuda_layout as cl

    knots, d, V, degree = _layout_problem(2, 2, 1, 5, torch.float32, N=16)
    args = [knots, d.cap_times, d.exp_times, V, degree, d.kp_xy, d.kp_z, d.kp_mask, d.K,
            d.pattern.int(), d.cur_imgs, 480, 640]
    with pytest.raises(ValueError, match="knot_q is torch.float64"):
        cl.frame_layout_cuda(knots._replace(q=knots.q.double()), *args[1:])
    with pytest.raises(ValueError, match="not CUDA"):
        cl.frame_layout_cuda(knots._replace(t0=knots.t0.cpu()), *args[1:])
    with pytest.raises(ValueError, match="kp_xy must be"):
        cl.frame_layout_cuda(*args[:5], args[5][:8].contiguous(), *args[6:])
    with pytest.raises(ValueError, match="contiguous"):
        cl.frame_layout_cuda(*args[:5], args[5].t().contiguous().t(), *args[6:])
    with pytest.raises(ValueError, match="pattern must be"):
        cl.frame_layout_cuda(*args[:9], args[9].long(), *args[10:])
    with pytest.raises(ValueError, match="cur_imgs must be"):
        cl.frame_layout_cuda(*args[:10], args[10][0], *args[11:])
    with pytest.raises(ValueError, match="spline degree 3"):
        cl.frame_layout_cuda(*args[:4], 3, *args[5:])
    with pytest.raises(ValueError, match="spline degree 4 over 2 knots"):
        cl.frame_layout_cuda(*args[:4], 4, *args[5:])
    pix, valid, obs = cl.frame_layout_cuda(*args)
    assert pix.shape == (1, 16, 8, 2) and valid.shape == obs.shape == (1, 16, 8)


def _image_problem(N, S, H, W, dtype, seed=0):
    """K4's arguments as the direct path gives them, on the card: a smooth
    image, its gradient image, and whole-image positions over and around it,
    with integer positions, the border x = W - 1 and y = H - 1, the corner
    (0, 0), positions just off each edge, far off the image and NaN."""
    from mba_vo_tpu_torch.ops.image import image_gradients

    rng = np.random.default_rng(seed)
    img = np.cumsum(np.cumsum(rng.normal(0, 1, (H, W)), 0), 1)
    loc = np.stack([rng.uniform(-3, W + 2, (N, S)), rng.uniform(-3, H + 2, (N, S))], -1)
    flat = loc.reshape(-1, 2)
    special = [[W - 1, 5.5], [7.25, H - 1], [W - 1, H - 1], [0, 0], [-1e-7, 3],
               [3, H - 1 + 1e-4], [1e6, -1e6], [np.nan, 4], [4, np.inf], [12, 9]]
    flat[:len(special)] = special[:flat.shape[0]]
    flat[len(special)::7] = np.round(flat[len(special)::7])
    c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    img_t = c(img)
    return img_t, image_gradients(img_t).contiguous(), c(loc)


# (keypoints, samples, image height, width): the frame at level 0 (VGA), a
# joint chunk of 4 at level 1, a tiny ragged block
IMAGE_SHAPES = [(512, 40, 480, 640), (512, 160, 240, 320), (3, 7, 5, 6)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("N,S,H,W", IMAGE_SHAPES)
def test_image_kernel_matches_plain(cuda, dtype, channels, N, S, H, W):
    """K4 against its plain version on the card, bit for bit, C = 3 and
    C = 1; the value of a C = 1 call is the C = 3 call's; one launch a
    call; 0 off the image and at NaN."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_image as ci
    from mba_vo_tpu_torch.ops.image import image_bilinear_lk

    img, grad, loc = _image_problem(N, S, H, W, dtype)
    before = ci.LAUNCHES_IMAGE
    rk.hold(rk.ResidualCall("image_bilinear_lk", (img, grad, loc, channels), None))
    torch.cuda.synchronize()
    assert ci.LAUNCHES_IMAGE == before + 1
    out = image_bilinear_lk(img, grad, loc, channels)
    other = image_bilinear_lk(img, grad, loc, 4 - channels)
    assert rk.same_bits(out[0], other) if channels == 3 else rk.same_bits(out, other[0])
    off = ~((loc[..., 0] >= 0) & (loc[..., 0] <= W - 1) & (loc[..., 1] >= 0)
            & (loc[..., 1] <= H - 1))
    assert off.any() and not off.all()
    for o in (out,) if channels == 1 else out:
        assert o.shape == (N, S) and not torch.isnan(o).any() and (o[off] == 0).all()
    if channels == 3:
        # the channel views of one [N, 3, S] output, as blur_rows reads K1's
        assert out[1].data_ptr() == out[0].data_ptr() + S * out[0].element_size()


def test_image_checks_its_inputs(cuda):
    from mba_vo_tpu_torch.ops import cuda_image as ci

    img, grad, loc = _image_problem(4, 6, 9, 11, torch.float32)
    with pytest.raises(ValueError, match="loc is torch.float64"):
        ci.image_bilinear_cuda(img, grad, loc.double())
    with pytest.raises(ValueError, match="grad must be"):
        ci.image_bilinear_cuda(img, grad[:, :5].contiguous(), loc)
    with pytest.raises(ValueError, match="contiguous"):
        ci.image_bilinear_cuda(img, grad, loc.transpose(0, 1))
    with pytest.raises(ValueError, match="not CUDA"):
        ci.image_bilinear_cuda(img.cpu(), grad, loc)
    with pytest.raises(ValueError, match="aligned"):
        ci.image_bilinear_cuda(img, torch.empty(9 * 11 * 2 + 1, device="cuda")[1:].view(9, 11, 2),
                               loc)
    with pytest.raises(ValueError, match="channels"):
        ci.image_bilinear_cuda(img, grad, loc, 2)
    # C = 1 reads no gradient image
    assert ci.image_bilinear_cuda(img, grad[:, :5], loc, 1).shape == (4, 6)


def test_layout_and_image_recorded_into_a_graph(cuda):
    """K5 and K4 recorded into a CUDA graph count no launch, and the replay
    gives the eager calls' bits."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_image as ci
    from mba_vo_tpu_torch.ops import cuda_layout as cl
    from mba_vo_tpu_torch.ops import residual as tres
    from mba_vo_tpu_torch.ops.image import image_bilinear_lk

    args = _layout_problem(7, 4, 4, 5, torch.float32)
    img, grad, loc = _image_problem(512, 40, 480, 640, torch.float32)
    refs = [tres.prepare_frame_layout(*args), image_bilinear_lk(img, grad, loc, 3),
            image_bilinear_lk(img, grad, loc, 1)]
    torch.cuda.synchronize()
    before = (cl.LAUNCHES_LAYOUT, ci.LAUNCHES_IMAGE)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [tres.prepare_frame_layout(*args), image_bilinear_lk(img, grad, loc, 3),
                image_bilinear_lk(img, grad, loc, 1)]
    assert (cl.LAUNCHES_LAYOUT, ci.LAUNCHES_IMAGE) == before
    graph.replay()
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert rk.same_bits(out, ref)


def _direct_problem(degree, F, dtype, N=512, H=480, W=640, seed=3):
    """(knots, level data) of the direct path at the tracker's width: a
    smooth keyframe, noisy copies as the current frames, keypoints over the
    image (two by its border), moving knots over the frames' span."""
    from mba_vo_tpu_torch.ops.image import image_gradients

    knots, data, _, _ = _layout_problem(degree if degree == 2 else F + 3, degree, F, 5, dtype,
                                        N=N, H=H, W=W, seed=seed)
    rng = np.random.default_rng(seed + 1)
    img = np.cumsum(np.cumsum(rng.normal(0, 0.5, (H, W)), 0), 1)
    img = 128 + 60 * img / np.abs(img).max()
    cur = np.stack([img + rng.normal(0, 2, (H, W)) for _ in range(F)])
    kp = rng.uniform(4, [W - 5, H - 5], (N, 2))
    kp[:2] = [[1.5, 2.25], [W - 2.5, H - 1.75]]
    c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    img_t = c(img)
    return knots, data._replace(img_ref=img_t, grad_ref=image_gradients(img_t).contiguous(),
                                cur_imgs=c(cur), kp_xy=c(kp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("degree,F", [(2, 1), (4, 4)])
def test_direct_path_on_kernels_matches_the_plain_chain(cuda, dtype, degree, F):
    """compute_residuals on CUDA tensors (K5, K2's warp_tangents with the
    window corners at the origin, K4, K2's blur_rows) against its plain
    version run on the card (the pose Jacobian, the warp JVP, the gather,
    the einsum), with and without J, affine and not: r and J within 1e-6
    (float32) and 1e-12 (float64) of each output's magnitude, valid equal;
    the cost-only r equals the r with J, and the affine J the J without
    it, bit for bit."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_image as ci
    from mba_vo_tpu_torch.ops import residual as tres

    knots, data = _direct_problem(degree, F, dtype)
    got = {}
    for affine in (False, True):
        rk.hold_direct(knots, data, 5, degree, affine)
        for jac in (True, False):
            before = ci.LAUNCHES_IMAGE
            r, J, valid = got[affine, jac] = tres.compute_residuals(knots, data, 5, degree,
                                                                    jac, affine)
            torch.cuda.synchronize()
            assert ci.LAUNCHES_IMAGE == before + 1
            assert 0 < valid.float().mean().item() < 1 and (J is None) == (not jac)
    for affine in (False, True):
        assert torch.equal(got[affine, False][0], got[affine, True][0])
    assert torch.equal(got[True, True][1], got[False, True][1])
    assert not torch.equal(got[True, True][0], got[False, True][0])


def test_direct_warp_reaches_the_whole_image(cuda):
    """Nothing in K2's warp_tangents is window-sized: with the window
    corners at the origin and a pose that moves the samples tens of pixels
    from their keypoints, its positions (whole-image, far outside any
    32-px window) and tangents hold to the plain version, vs equal."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    for dtype in (torch.float32, torch.float64):
        knots, data = _direct_problem(2, 1, dtype)
        knots = knots._replace(t=knots.t + torch.tensor([0.2, -0.15, 0.05], dtype=dtype,
                                                         device="cuda"))
        H, W = data.img_ref.shape
        pix = torch.floor(data.kp_xy)[None, :, None, :].expand(1, -1, 8, -1).contiguous()
        starts = torch.zeros((pix.shape[1], 2), dtype=torch.int64, device="cuda")
        args = (knots, data.cap_times, data.exp_times, 5, 2, True, data.kp_z, data.K, pix,
                starts, H, W)
        rk.hold(rk.ResidualCall("warp_tangents", args, None))
        loc, vs, _ = rk.kernel_fn("warp_tangents")(*args)
        # S in (f, p, v) order: each patch pixel's 5 virtual poses in turn
        moved = (loc - pix[0].repeat_interleave(5, 1)).norm(dim=-1)
        assert float(moved.min()) > 32 and 0 < vs.mean().item() < 1


def test_direct_evaluation_launches_only_the_kernels(cuda):
    """One LM evaluation of the direct path on the card launches K5, K2's
    two entries, K4 and K3 once each and a handful of assemble's torch ops:
    no pose chain, warp JVP or gather (the plain chain launches hundreds)."""
    from torch.profiler import ProfilerActivity, profile

    from mba_vo_tpu_torch.ops import cuda_residual as cr
    from mba_vo_tpu_torch.ops import cuda_sampling
    from mba_vo_tpu_torch.ops import residual as tres

    knots, data = _direct_problem(2, 1, torch.float32)
    mask = torch.ones(data.kp_z.shape[0], device="cuda")

    def launches(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(a.count for a in prof.key_averages() if a.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))

    def evaluation():
        return tres.evaluate(knots, data, 5, 2, 10.0, mask, True, sampling="direct")

    cr.zero_launch_counts()
    k1 = cuda_sampling.LAUNCHES
    n = launches(evaluation)
    assert cr.launch_counts() == dict(warp_tangents=2, blur_rows=2, normal_equations=2,
                                      prepare_frame_layout=2, image_bilinear_lk=2)
    assert cuda_sampling.LAUNCHES == k1
    saved = tres.compute_residuals
    try:
        tres.compute_residuals = tres.compute_residuals_plain
        plain = launches(evaluation)
    finally:
        tres.compute_residuals = saved
    assert n <= 24 < 200 < plain, (n, plain)


def test_direct_tracker_runs_through_k4_and_k5(cuda):
    """track_frame with sampling="direct" on the card launches K5, K2's two
    entries, K4 and K3 (no K1) once each an LM evaluation, in float32 and
    float64; every recorded call of each holds to its plain version."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import smooth_shapes_image, synthesize_blurred_image
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_residual as cr
    from mba_vo_tpu_torch.ops import cuda_sampling
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
                            sampling="direct", max_num_iterations=6,
                            detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                                     max_keypoints=128))
        tracker = BlurAwareTracker(cfg, K, (h, w), device="cuda")
        tracker.track_frame(img, img, 0.0, 0.03, np.full((h, w), 2.0))
        cr.zero_launch_counts()
        k1 = cuda_sampling.LAUNCHES
        with rk.record_residual_calls() as calls:
            for i in (1, 2, 3):
                blur = synthesize_blurred_image(torch.tensor(img), traj, 2, 0.1 * i, 0.03, 5,
                                                2.0, torch.tensor(K)).numpy()
                pose = tracker.track_frame(None, blur, 0.1 * i, 0.03)
        torch.cuda.synchronize()
        n = cr.launch_counts()
        assert cuda_sampling.LAUNCHES == k1 and n["image_bilinear_lk"] > 0
        # K3 once more where a step succeeds (its cost, then its J)
        assert n["prepare_frame_layout"] == n["warp_tangents"] == n["blur_rows"] == n[
            "image_bilinear_lk"] <= n["normal_equations"], n
        assert torch.isfinite(pose.t).all()
        for kernel in rk.KERNELS:
            assert len(calls[kernel]) == n[kernel]
            for call in calls[kernel]:
                rk.hold(call)


# K4's designs on edge shapes: the frame at level 0 and a joint chunk at level
# 1, tiny ragged blocks, N S a prime number of samples (one keypoint of 257,
# 41 keypoints of one), and an N S that the block does not divide
IMAGE_EDGE_SHAPES = IMAGE_SHAPES + [(1, 257, 9, 11), (41, 1, 9, 11), (7, 37, 30, 40)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("N,S,H,W", IMAGE_EDGE_SHAPES)
def test_image_designs_equal_bit_for_bit(cuda, dtype, channels, N, S, H, W):
    """K4's select design, its branch design (the earlier one) and, with
    C = 3, the interleaved row, each equal to the plain version bit for bit,
    off-image and NaN positions included; one launch a call on each
    design's counter."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_image as ci
    from mba_vo_tpu_torch.ops.image import image_bilinear_lk_plain

    img, grad, loc = _image_problem(N, S, H, W, dtype)
    ref = image_bilinear_lk_plain(img, grad, loc, channels)
    before = (ci.LAUNCHES_IMAGE, ci.LAUNCHES_IMAGE_BRANCH, ci.LAUNCHES_IMAGE_INTERLEAVED)
    outs = {"select": ci.image_bilinear_cuda(img, grad, loc, channels),
            "branch": ci.image_bilinear_branch_cuda(img, grad, loc, channels)}
    if channels == 3:
        outs["interleaved"] = ci.image_bilinear_interleaved_cuda(
            ci.interleave_planes(img, grad), loc)
    torch.cuda.synchronize()
    for name, out in outs.items():
        assert rk.same_bits(out, ref), f"{name}: {rk._unequal(out, ref)}"
    assert (ci.LAUNCHES_IMAGE, ci.LAUNCHES_IMAGE_BRANCH, ci.LAUNCHES_IMAGE_INTERLEAVED) == (
        before[0] + 1, before[1] + 1, before[2] + (channels == 3))


def test_image_designs_check_their_inputs(cuda):
    """The select design refuses positions not aligned to a pair; the
    interleaved row a plane not aligned to 16
    bytes or not [H, W, 4]; the branch design takes unaligned positions."""
    from mba_vo_tpu_torch.ops import cuda_image as ci
    from mba_vo_tpu_torch.ops.image import image_bilinear_lk_plain

    img, grad, loc = _image_problem(4, 6, 9, 11, torch.float32)
    odd = torch.empty(4 * 6 * 2 + 1, device="cuda")[1:].view(4, 6, 2)
    odd.copy_(loc)
    with pytest.raises(ValueError, match="loc's storage is not aligned"):
        ci.image_bilinear_cuda(img, grad, odd)
    plane = ci.interleave_planes(img, grad)
    with pytest.raises(ValueError, match="plane must be"):
        ci.image_bilinear_interleaved_cuda(plane[..., :3].contiguous(), loc)
    shifted = torch.empty(9 * 11 * 4 + 1, device="cuda")[1:].view(9, 11, 4)
    with pytest.raises(ValueError, match="plane's storage is not aligned"):
        ci.image_bilinear_interleaved_cuda(shifted, loc)
    with pytest.raises(ValueError, match="not CUDA"):
        ci.image_bilinear_branch_cuda(img, grad, loc.cpu())
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    assert rk.same_bits(ci.image_bilinear_branch_cuda(img, grad, odd),
                        image_bilinear_lk_plain(img, grad, loc))


# K5's designs: degree 2 and 4, K from the degree to the staged design's
# limit, F up to 8
LAYOUT_KNOTS = [(2, 2, 1), (2, 2, 8), (3, 2, 4), (33, 2, 2), (64, 2, 3), (4, 4, 1), (7, 4, 4),
                (27, 4, 8), (64, 4, 8)]



@pytest.mark.parametrize("case", ["moving", "standing", "clamped"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K,degree,F", LAYOUT_KNOTS)
def test_layout_designs_equal_bit_for_bit(cuda, K, degree, F, dtype, case):
    """K5's staged design and its serial design (the earlier one) give the plain
    version's pix, valid and obs and its anchors bit for bit, from a moving
    spline, a standing start (integer anchors) and a capture time past the
    spline's end (64 knots in float32 among them: the plain version's
    quaternion norms sum in the kernels' order, core/lie.py's _sum3); one
    launch a call on each design's counter."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_layout as cl
    from mba_vo_tpu_torch.ops import residual as tres

    args = _layout_problem(K, degree, F, 5, dtype, case)
    ref = tres.prepare_frame_layout_plain(*args)
    anchors = _plain_anchors(*args)
    before = (cl.LAUNCHES_LAYOUT, cl.LAUNCHES_LAYOUT_SERIAL)
    wrapped = tres.frame_layout_args(*args)
    staged = cl.frame_layout_cuda(*wrapped, anchors=True)
    serial = cl.frame_layout_serial_cuda(*wrapped, anchors=True)
    torch.cuda.synchronize()
    pairs = [("staged layout against the plain version", staged[:3], ref),
             ("serial layout against the plain version", serial[:3], ref),
             ("staged anchors against the serial design's", staged[3], serial[3]),
             ("staged anchors against the plain version's", staged[3], anchors),
             ("serial anchors against the plain version's", serial[3], anchors)]
    unequal = {what: rk._unequal(got, want) for what, got, want in pairs
               if not rk.same_bits(got, want)}
    assert not unequal, unequal
    assert (cl.LAUNCHES_LAYOUT, cl.LAUNCHES_LAYOUT_SERIAL) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("degree", [2, 4])
def test_layout_designs_nan_knots(cuda, degree):
    """A NaN knot: both designs give the plain version's bits, NaN pixels
    not valid."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_layout as cl
    from mba_vo_tpu_torch.ops import residual as tres

    for dtype in (torch.float32, torch.float64):
        knots, data, V, _ = _layout_problem(7, degree, 4, 5, dtype)
        t = knots.t.clone()
        t[3, 2] = float("nan")
        args = (knots._replace(t=t), data, V, degree)
        ref = tres.prepare_frame_layout_plain(*args)
        assert torch.isnan(ref[0]).any()
        for design in (cl.frame_layout_cuda, cl.frame_layout_serial_cuda):
            out = design(*tres.frame_layout_args(*args))
            assert rk.same_bits(out, ref), f"{design.__name__}: {rk._unequal(out, ref)}"


def test_layout_staged_design_refuses_more_knots_than_it_stages(cuda):
    """Past MAX_LAYOUT_KNOTS the staged design raises before any launch;
    the serial design takes any number of knots."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_layout as cl
    from mba_vo_tpu_torch.ops import residual as tres

    args = _layout_problem(cl.MAX_LAYOUT_KNOTS + 1, 4, 2, 5, torch.float32)
    before = cl.LAUNCHES_LAYOUT
    with pytest.raises(ValueError, match="MAX_LAYOUT_KNOTS"):
        cl.frame_layout_cuda(*tres.frame_layout_args(*args))
    assert cl.LAUNCHES_LAYOUT == before
    out = cl.frame_layout_serial_cuda(*tres.frame_layout_args(*args))
    assert rk.same_bits(out, tres.prepare_frame_layout_plain(*args))


def test_every_k4_k5_design_recorded_into_a_graph(cuda):
    """Every design of K4 and K5 recorded into a CUDA graph counts no launch,
    and the replay gives the eager calls' bits."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_image as ci
    from mba_vo_tpu_torch.ops import cuda_layout as cl
    from mba_vo_tpu_torch.ops import residual as tres

    wrapped = tres.frame_layout_args(*_layout_problem(27, 4, 8, 5, torch.float32))
    img, grad, loc = _image_problem(512, 40, 480, 640, torch.float32)
    plane = ci.interleave_planes(img, grad)

    def calls():
        return [cl.frame_layout_cuda(*wrapped), cl.frame_layout_serial_cuda(*wrapped),
                ci.image_bilinear_cuda(img, grad, loc, 3),
                ci.image_bilinear_cuda(img, grad, loc, 1),
                ci.image_bilinear_branch_cuda(img, grad, loc, 3),
                ci.image_bilinear_interleaved_cuda(plane, loc)]

    refs = calls()
    torch.cuda.synchronize()
    counters = ("LAUNCHES_LAYOUT", "LAUNCHES_LAYOUT_SERIAL")
    images = ("LAUNCHES_IMAGE", "LAUNCHES_IMAGE_BRANCH", "LAUNCHES_IMAGE_INTERLEAVED")
    before = [getattr(cl, c) for c in counters] + [getattr(ci, c) for c in images]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    assert [getattr(cl, c) for c in counters] + [getattr(ci, c) for c in images] == before
    graph.replay()
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert rk.same_bits(out, ref)


# ------------------------------------------------ K6-K8: the LM iteration

LM_DIMS = [12, 30, 42, 162]   # the frame, degree-2 and degree-4 chunks, a 24-frame chunk
LM_BOUNDS = {torch.float32: 1e-5, torch.float64: 1e-12}


def _lm_state(D, dtype, case="valid", seed=0):
    """An LM state at D = 6K unknowns on the card: a well-conditioned SPD
    Hessian (``case`` "invalid": negative definite, so the factorisation
    fails), a gradient, knots and the scalars of a level's start."""
    from mba_vo_tpu_torch.solver import lm as tlm

    rng = np.random.default_rng(seed)
    K = D // 6
    A = rng.normal(0, 1, (D, D))
    H = A @ A.T / D + np.eye(D)
    if case == "invalid":
        H = -H
    g = rng.normal(0, 0.1, D)
    t = np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0)
    q = np.concatenate([rng.normal(0, 0.02, (K, 3)), np.ones((K, 1))], axis=1)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    sc = torch.zeros(tlm.S_SIZE, dtype=dtype, device="cuda")
    sc[tlm.S_COST:tlm.S_CAND + 1] = 5.0
    sc[tlm.S_RADIUS], sc[tlm.S_DECREASE], sc[tlm.S_ACD] = 1e4, 2.0, 1e10
    return c(H), c(g), sc, c(t), c(q)


@pytest.mark.parametrize("case", ["valid", "invalid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", LM_DIMS)
def test_lm_step_matches_plain(cuda, D, dtype, case):
    """K6 against lm_step_plain on the card: H1 bit for bit, the step within
    1e-12 (f64) / 1e-5 (f32) of its norm of the plain version's library
    solve, the same invalid flag; the step and the model cost change bit
    for bit against K6's order of operations transcribed
    (``residual_kernels.lm_step_kernel_order``); the candidate knots equal
    to spline_retract_flat of K6's own step bit for bit (the knots
    themselves where the step is invalid); one launch."""
    from mba_vo_tpu_torch.core.spline import SplineKnots, spline_retract_flat
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    H, g, sc, t, q = _lm_state(D, dtype, case)
    before = cuda_lm.LAUNCHES_LM_STEP
    H1, step, ct, cq, sk = cuda_lm.lm_step_cuda(H, g, sc.clone(), t, q)
    torch.cuda.synchronize()
    assert cuda_lm.LAUNCHES_LM_STEP == before + 1
    pH1, pstep, pct, pcq, psc = tlm.lm_step_plain(H, g, sc, t, q)
    assert torch.equal(H1, pH1)
    assert float(sk[tlm.S_INVALID]) == float(psc[tlm.S_INVALID]) == (case == "invalid")
    if case == "invalid":
        assert torch.isnan(step).all() and torch.isnan(pstep).all()
        assert torch.equal(ct, t) and torch.equal(cq, q)
        return
    scale = float(torch.linalg.norm(pstep))
    assert float((step - pstep).abs().max()) <= LM_BOUNDS[dtype] * scale
    ostep, omcc = rk.lm_step_kernel_order(H1, g)
    assert torch.equal(step, ostep) and torch.equal(sk[tlm.S_MCC], omcc)
    ref = spline_retract_flat(SplineKnots(t, q, None, None), step)
    assert torch.equal(ct, ref.t) and torch.equal(cq, ref.q)


# K6's designs: the frame and joint chunks, the floor (one knot), the last
# and first D of the shuffle design's one-warp and eight-warp sweeps, and a D
# whose factor lives in global memory in both designs and both dtypes
LM_DESIGN_DIMS = LM_DIMS + [6, 60, 66, 240]


def _ill_conditioned(D, dtype, seed=0):
    """An SPD H with kappa_2 ~ 1e6: eigenvalues from 1 to 1e-6 on a random
    basis."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(0, 1, (D, D)))
    H = (Q * np.logspace(0, -6, D)) @ Q.T
    return torch.tensor((H + H.T) / 2, dtype=dtype, device="cuda")


@pytest.mark.parametrize("case", ["valid", "invalid", "ill-conditioned"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", LM_DESIGN_DIMS)
def test_lm_step_designs_match_kernel_order(cuda, D, dtype, case):
    """Both K6 designs, the shuffle design the LM launches and PR 12's block
    design, against K6's order transcribed
    (``residual_kernels.lm_step_kernel_order``) bit for bit: the step, the
    model cost change and the invalid flag, on a well-conditioned, a
    negative definite (the factorisation fails: NaN step, invalid) and an
    ill-conditioned (kappa_2 ~ 1e6) H; the two designs' every output equal
    bit for bit; one launch of each, on its own counter."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    H, g, sc, t, q = _lm_state(D, dtype, "invalid" if case == "invalid" else "valid")
    if case == "ill-conditioned":
        H = _ill_conditioned(D, dtype)
    outs = []
    for fn, counter in ((cuda_lm.lm_step_cuda, "LAUNCHES_LM_STEP"),
                        (cuda_lm.lm_step_block_cuda, "LAUNCHES_LM_STEP_BLOCK")):
        before = cuda_lm.launch_counts(), getattr(cuda_lm, counter)
        out = fn(H, g, sc.clone(), t, q)
        torch.cuda.synchronize()
        assert getattr(cuda_lm, counter) == before[1] + 1
        if counter == "LAUNCHES_LM_STEP_BLOCK":
            assert cuda_lm.launch_counts() == before[0]   # not a launch of the LM's K6
        H1, step, _, _, sk = out
        ostep, omcc = rk.lm_step_kernel_order(H1, g)
        assert rk.same_bits(step, ostep), rk._unequal(step, ostep)
        assert rk.same_bits(sk[tlm.S_MCC], omcc)
        oinvalid = bool(omcc < 0) or not bool(torch.isfinite(ostep).all())
        assert float(sk[tlm.S_INVALID]) == float(oinvalid) == float(case == "invalid")
        outs.append(out)
    assert rk.same_bits(outs[0], outs[1]), rk._unequal(outs[0], outs[1])


def _decide_inputs_any(F, N, dtype, seed=0):
    """:func:`_decide_inputs` where N has room for its outlier, its
    zero-cost keypoint, its padded slots and its earlier flag; below that
    plain costs, every keypoint live."""
    if N >= 10:
        patch, kp_mask, kp_w = _decide_inputs(F, N, dtype, seed)
        if N > 2048:
            # past the 4 x 512 keypoints whose costs K7 keeps in registers
            # (lm_step.cu's kDecideKeep): an outlier and a zero-cost keypoint
            # among those whose costs it computes again
            patch[:, 2060] = 60.0
            patch[:, 2061] = 0.0
        return patch, kp_mask, kp_w
    patch = np.random.default_rng(seed).uniform(0.5, 1.5, (F, N))
    c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    return c(patch), c(np.ones(N)), c(np.ones(N))


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("F,N", [(1, 1), (1, 40), (4, 32), (1, 512), (4, 700), (1, 2100),
                                 (4, 2100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lm_decide_designs_match_plain(cuda, dtype, F, N, prior):
    """Both K7 designs, the keypoint design the LM launches and PR 12's
    block design, against lm_decide_plain: the candidate cost, quality,
    success and cost decrease, the new mask and keypoint weights equal, mu
    and sigma within 1e-12 (f64) / 1e-5 (f32) of the plain version's; one
    keypoint, fewer keypoints than a warp, a keypoint a thread up to 512 and
    past it (700: threads loop; 2100: past the 2048 costs kept in
    registers, the rest computed again); one launch of each, on its own
    counter."""
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    patch, kp_mask, kp_w = _decide_inputs_any(F, N, dtype)
    opts = tlm.LMOptions()
    P = 8
    n = float(kp_w.sum()) * F * P
    for raw in (0.9 * 5.0 * n, 1.2 * 5.0 * n, 4.999 * n):
        _, _, sc, _, _ = _lm_state(12, dtype)
        sc[tlm.S_MCC] = 0.3
        cost = torch.tensor(raw, dtype=dtype, device="cuda")
        pc = torch.tensor(0.01, dtype=dtype, device="cuda") if prior else None
        sp, mp, wp = tlm.lm_decide_plain(cost, patch, kp_w, kp_mask, sc, P, opts, pc)
        for fn, counter in ((cuda_lm.lm_decide_cuda, "LAUNCHES_LM_DECIDE"),
                            (cuda_lm.lm_decide_block_cuda, "LAUNCHES_LM_DECIDE_BLOCK")):
            before = getattr(cuda_lm, counter)
            sk, mk, wk = fn(cost, patch, kp_w, kp_mask, sc.clone(), P,
                            opts.max_chi_square_error, opts.min_step_quality, pc)
            torch.cuda.synchronize()
            assert getattr(cuda_lm, counter) == before + 1
            assert torch.equal(mk, mp) and torch.equal(wk, wp), counter
            if N >= 10:
                assert float(mk[3]) == 0.0
            for i in (tlm.S_CAND_COST, tlm.S_QUALITY, tlm.S_SUCCESS, tlm.S_ACD_NEW):
                assert float(sk[i]) == float(sp[i]), (counter, i)
            for i in (tlm.S_MU, tlm.S_SIGMA):
                assert abs(float(sk[i]) - float(sp[i])) <= LM_BOUNDS[dtype] * abs(float(sp[i])), (
                    counter, i)


def _decide_inputs(F, N, dtype, seed=0):
    rng = np.random.default_rng(seed)
    patch = rng.uniform(0.5, 1.5, (F, N))
    patch[:, 3] = 60.0                 # an outlier
    patch[:, 5] = 0.0                  # out of the statistics
    kp_mask = np.ones(N)
    kp_mask[-7:] = 0.0                 # padded slots
    mask = np.ones(N)
    mask[9] = 0.0                      # flagged earlier
    c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    return c(patch), c(kp_mask), c(kp_mask * mask)


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("F,N", [(1, 40), (1, 512), (4, 512), (8, 96)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_lm_decide_matches_plain(cuda, dtype, F, N, prior):
    """K7 against lm_decide_plain on the card: the candidate cost, quality,
    success and cost decrease, the new mask and keypoint weights equal,
    mu and sigma within 1e-12 (f64) / 1e-5 (f32); one launch. Costs around
    the current one give a success, a rejection and a failed quality."""
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    patch, kp_mask, kp_w = _decide_inputs(F, N, dtype)
    opts = tlm.LMOptions()
    P = 8
    n = float(kp_w.sum()) * F * P
    for raw in (0.9 * 5.0 * n, 1.2 * 5.0 * n, 4.999 * n):
        _, _, sc, _, _ = _lm_state(12, dtype)
        sc[tlm.S_MCC] = 0.3
        cost = torch.tensor(raw, dtype=dtype, device="cuda")
        pc = torch.tensor(0.01, dtype=dtype, device="cuda") if prior else None
        before = cuda_lm.LAUNCHES_LM_DECIDE
        sk, mk, wk = cuda_lm.lm_decide_cuda(cost, patch, kp_w, kp_mask, sc.clone(), P,
                                            opts.max_chi_square_error, opts.min_step_quality, pc)
        torch.cuda.synchronize()
        assert cuda_lm.LAUNCHES_LM_DECIDE == before + 1
        sp, mp, wp = tlm.lm_decide_plain(cost, patch, kp_w, kp_mask, sc, P, opts, pc)
        assert torch.equal(mk, mp) and torch.equal(wk, wp) and float(mk[3]) == 0.0
        for i in (tlm.S_CAND_COST, tlm.S_QUALITY, tlm.S_SUCCESS, tlm.S_ACD_NEW):
            assert float(sk[i]) == float(sp[i]), i
        for i in (tlm.S_MU, tlm.S_SIGMA):
            assert abs(float(sk[i]) - float(sp[i])) <= LM_BOUNDS[dtype] * abs(float(sp[i])), i


@pytest.mark.parametrize("prior", [False, True])
@pytest.mark.parametrize("retry", [False, True])
@pytest.mark.parametrize("branch", ["accepted", "rejected", "invalid"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", LM_DIMS)
def test_lm_commit_matches_plain(cuda, D, dtype, branch, retry, prior):
    """K8 against lm_commit_plain on the card, bit for bit: every array and
    scalar of the next state and the continue flag, for an accepted, a
    rejected and an invalid step, with and without retry_rejected_steps
    and the knot prior; one launch."""
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    F, N, P = (4, 96, 8)
    H, g, sc, t, q = _lm_state(D, dtype, seed=1)
    rng = np.random.default_rng(2)
    c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    K = D // 6
    patch, kp_mask, kp_w = _decide_inputs(F, N, dtype)
    new_mask = torch.ones(N, dtype=dtype, device="cuda")
    new_mask[3] = 0.0
    state = tlm.LMState(t, q, H, g, sc, (kp_w > 0).to(dtype), kp_w, patch * 1e-3)
    H1 = H * 1.0001
    ct, cq = t + 1e-3, q.flip(0)
    n = float((kp_mask * new_mask).sum()) * F * P
    raw_cost = c(4.0 * n)
    raw_g, raw_H = c(rng.normal(0, 1, D) * n), H * n
    pri = (c(0.25), c(rng.normal(0, 0.01, D)), H * 0.01) if prior else None
    sc[tlm.S_MCC], sc[tlm.S_QUALITY], sc[tlm.S_ACD_NEW] = 0.7, 0.8, 0.9
    sc[tlm.S_MIN], sc[tlm.S_NONMONO] = 3.0, 4.0
    sc[tlm.S_INVALID] = float(branch == "invalid")
    sc[tlm.S_SUCCESS] = float(branch in ("accepted", "invalid"))   # invalid wins over it
    plain = tlm.lm_commit_plain(state, H1, ct, cq, raw_cost, raw_g, raw_H, patch, new_mask,
                                kp_mask * new_mask, P,
                                tlm.LMOptions(retry_rejected_steps=retry), True, pri)
    got = tlm.LMState(*(x.clone() for x in state))
    before = cuda_lm.LAUNCHES_LM_COMMIT
    cuda_lm.lm_commit_cuda(*got, H1, ct, cq, raw_cost, raw_g, raw_H, patch, new_mask,
                           kp_mask * new_mask, P, min_radius=10.0, max_radius=1e32,
                           max_nonmono=5, retry=retry, min_acd=1e-3, more=True, prior=pri)
    torch.cuda.synchronize()
    assert cuda_lm.LAUNCHES_LM_COMMIT == before + 1
    for name, a, b in zip(tlm.LMState._fields, got, plain):
        assert torch.equal(a, b), (name, a, b)
    assert torch.equal(got.t, ct if branch == "accepted" else t)
    assert K == t.shape[0]


# K8's designs: one knot (the floor) and LM_DIMS' unknowns; one frame of one
# keypoint, of fewer keypoints than a warp and of the frame's 512, and 4
# frames of 96, 700 and 2100 keypoints (past the 2048 patch entries that
# the staged design's first batch covers)
LM_COMMIT_DIMS = LM_DIMS + [6]
LM_COMMIT_SHAPES = [(1, 1), (1, 40), (1, 512), (4, 96), (4, 700), (4, 2100)]


def _commit_problem(D, F, N, dtype, branch, prior, case=None, seed=1):
    """A K8 call on the card: (the state, the iteration's tensors (H1, the
    candidate knots, K3's raw cost, g, H and patch costs, K7's mask and
    weights), the prior or None). ``branch``: the flags of K6 and K7 set
    for an accepted, a rejected or an invalid step; ``case`` "nan cost": K3's
    cost a NaN; "no weights": every new weight 0 (the count's clamp to 1)."""
    from mba_vo_tpu_torch.solver import lm as tlm

    P = 8
    H, g, sc, t, q = _lm_state(D, dtype, seed=seed)
    rng = np.random.default_rng(seed + 1)
    c = lambda a: torch.tensor(a, dtype=dtype, device="cuda")   # noqa: E731
    patch, kp_mask, kp_w = _decide_inputs_any(F, N, dtype)
    new_mask = torch.ones(N, dtype=dtype, device="cuda")
    if N > 3:
        new_mask[3] = 0.0
    new_w = kp_mask * new_mask
    if case == "no weights":
        new_w = torch.zeros_like(new_w)
    state = tlm.LMState(t, q, H, g, sc, (kp_w > 0).to(dtype), kp_w, patch * 1e-3)
    n = max(float(new_w.sum()) * F * P, 1.0)
    cost = c(float("nan") if case == "nan cost" else 4.0 * n)
    call = (H * 1.0001, t + 1e-3, q.flip(1), cost, c(rng.normal(0, 1, D) * n), H * n, patch,
            new_mask, new_w)
    pri = (c(0.25), c(rng.normal(0, 0.01, D)), H * 0.01) if prior else None
    sc[tlm.S_MCC], sc[tlm.S_QUALITY], sc[tlm.S_ACD_NEW] = 0.7, 0.8, 0.9
    sc[tlm.S_MIN], sc[tlm.S_NONMONO] = 3.0, 4.0
    sc[tlm.S_INVALID] = float(branch == "invalid")
    sc[tlm.S_SUCCESS] = float(branch in ("accepted", "invalid"))   # invalid wins over it
    return state, call, pri


@pytest.mark.parametrize("F,N", LM_COMMIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", LM_COMMIT_DIMS)
def test_lm_commit_designs_match_plain(cuda, D, dtype, F, N):
    """Both K8 designs, the staged design the LM launches (through
    lm_commit_cuda, and through a CommitBinding given to the dispatcher as
    the LM calls it) and the earlier block design, against lm_commit_plain bit for bit: every
    array and scalar of the next state and the continue flag, for an
    accepted, a rejected and an invalid step, with and without
    retry_rejected_steps and the knot prior, then with a NaN for K3's cost
    and with every new weight 0; one launch each, on its design's
    counter."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    P = 8
    cases = [(branch, retry, prior, None) for branch in ("accepted", "rejected", "invalid")
             for retry in (False, True) for prior in (False, True)]
    cases += [("accepted", False, False, "nan cost"), ("accepted", False, True, "no weights")]
    for branch, retry, prior, case in cases:
        state, call, pri = _commit_problem(D, F, N, dtype, branch, prior, case)
        opts = tlm.LMOptions(retry_rejected_steps=retry)
        kw = dict(more=True, prior=pri, **tlm.commit_options(opts))
        plain = tlm.lm_commit_plain(state, *call, P, opts, True, pri)
        runs = [("staged", "LAUNCHES_LM_COMMIT",
                 lambda s: cuda_lm.lm_commit_cuda(*s, *call, P, **kw)),
                ("block", "LAUNCHES_LM_COMMIT_BLOCK",
                 lambda s: cuda_lm.lm_commit_block_cuda(*s, *call, P, **kw)),
                ("binding", "LAUNCHES_LM_COMMIT",
                 lambda s: tlm.lm_commit(s, *call, P, opts, True, pri, binding=(
                     cuda_lm.CommitBinding(s, P, **tlm.commit_options(opts)))))]
        for name, counter, run in runs:
            got = tlm.LMState(*(x.clone() for x in state))
            before = getattr(cuda_lm, counter)
            run(got)
            torch.cuda.synchronize()
            assert getattr(cuda_lm, counter) == before + 1, name
            for field, a, b in zip(tlm.LMState._fields, got, plain):
                assert rk.same_bits(a, b), (name, branch, retry, prior, case, field,
                                            rk._unequal(a, b))
        assert rk.same_bits(plain.t, call[1] if branch == "accepted" else state.t)


def _faults(x):
    """``x`` made wrong in each way a K8 wrapper refuses: on the CPU, of the
    other float dtype, of another shape and (not 0-dim) not contiguous."""
    out = {"not CUDA": x.cpu(), "float": x.float() if x.dtype == torch.float64 else x.double(),
           "must be": (x.reshape(1) if x.dim() == 0 else torch.cat([x, x[:1]]) if x.dim() == 1
                       else x.reshape(-1))}
    if x.dim() > 0:
        wide = torch.zeros(tuple(x.shape) + (2,), dtype=x.dtype, device=x.device)
        wide[..., 0] = x
        out["not contiguous"] = wide[..., 0]
    return out


def test_lm_commit_binding_checks_its_inputs(cuda):
    """The bound K8 call raises, and launches nothing, on each way of being
    wrong of each of the state's 8 tensors when bound and of each of the
    iteration's 9 tensors and the prior's 3 at a call; a state replaced
    rather than updated in place is bound again, and the call gives the
    plain stage's bits."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    P, opts = 8, tlm.LMOptions()
    state, call, pri = _commit_problem(12, 1, 40, torch.float64, "accepted", True)
    options = tlm.commit_options(opts)
    before = cuda_lm.launch_counts()
    for i, field in enumerate(tlm.LMState._fields):
        for match, bad in _faults(state[i]).items():
            wrong = state._replace(**{field: bad})
            with pytest.raises(ValueError, match=match):
                cuda_lm.CommitBinding(wrong, P, **options)
    binding = cuda_lm.CommitBinding(state, P, **options)
    names = ("H1", "cand_t", "cand_q", "cost", "g_raw", "H_raw", "patch", "new_mask",
             "new_kp_w", "prior_cost", "prior_g", "prior_H")
    args = call + pri
    for i, name in enumerate(names):
        for match, bad in _faults(args[i]).items():
            wrong = args[:i] + (bad,) + args[i + 1:]
            with pytest.raises(ValueError, match=match):
                binding(state, *wrong[:9], True, wrong[9:])
    assert cuda_lm.launch_counts() == before
    plain = tlm.lm_commit_plain(state, *call, P, opts, True, pri)
    replaced = state._replace(H=state.H.clone())
    out = binding(replaced, *call, True, pri)
    torch.cuda.synchronize()
    assert binding.holds(replaced) and binding.state[2] is replaced.H
    assert cuda_lm.launch_counts()["lm_commit"] == before["lm_commit"] + 1
    for field, a, b in zip(tlm.LMState._fields, out, plain):
        assert rk.same_bits(a, b), field


def test_lm_kernels_check_their_inputs(cuda):
    """The wrappers refuse CPU tensors, mixed dtypes and wrong shapes, and
    launch nothing then."""
    from mba_vo_tpu_torch.ops import cuda_lm

    H, g, sc, t, q = _lm_state(12, torch.float64)
    before = cuda_lm.launch_counts()
    with pytest.raises(ValueError, match="not CUDA"):
        cuda_lm.lm_step_cuda(H.cpu(), g, sc, t, q)
    with pytest.raises(ValueError, match="float32"):
        cuda_lm.lm_step_cuda(H, g.float(), sc, t, q)
    with pytest.raises(ValueError, match="must be"):
        cuda_lm.lm_step_cuda(H[:6, :6].contiguous(), g, sc, t, q)
    patch, kp_mask, kp_w = _decide_inputs(1, 40, torch.float64)
    with pytest.raises(ValueError, match="must be"):
        cuda_lm.lm_decide_cuda(sc[0], patch, kp_w[:30].contiguous(), kp_mask, sc, 8, 3.0, 0.5)
    assert cuda_lm.launch_counts() == before


def test_lm_kernels_recorded_into_a_graph(cuda):
    """K6 and K7 recorded into a CUDA graph count no launch, and the replay
    gives the eager calls' bits."""
    from mba_vo_tpu_torch.ops import cuda_lm

    H, g, sc, t, q = _lm_state(42, torch.float32)
    patch, kp_mask, kp_w = _decide_inputs(4, 96, torch.float32)
    cost = patch.sum() * 0.5

    def calls(s):
        out = cuda_lm.lm_step_cuda(H, g, s, t, q)[:4]
        return out + cuda_lm.lm_decide_cuda(cost, patch, kp_w, kp_mask, s, 8, 3.0, 0.5)[1:]

    s_ref, s_graph = sc.clone(), sc.clone()
    refs = calls(s_ref)
    torch.cuda.synchronize()
    before = cuda_lm.launch_counts()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls(s_graph)
    assert cuda_lm.launch_counts() == before
    graph.replay()
    torch.cuda.synchronize()
    for out, ref in zip(outs, refs):
        assert torch.equal(out, ref)
    assert torch.equal(s_graph, s_ref)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_tracker_lm_runs_on_k6_k8(cuda, dtype):
    """track_frame on the card runs every LM iteration on K6-K8 (one launch
    of each an iteration) with one host read an iteration, and takes the
    plain stages' iterations and, in float64, their poses to 1e-9."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import smooth_shapes_image, synthesize_blurred_image
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm
    from mba_vo_tpu_torch.tracker.blur_tracker import BlurAwareTracker, TrackerConfig
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    h, w = 96, 128
    K = np.array([90.0, 90.0, (w - 1) / 2, (h - 1) / 2])
    img = smooth_shapes_image(h, w, sigma=3.0, dtype=np.float64)
    traj = make_knots(torch.tensor(np.outer(np.arange(6), [0.004, -0.002, 0.001])),
                      torch.tensor([[0.0, 0, 0, 1]] * 6, dtype=torch.float64), 0.0, 0.1)
    frames = [synthesize_blurred_image(torch.tensor(img), traj, 2, 0.1 * i, 0.03, 5, 2.0,
                                       torch.tensor(K)).numpy() for i in (1, 2, 3)]

    def run():
        cfg = TrackerConfig(num_pyramid_levels=2, num_virtual_poses=(5, 5), dtype=dtype,
                            max_num_iterations=6,
                            detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                                     max_keypoints=128))
        tracker = BlurAwareTracker(cfg, K, (h, w), device="cuda")
        tracker.track_frame(img, img, 0.0, 0.03, np.full((h, w), 2.0))
        iters, poses = [], []
        for i, blur in enumerate(frames, 1):
            poses.append(tracker.track_frame(None, blur, 0.1 * i, 0.03))
            iters.append([s.num_iterations for _, s in tracker.last_summaries])
        return iters, poses

    cuda_lm.zero_launch_counts()
    reads = [0]
    item, boolean = torch.Tensor.item, torch.Tensor.__bool__
    orig = tlm.optimize_level

    def counted(*a, **k):
        def count(f):
            def wrapped(self, *args):
                reads[0] += 1
                return f(self, *args)
            return wrapped
        torch.Tensor.item, torch.Tensor.__bool__ = count(item), count(boolean)
        try:
            return orig(*a, **k)
        finally:
            torch.Tensor.item, torch.Tensor.__bool__ = item, boolean

    tlm.optimize_level = counted
    try:
        import mba_vo_tpu_torch.tracker.blur_tracker as bt
        saved_bt = bt.optimize_level
        bt.optimize_level = counted
        iters, poses = run()
    finally:
        tlm.optimize_level = orig
        bt.optimize_level = saved_bt
    n = cuda_lm.launch_counts()
    total = sum(sum(x) for x in iters)
    assert n["lm_step"] == n["lm_decide"] == n["lm_commit"] == total > 0, (n, iters)
    assert reads[0] == total, (reads, total)
    from mba_vo_tpu_torch.experiments import residual_kernels as rk

    saved = (tlm.lm_step, tlm.lm_decide, tlm.lm_commit)
    tlm.lm_step, tlm.lm_decide, tlm.lm_commit = (rk.lm_plain_fn(k) for k in rk.LM_KERNELS)
    try:
        cuda_lm.zero_launch_counts()
        iters_p, poses_p = run()
    finally:
        tlm.lm_step, tlm.lm_decide, tlm.lm_commit = saved
    assert sum(cuda_lm.launch_counts().values()) == 0
    assert iters == iters_p
    if dtype == "float64":
        for a, b in zip(poses, poses_p):
            assert float((a.t - b.t).abs().max()) <= 1e-9


# ------------------------------------------------------ K9: the knot prior

PRIOR_KNOTS = [3, 7, 11, 32]   # the least, the degree-4 chunk of 4, of 8, a long window
PRIOR_BOUNDS = {torch.float32: 1e-6, torch.float64: 1e-13}


def _prior_knots(K, case, dtype, seed=0):
    """Knots t [K, 3], q [K, 4] on the card: "moving" (relative rotations
    up to 0.5 rad), "rest" (every knot the identity at one translation: a
    window from rest), "taylor" (relative rotations of 1e-9 rad, the Taylor
    branches) or "large" (relative rotations of 2 rad and near pi)."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0, 0.05, (K, 3)), axis=0)
    q = [np.array([0.0, 0.0, 0.0, 1.0])]
    if case != "rest":
        q[0] = rng.normal(0, 1, 4)
        q[0] /= np.linalg.norm(q[0])
    else:
        t[:] = t[0]
    for k in range(K - 1):
        axis = rng.normal(0, 1, 3)
        axis /= np.linalg.norm(axis)
        angle = {"moving": rng.uniform(0, 0.5), "rest": 0.0, "taylor": 1e-9,
                 "large": (2.0, np.pi - 1e-3)[k % 2]}[case]
        e = np.concatenate([np.sin(angle / 2) * axis, [np.cos(angle / 2)]])
        x, y, z, w = q[-1]
        a, b, c, d = e
        q.append(np.array([w * a + x * d + y * c - z * b, w * b + y * d + z * a - x * c,
                           w * c + z * d + x * b - y * a, w * d - x * a - y * b - z * c]))
    return (torch.tensor(t, dtype=dtype, device="cuda"),
            torch.tensor(np.array(q), dtype=dtype, device="cuda"))


def _ulps(out, ref):
    r = ref.abs()
    return float(((out - ref).abs() / (torch.nextafter(r, torch.full_like(r, np.inf)) - r)).max())


@pytest.mark.parametrize("case", ["moving", "rest", "taylor", "large"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", PRIOR_KNOTS)
def test_knot_prior_matches_plain(cuda, K, dtype, case):
    """K9 (one launch, counted) against its plain version on the card's
    tensors: bit for bit as the target; where a transcendental rounds
    otherwise than torch's, each output within 1e-13 (float64) / 1e-6
    (float32) of its magnitude, the worst difference in ulps printed."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    t, q = _prior_knots(K, case, dtype)
    for weight in (1.0, 10.0):
        before = cuda_lm.LAUNCHES_KNOT_PRIOR
        out = cuda_lm.knot_prior_cuda(t, q, weight)
        torch.cuda.synchronize()
        assert cuda_lm.LAUNCHES_KNOT_PRIOR == before + 1
        ref = tlm.knot_prior_plain(t, q, weight)
        bits = rk.same_bits(out, ref)
        for name, o, r in zip(("cost", "g", "H"), out, ref):
            assert o.shape == r.shape and o.dtype == r.dtype
            scale = float(r.abs().max())
            err = float((o - r).abs().max())
            assert err <= PRIOR_BOUNDS[dtype] * scale, (name, err, scale)
            print(f"K = {K}, {dtype}, {case}, weight {weight}: {name} "
                  f"{'equal bit for bit' if bits else f'worst {_ulps(o, r):.1f} ulps'}")


def test_knot_prior_structure_on_the_card(cuda):
    """K9's t-omega blocks are 0 and its t-t block is weight (D2^T D2 x I3),
    exactly."""
    from mba_vo_tpu_torch.ops import cuda_lm

    K, weight = 7, 10.0
    t, q = _prior_knots(K, "moving", torch.float64)
    _, _, H = cuda_lm.knot_prior_cuda(t, q, weight)
    D2 = np.zeros((K - 2, K))
    for j in range(K - 2):
        D2[j, j:j + 3] = [1.0, -2.0, 1.0]
    want = weight * np.kron(D2.T @ D2, np.eye(3))
    Hc = H.cpu().numpy()
    assert np.array_equal(Hc[:3 * K, :3 * K], want)
    assert not Hc[:3 * K, 3 * K:].any() and not Hc[3 * K:, :3 * K].any()


def test_knot_prior_never_reaches_the_plain_version(cuda, monkeypatch):
    """solver.lm's dispatcher on a CUDA tensor launches K9 (directly or
    through a level's binding) and never calls the plain version; the
    wrapper refuses CPU tensors, mixed dtypes, wrong shapes, fewer than 3
    knots and a weight that is not positive, launching nothing."""
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(tlm, "knot_prior_plain", refuse)
    monkeypatch.setattr(tlm, "_prior_terms", refuse)
    t, q = _prior_knots(7, "moving", torch.float32)
    before = cuda_lm.LAUNCHES_KNOT_PRIOR
    tlm.knot_prior(t, q, 1.0)
    torch.cuda.synchronize()
    assert cuda_lm.LAUNCHES_KNOT_PRIOR == before + 1
    for args, match in (((t.cpu(), q), "not CUDA"), ((t, q.double()), "float"),
                        ((t[:, :2].contiguous(), q), "must be"),
                        ((t[:2].contiguous(), q[:2].contiguous()), "at least 3")):
        with pytest.raises(ValueError, match=match):
            cuda_lm.knot_prior_cuda(*args, 1.0)
    for weight in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError, match="positive"):
            cuda_lm.knot_prior_cuda(t, q, weight)
    assert cuda_lm.LAUNCHES_KNOT_PRIOR == before + 1


def test_knot_prior_through_the_binding(cuda):
    """A CommitBinding made with the prior owns K9's buffers: its
    knot_prior launches K9 into them (the plain version's results), refuses
    knots of another count or dtype, and K8 given that very tuple reads them
    without a check, with the bits of the same call given copies."""
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm

    P, opts = 8, tlm.LMOptions()
    state, call, _ = _commit_problem(42, 4, 96, torch.float64, "accepted", True)
    state2 = tlm.LMState(*(x.clone() for x in state))
    binding = cuda_lm.CommitBinding(state, P, prior=True, **tlm.commit_options(opts))
    t, q = _prior_knots(7, "moving", torch.float64)
    before = cuda_lm.LAUNCHES_KNOT_PRIOR
    out = tlm.knot_prior(t, q, 1.0, binding=binding)
    torch.cuda.synchronize()
    assert out is binding.prior_out and cuda_lm.LAUNCHES_KNOT_PRIOR == before + 1
    ref = cuda_lm.knot_prior_cuda(t, q, 1.0)
    assert rk.same_bits(out, ref)
    for bad in ((t[:6].contiguous(), q), (t, q.float()), (t.cpu(), q)):
        with pytest.raises(ValueError):
            binding.knot_prior(*bad, 1.0)
    assert cuda_lm.LAUNCHES_KNOT_PRIOR == before + 2
    got = binding(state, *call, True, out)
    want = tlm.lm_commit_plain(state2, *call, P, opts, True, tuple(x.clone() for x in out))
    torch.cuda.synchronize()
    for field, a, b in zip(tlm.LMState._fields, got, want):
        assert rk.same_bits(a, b), field


def test_joint_tracker_lm_runs_on_k9(cuda):
    """track_frames_joint on the card launches K9 once at the start of each
    level with the prior and once an LM iteration there, with one host read
    an iteration, and takes the plain stages' (K6-K9) iterations and, in
    float64, their poses to 1e-9."""
    from mba_vo_tpu_torch.core.spline import make_knots
    from mba_vo_tpu_torch.data.synthetic import smooth_shapes_image, synthesize_blurred_image
    from mba_vo_tpu_torch.experiments import residual_kernels as rk
    from mba_vo_tpu_torch.ops import cuda_lm
    from mba_vo_tpu_torch.solver import lm as tlm
    from mba_vo_tpu_torch.tracker import blur_tracker as bt
    from mba_vo_tpu_torch.tracker.detector import DetectorOptions

    h, w = 96, 128
    K = np.array([90.0, 90.0, (w - 1) / 2, (h - 1) / 2])
    img = smooth_shapes_image(h, w, sigma=3.0, dtype=np.float64)
    traj = make_knots(torch.tensor(np.outer(np.arange(8), [0.004, -0.002, 0.001])),
                      torch.tensor([[0.0, 0, 0, 1]] * 8, dtype=torch.float64), 0.0, 0.1)
    frames = [synthesize_blurred_image(torch.tensor(img), traj, 2, 0.1 * i, 0.03, 5, 2.0,
                                       torch.tensor(K)).numpy() for i in (1, 2, 3, 4)]
    probe = {"levels": 0, "iterations": 0, "reads": 0, "all": 0}
    original = bt.optimize_level

    def probed(*a, **k):
        item, boolean = torch.Tensor.item, torch.Tensor.__bool__

        def count(f):
            def wrapped(self, *args):
                probe["reads"] += 1
                return f(self, *args)
            return wrapped
        torch.Tensor.item, torch.Tensor.__bool__ = count(item), count(boolean)
        try:
            knots, summary = original(*a, **k)
        finally:
            torch.Tensor.item, torch.Tensor.__bool__ = item, boolean
        probe["all"] += summary.num_iterations
        if tlm._prior_on(a[0], a[4]):
            probe["levels"] += 1
            probe["iterations"] += summary.num_iterations
        return knots, summary

    def run():
        cfg = bt.TrackerConfig(num_pyramid_levels=2, num_virtual_poses=(5, 5),
                               dtype="float64", max_num_iterations=4,
                               detector=DetectorOptions(score_threshold=5.0, cell_h=8, cell_w=8,
                                                        max_keypoints=128))
        tracker = bt.BlurAwareTracker(cfg, K, (h, w), device="cuda")
        tracker.track_frame(img, img, 0.0, 0.03, np.full((h, w), 2.0))
        return tracker.track_frames_joint(frames, [0.1 * i for i in (1, 2, 3, 4)],
                                          [0.03] * 4, chunk=2)

    bt.optimize_level = probed
    try:
        cuda_lm.zero_launch_counts()
        poses = run()
        n = cuda_lm.LAUNCHES_KNOT_PRIOR
        got = dict(probe)
        saved = {k: getattr(tlm, k) for k in rk.LM_STAGES}
        for k in rk.LM_STAGES:
            setattr(tlm, k, rk.lm_plain_fn(k))
        try:
            probe.update(levels=0, iterations=0, reads=0, all=0)
            cuda_lm.zero_launch_counts()
            poses_p = run()
        finally:
            for k, fn in saved.items():
                setattr(tlm, k, fn)
    finally:
        bt.optimize_level = original
    assert got["levels"] > 0 and n == got["levels"] + got["iterations"], (n, got)
    assert got["reads"] == got["all"], got
    assert cuda_lm.LAUNCHES_KNOT_PRIOR == 0
    assert (got["levels"], got["iterations"]) == (probe["levels"], probe["iterations"])
    for a, b in zip(poses, poses_p):
        assert float((a.t - b.t).abs().max()) <= 1e-9
