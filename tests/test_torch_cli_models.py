"""The port's command line on the paths of the camera models, the overlays
and the non-planar scene, against the JAX package's, on the CPU: the
eth3d-format fixture of tests/torch_cli_common.py (float64 tracker config)
remapped into rad-tan and unified-camera copies and tracked with
``--distortion=...`` and ``--camera-model unified --xi 0.8``: both
packages build the same float32 map to the bit, and the port's remap equals
the reference's op-by-op remap to the bit, but the reference's command line
jits its remap, and XLA's fused bilinear rounds ~22 % of the pixels 1-2
ulp apart (counted), which moves the float64 tracks by ~1e-7 m: TUM files
within 1e-6;
``--viz-dir`` at ``--chunk 1`` and ``--chunk 2`` (the same files, equal
pixels); ``synth --scene 3d`` (96 x 128, 3 frames: frames within a grey
level, depth to 1e-5 relative off the spheres' silhouettes, where a ray
that grazes a sphere turns a last-bit difference in the ray into up to
1e-5 of depth, and the port's own ``track`` on it within the JAX test's
4e-2 m); and the unreal pose and IMU log loaders."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from mba_vo_tpu import cli as jcli
from mba_vo_tpu.data import datasets as jds
from mba_vo_tpu.models.camera import PinholeCamera, RadTanDistortion, UnifiedCamera
from mba_vo_tpu.ops.image import build_undistort_map, remap
from mba_vo_tpu_torch import cli as tcli
from mba_vo_tpu_torch.data import datasets as tds
from mba_vo_tpu_torch.ops import image as tim

from torch_cli_common import H, KVEC, N_FRAMES, W, make_eth3d, run_quiet, track_args, tum

TUM_TOL = 1e-6   # the reference's jitted remap, see above
DIST = (-0.12, 0.04, 0.001, -0.002)       # tests/test_cli_e2e.py's coefficients
XI = 0.8                                  # tests/test_image_camera.py's mirror


@pytest.fixture(scope="module")
def eth3d(tmp_path_factory):
    return make_eth3d(tmp_path_factory.mktemp("torch_cli_models_seq"))


def remapped_copy(root, dest, src_cam):
    """tests/test_cli_e2e.py's recipe: each frame of the fixture as camera
    ``src_cam`` sees it, remapped from the clean pinhole view in float32 by
    the JAX package; depth maps, times and configs shared."""
    clean = PinholeCamera(K=jnp.asarray(KVEC, jnp.float32), height=H, width=W)
    dmap = build_undistort_map(clean, src_cam)
    for sub in ("images", "sharp"):
        os.makedirs(dest / sub)
        for p in sorted((root / sub).iterdir()):
            img = jds.load_gray_image(str(p))
            out = np.asarray(remap(jnp.asarray(img, jnp.float32), dmap))
            PILImage.fromarray(np.clip(out, 0, 255).astype(np.uint8)).save(dest / sub / p.name)
    for name in ("depths", "times.txt", "groundtruth.txt", "config.json", "backend.json"):
        (dest / name).symlink_to(root / name)
    return dest


CAMERAS = {
    "distortion": (lambda K: PinholeCamera(
        K=K, height=H, width=W, distortion=RadTanDistortion(*(jnp.float32(c) for c in DIST))),
        ["--distortion=" + ",".join(map(str, DIST))]),
    "unified": (lambda K: UnifiedCamera(K=K, xi=jnp.float32(XI), height=H, width=W),
                ["--camera-model", "unified", "--xi", str(XI)]),
}


@pytest.mark.parametrize("name", sorted(CAMERAS))
def test_undistorted_tracking_matches_jax(eth3d, tmp_path, name):
    make_cam, flags = CAMERAS[name]
    seq = remapped_copy(eth3d, tmp_path / name, make_cam(jnp.asarray(KVEC, jnp.float32)))
    # the frames each command line tracks: the port's remap equals the
    # reference's op by op; its jitted remap (what its CLI runs) differs
    # in the last bits of some pixels
    K = jnp.asarray(KVEC, jnp.float32)
    umap = build_undistort_map(make_cam(K), PinholeCamera(K=K, height=H, width=W))
    jitted = jax.jit(lambda im: remap(jnp.asarray(im, jnp.float32), umap))
    off = 0
    for p in sorted((seq / "images").iterdir()):
        img = jds.load_gray_image(str(p))
        ours = tim.remap(torch.tensor(img), torch.tensor(np.asarray(umap))).numpy()
        np.testing.assert_array_equal(ours, np.asarray(remap(jnp.asarray(img), umap)))
        theirs = np.asarray(jitted(img))
        assert np.abs(ours - theirs).max() <= 2 * np.spacing(np.float32(255.0))
        off += int((ours != theirs).sum())
    print(f"{name}: {off} of {(N_FRAMES + 1) * H * W} remapped pixels differ from the "
          "reference's jitted remap")
    run_quiet(jcli.main, track_args(seq, "j.txt", flags))
    run_quiet(tcli.main, track_args(seq, "t.txt", [*flags, "--device", "cpu"]))
    a, b = tum(seq / "j.txt"), tum(seq / "t.txt")
    assert a.shape == b.shape == (N_FRAMES + 1, 8)
    np.testing.assert_allclose(b, a, rtol=0, atol=TUM_TOL)
    gt = tum(seq / "groundtruth.txt")
    ate = float(np.sqrt(np.mean(np.sum((b[:, 1:4] - gt[:, 1:4]) ** 2, axis=1))))
    ate_j = float(np.sqrt(np.mean(np.sum((a[:, 1:4] - gt[:, 1:4]) ** 2, axis=1))))
    print(f"{name}: ATE {ate:.3e} m, the reference {ate_j:.3e} m")
    if name == "distortion":
        assert ate < 8e-3, ate      # tests/test_cli_e2e.py's bound for --distortion
    else:
        # the reference misses that bound on the unified copy too (a unified
        # view at the same focal length holds a 1.8x smaller centre, so the
        # remapped frames are blurrier): held to the reference's own figure
        assert ate <= ate_j + 1e-6, (ate, ate_j)


@pytest.mark.parametrize("chunk", [1, 2])
def test_overlays_match_jax(eth3d, tmp_path, chunk):
    """The same overlay files; pixels equal in this float64 configuration
    (the polylines agree to ~1e-12 px, so int(round(x)) lands alike)."""
    extra = ["--chunk", str(chunk)]
    run_quiet(jcli.main, track_args(eth3d, f"jv{chunk}.txt",
                                    [*extra, "--viz-dir", str(tmp_path / "j")]))
    out = run_quiet(tcli.main, track_args(eth3d, f"tv{chunk}.txt",
                                          [*extra, "--viz-dir", str(tmp_path / "t"),
                                           "--device", "cpu"]))
    names = sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "t")) == names
    assert len(names) >= N_FRAMES - 1 and f"wrote {len(names)} overlays" in out
    differ = 0
    for n in names:
        a = np.asarray(PILImage.open(tmp_path / "j" / n))
        b = np.asarray(PILImage.open(tmp_path / "t" / n))
        assert b.shape == a.shape == (H, W, 3)
        differ += int((a != b).any(axis=-1).sum())
    assert differ == 0, f"{differ} overlay pixels differ"


@pytest.fixture(scope="module")
def synth3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_synth3d")
    argv = ["synth", "--num-frames", "3", "--height", "96", "--width", "128",
            "--num-samples", "7", "--scene", "3d"]
    run_quiet(jcli.main, argv + ["--output", str(root / "jax")])
    run_quiet(tcli.main, argv + ["--output", str(root / "torch"), "--device", "cpu"])
    return root / "jax", root / "torch"


def test_synth_3d_writes_the_same_sequence(synth3d):
    """Float32 renders in both packages written by truncation to 8 bits: a
    pixel may land one grey level off where the two renders straddle an
    integer (counted); depth maps to 1e-5 relative, and they vary."""
    jdir, tdir = synth3d
    for name in ("times.txt", "intrinsics.txt"):
        assert (tdir / name).read_text() == (jdir / name).read_text()
    np.testing.assert_allclose(tum(tdir / "groundtruth.txt"), tum(jdir / "groundtruth.txt"),
                               rtol=0, atol=2e-9)
    off, total = 0, 0
    for d in ("images", "sharp"):
        names = sorted(os.listdir(jdir / d))
        assert names == sorted(os.listdir(tdir / d)) and len(names) == 4
        for n in names:
            a = np.asarray(PILImage.open(jdir / d / n)).astype(int)
            b = tds.load_gray_image(str(tdir / d / n)).astype(int)
            assert np.abs(a - b).max() <= 1, (d, n)
            off += int((a != b).sum())
            total += a.size
    print(f"synth --scene 3d: {off} of {total} pixels one grey level off")
    graze = silhouette = 0
    for n in sorted(os.listdir(jdir / "depths")):
        a, b = np.load(jdir / "depths" / n), np.load(tdir / "depths" / n)
        assert a.dtype == b.dtype == np.float32
        rel = np.abs(b.astype(np.float64) - a) / a
        # a silhouette pixel: its 3x3 neighbourhood spans a depth jump > 10 %
        pad = np.pad(a, 1, mode="edge")
        win = np.stack([pad[dy:dy + a.shape[0], dx:dx + a.shape[1]]
                        for dy in range(3) for dx in range(3)])
        edge = win.max(axis=0) > 1.1 * win.min(axis=0)
        assert rel[~edge].max() <= 1e-5, n
        graze += int((rel[edge] > 1e-5).sum())
        silhouette += int(edge.sum())
    print(f"synth --scene 3d: {graze} of {silhouette} silhouette depth pixels beyond 1e-5 "
          "relative")
    assert graze <= 0.01 * silhouette
    z0 = np.load(tdir / "depths" / "frame_0000.npy")
    assert z0.min() > 0.3 and (z0.max() - z0.min()) / z0.mean() > 0.2


def test_track_on_the_3d_sequence(synth3d, tmp_path):
    """tests/test_cli_e2e.py::test_synth_3d_scene_tracks on the port's own
    sequence with the port's tracker: ATE < 4e-2 m."""
    _, seq = synth3d
    config = tmp_path / "config.json"
    config.write_text(json.dumps({
        "num_pyramid_levels": 2, "num_virtual_poses": [5, 5], "huber_a": 10.0,
        "keyframe_max_flow_mag0": 1e9, "keyframe_max_flow_mag1": 1e9,
        "detector": {"score_threshold": 5.0, "cell_h": 12, "cell_w": 12, "max_keypoints": 256},
        "dtype": "float64"}))
    run_quiet(tcli.main, [
        "track", "--images", str(seq / "images"), "--depths", str(seq / "depths"),
        "--dataset-type", "eth3d", "--times", str(seq / "times.txt"),
        "--intrinsics", (seq / "intrinsics.txt").read_text().strip(),
        "--output", str(tmp_path / "est.txt"), "--chunk", "2", "--inflight", "2",
        "--config", str(config), "--device", "cpu"])
    est, gt = tum(tmp_path / "est.txt"), tum(seq / "groundtruth.txt")
    ate = float(np.sqrt(np.mean(np.sum((est[:, 1:4] - gt[:, 1:4]) ** 2, axis=1))))
    print(f"3d sequence ATE {ate:.3e} m")
    assert ate < 4e-2, ate


def test_unreal_pose_and_imu_log_loaders(tmp_path):
    rng = np.random.default_rng(8)
    rows = np.concatenate([np.arange(5)[:, None] * 0.1, rng.normal(0, 1, (5, 10))], axis=1)
    with open(tmp_path / "gt.txt", "w") as f:
        f.write("# time x y z qx qy qz qw vx vy vz\n")
        for r in rows:
            f.write(" ".join(f"{v:.9f}" for v in r) + "\n")
    for a, b in zip(jds.load_unreal_gt_poses(str(tmp_path / "gt.txt")),
                    tds.load_unreal_gt_poses(str(tmp_path / "gt.txt"))):
        np.testing.assert_array_equal(b, a)
    imu = np.concatenate([np.arange(6)[:, None] * 0.005, rng.normal(0, 1, (6, 6))], axis=1)
    with open(tmp_path / "imu.txt", "w") as f:
        f.write("# t ax ay az gx gy gz\n\n")
        for r in imu:
            f.write(" ".join(f"{v:.9f}" for v in r) + "\n")
        f.write("1.0 2.0 3.0\n")          # a short row: skipped
    out = tds.load_imu_log(str(tmp_path / "imu.txt"))
    for a, b in zip(jds.load_imu_log(str(tmp_path / "imu.txt")), out):
        np.testing.assert_array_equal(b, a)
    assert out[1].shape == out[2].shape == (6, 3)
