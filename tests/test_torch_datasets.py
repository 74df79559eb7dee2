"""The port's data/png.py, data/datasets.py and utils/metrics.py against PIL
and the JAX package: PNGs read and written as PIL does (8-bit and 16-bit
grey, every filter type PIL writes, and a hand-made file with row filters
1-4), every I/O function against the JAX package's on the same files, the
metrics on random trajectories, and the metrics module a copy of the
original."""

import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image as PILImage

from mba_vo_tpu.core.spline import spline_pose_at as jpose_at
from mba_vo_tpu.data import datasets as jds
from mba_vo_tpu.utils import metrics as jmetrics
from mba_vo_tpu_torch.core.spline import spline_pose_at as tpose_at
from mba_vo_tpu_torch.data import datasets as tds
from mba_vo_tpu_torch.data import png
from mba_vo_tpu_torch.utils import metrics as tmetrics

from torch_port_common import npy, random_quats

ROOT = Path(__file__).resolve().parents[1]


def test_metrics_module_is_a_copy_of_the_original():
    assert ((ROOT / "mba_vo_tpu_torch" / "utils" / "metrics.py").read_text()
            == (ROOT / "mba_vo_tpu" / "utils" / "metrics.py").read_text())


def images(seed=0):
    """8-bit and 16-bit grey images with flat, ramp and noisy rows, so that
    PIL's per-row filter choice uses several filter types."""
    rng = np.random.default_rng(seed)
    a8 = rng.integers(0, 256, (37, 53)).astype(np.uint8)
    a8[5:15] = np.arange(53, dtype=np.uint8)[None]
    a8[20:24] = 200
    a8[24:30] = (np.arange(53)[None] * 3 + np.arange(6)[:, None] * 7).astype(np.uint8)
    a16 = rng.integers(0, 65536, (29, 41)).astype(np.uint16)
    a16[:4] = 300
    a16[8:14] = (np.arange(41)[None] * 1000 + 17).astype(np.uint16)
    return a8, a16


def row_filters(path):
    data = Path(path).read_bytes()
    header, idat = None, b""
    for kind, body in png._chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
    width, height, depth = header[:3]
    stride = width * depth // 8
    raw = zlib.decompress(idat)
    return {raw[y * (stride + 1)] for y in range(height)}


@pytest.mark.parametrize("bits", [8, 16])
def test_read_matches_pil(tmp_path, bits):
    a = images()[0 if bits == 8 else 1]
    path = tmp_path / f"a{bits}.png"
    PILImage.fromarray(a).save(path)
    assert len(row_filters(path)) >= 3          # PIL mixed its filter types
    out = png.read_png(str(path))
    assert out.dtype == a.dtype
    np.testing.assert_array_equal(out, a)
    np.testing.assert_array_equal(out, np.asarray(PILImage.open(path)))


@pytest.mark.parametrize("bits", [8, 16])
def test_write_reads_back_in_pil(tmp_path, bits):
    a = images(1)[0 if bits == 8 else 1]
    path = tmp_path / f"w{bits}.png"
    png.write_png(str(path), a)
    im = PILImage.open(path)
    assert im.mode == ("L" if bits == 8 else "I;16")
    np.testing.assert_array_equal(np.asarray(im), a)
    np.testing.assert_array_equal(png.read_png(str(path)), a)


def _filter_row(ftype, cur, prior, bpp):
    """Encode one scanline with PNG filter ``ftype`` (the specification's
    forward filters, written out independently of the reader)."""
    out = bytearray(len(cur))
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) // 2
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (cur[i] - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


@pytest.mark.parametrize("bits", [8, 16])
def test_hand_made_file_with_filters_1_to_4(tmp_path, bits):
    a = images(2)[0 if bits == 8 else 1][:16]
    bpp = bits // 8
    rows = a.astype(">u2" if bits == 16 else np.uint8).view(np.uint8).reshape(a.shape[0], -1)
    raw, prior = b"", bytes(rows.shape[1])
    for y, row in enumerate(rows):
        raw += _filter_row(1 + y % 4, bytes(row), prior, bpp)
        prior = bytes(row)
    header = struct.pack(">IIBBBBB", a.shape[1], a.shape[0], bits, 0, 0, 0, 0)
    path = tmp_path / "filters.png"
    path.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", header)
                     + png._chunk(b"IDAT", zlib.compress(raw)) + png._chunk(b"IEND", b""))
    assert row_filters(path) == {1, 2, 3, 4}
    np.testing.assert_array_equal(png.read_png(str(path)), a)
    np.testing.assert_array_equal(np.asarray(PILImage.open(path)), a)


def test_unsupported_png_raises(tmp_path):
    PILImage.fromarray(np.zeros((4, 5, 3), np.uint8)).save(tmp_path / "rgb.png")
    with pytest.raises(ValueError, match="colour type 2"):
        png.read_png(str(tmp_path / "rgb.png"))
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.write_png(str(tmp_path / "f.png"), np.zeros((4, 5), np.float32))


@pytest.mark.parametrize("bits", [8, 16])
def test_load_gray_image_matches_jax(tmp_path, bits):
    a = images(3)[0 if bits == 8 else 1]
    PILImage.fromarray(a).save(tmp_path / "g.png")
    out = tds.load_gray_image(str(tmp_path / "g.png"))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, jds.load_gray_image(str(tmp_path / "g.png")))


def test_depth_loaders_match_jax(tmp_path):
    rng = np.random.default_rng(4)
    H, W = 12, 17
    K = [20.0, 22.0, 8.0, 5.5]
    d16 = rng.integers(0, 65536, (H, W)).astype(np.uint16)
    PILImage.fromarray(d16).save(tmp_path / "d.png")
    ray = rng.uniform(0.5, 150.0, (H, W))
    np.savetxt(tmp_path / "d.txt", ray.reshape(-1))
    for fn, args in ((tds.load_depth_png16, (str(tmp_path / "d.png"),)),
                     (tds.load_depth_ascii, (str(tmp_path / "d.txt"), H, W)),
                     (tds.ray_depth_to_z, (ray, K))):
        jfn = getattr(jds, fn.__name__)
        out, ref = fn(*args), jfn(*args)
        assert out.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(out, ref)
    for kind, path in (("eth3d", tmp_path / "d.png"), ("unreal", tmp_path / "d.txt")):
        np.testing.assert_array_equal(tds.load_depth(str(path), kind, K, H, W),
                                      jds.load_depth(str(path), kind, K, H, W))
    with pytest.raises(ValueError, match="unknown dataset type"):
        tds.load_depth(str(tmp_path / "d.png"), "kitti")
    with pytest.raises(ValueError, match="expected"):
        tds.load_depth_ascii(str(tmp_path / "d.txt"), H + 1, W)


def test_image_folder_matches_jax(tmp_path):
    for name in ("b.png", "a.PNG", "c.jpg", "notes.txt", "d.pgm"):
        (tmp_path / name).write_bytes(b"")
    assert tds.list_image_folder(str(tmp_path)) == jds.list_image_folder(str(tmp_path))


def trajectory(seed, n=12):
    rng = np.random.default_rng(seed)
    return (np.cumsum(rng.uniform(0.05, 0.1, n)), rng.normal(0, 1, (n, 3)),
            random_quats(rng, n, 0.3))


def test_tum_files_match_jax(tmp_path):
    times, t, q = trajectory(5)
    tds.save_tum_trajectory(str(tmp_path / "t.txt"), times, t, q)
    jds.save_tum_trajectory(str(tmp_path / "j.txt"), times, t, q)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    with open(tmp_path / "t.txt", "a") as f:
        f.write("# comment\n\n1.0 2.0\n")
    for a, b in zip(tds.load_tum_trajectory(str(tmp_path / "t.txt")),
                    jds.load_tum_trajectory(str(tmp_path / "t.txt"))):
        np.testing.assert_array_equal(a, b)


def test_knots_from_tum_match_jax(tmp_path):
    times, t, q = trajectory(6, n=6)
    jds.save_tum_trajectory(str(tmp_path / "k.txt"), times, t, q)
    kj = jds.knots_from_tum(str(tmp_path / "k.txt"))
    kt = tds.knots_from_tum(str(tmp_path / "k.txt"))
    for f in ("t", "q", "t0", "dt"):
        np.testing.assert_array_equal(npy(getattr(kt, f)), np.asarray(getattr(kj, f)))
    for time in (float(times[1]) + 0.01, float(times[3]) + 0.02):
        pj, pt = jpose_at(kj, time, 2), tpose_at(kt, time, 2)
        np.testing.assert_allclose(npy(pt.t), np.asarray(pj.t), rtol=0, atol=1e-12)
    (tmp_path / "one.txt").write_text("0 0 0 0 0 0 0 1\n")
    with pytest.raises(ValueError, match="at least 2 knots"):
        tds.knots_from_tum(str(tmp_path / "one.txt"))


@pytest.mark.parametrize("colors", [False, True])
def test_ply_matches_jax(tmp_path, colors):
    rng = np.random.default_rng(7)
    pts = rng.normal(size=(9, 3))
    col = rng.integers(0, 256, (9, 3)) if colors else None
    tds.save_ply(str(tmp_path / "t.ply"), pts, col)
    jds.save_ply(str(tmp_path / "j.ply"), pts, col)
    assert (tmp_path / "t.ply").read_text() == (tmp_path / "j.ply").read_text()


@pytest.mark.parametrize("seed", range(3))
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.normal(0, 0.1, (40, 3)), axis=0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    est = 1.3 * ref @ R.T + rng.normal(0, 0.01, ref.shape) + 0.5
    for with_scale in (False, True):
        for a, b in zip(tmetrics.align_trajectories_se3(est, ref, with_scale),
                        jmetrics.align_trajectories_se3(est, ref, with_scale)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tmetrics.ate_rmse(est, ref, with_scale=with_scale),
                                   jmetrics.ate_rmse(est, ref, with_scale=with_scale),
                                   rtol=1e-12)
    np.testing.assert_allclose(tmetrics.ate_rmse(est[:2], ref[:2]),
                               jmetrics.ate_rmse(est[:2], ref[:2]), rtol=1e-12)
    for delta in (1, 3):
        np.testing.assert_allclose(tmetrics.rpe_rmse(est, ref, delta),
                                   jmetrics.rpe_rmse(est, ref, delta), rtol=1e-12)
