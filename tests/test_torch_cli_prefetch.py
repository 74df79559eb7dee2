"""The port's PNG row filters and ``track``'s read-ahead, on the CPU.

``data/png.py`` undoes the five row filters of the PNG specification; the
files here are encoded by this test through ``zlib`` with a chosen filter
on every row (or a different one on each row), so each filter's decoder
must give the bytes of the filter-0 twin that ``write_png`` writes.

``track`` reads ahead of the tracker (``cli.READ_AHEAD``: two spawned
decoders, as the command line runs, or two threads): on a copy of
tests/torch_cli_common.py's fixture whose frames are re-encoded with the
Paeth filter (the slow path of the decoder, which real datasets' PNGs
take), both write the TUM file of a run that reads every file on the
calling thread (``READ_AHEAD = None``) on the original frames. Unreal ASCII depth maps go through the runtime library's
``DepthPrefetcher`` when reading ahead, and give the same trajectory.
"""

import os
import shutil
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from mba_vo_tpu_torch import cli as tcli
from mba_vo_tpu_torch.data import png

from torch_cli_common import KVEC, make_eth3d, run_quiet, track_args, tum

RUNTIME = str(Path(__file__).resolve().parents[1] / "runtime")

# one intra-op thread, as the other port tests run (several files to a
# machine); the decode workers are processes or threads of their own
torch.set_num_threads(1)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_png(img: np.ndarray, filters) -> bytes:
    """A grey 8- or 16-bit PNG of ``img`` whose row y is written with
    filter ``filters[y % len(filters)]``."""
    height, width = img.shape
    depth = 8 * img.dtype.itemsize
    bpp = depth // 8
    x = img.astype(">u2" if depth == 16 else np.uint8).view(np.uint8).reshape(height, -1)
    x = x.astype(np.int32)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = {0: 0, 1: left, 2: up, 3: (left + up) // 2, 4: _paeth(left, up, upleft)}
    ftype = np.array([filters[y % len(filters)] for y in range(height)])
    rows = np.stack([(x[y] - pred[f] if np.isscalar(pred[f]) else x[y] - pred[f][y]) & 0xFF
                     for y, f in enumerate(ftype)]).astype(np.uint8)
    raw = np.concatenate([ftype[:, None].astype(np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", width, height, depth, 0, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", header)
            + png._chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("filters", [(1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["sub", "up", "average", "paeth", "mixed"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_filtered_png_decodes_to_its_filter0_twin(tmp_path, filters, dtype):
    rng = np.random.default_rng(7)
    hi = 256 if dtype == np.uint8 else 65536
    # noise, flat runs and ramps: every branch of the Paeth predictor
    img = rng.integers(0, hi, (23, 37)).astype(dtype)
    img[5:9] = img[5:9, :1]
    img[12] = np.linspace(0, hi - 1, 37).astype(dtype)
    (tmp_path / "f.png").write_bytes(filtered_png(img, filters))
    png.write_png(str(tmp_path / "twin.png"), img)
    got, twin = png.read_png(str(tmp_path / "f.png")), png.read_png(str(tmp_path / "twin.png"))
    assert got.dtype == twin.dtype == dtype
    np.testing.assert_array_equal(got, twin)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(np.asarray(PILImage.open(tmp_path / "f.png")).astype(dtype),
                                  img)


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    """The command-line fixture, a copy whose 8-bit frames (blurred and
    sharp) are Paeth-filtered, and a copy with unreal ASCII ray depth."""
    root = make_eth3d(tmp_path_factory.mktemp("torch_prefetch"))
    paeth = Path(str(root) + "_paeth")
    shutil.copytree(root, paeth)
    for d in ("images", "sharp"):
        for f in sorted(os.listdir(paeth / d)):
            img = png.read_png(str(root / d / f))
            (paeth / d / f).write_bytes(filtered_png(img, (4,)))
    unreal = Path(str(root) + "_unreal")
    shutil.copytree(root, unreal)
    shutil.rmtree(unreal / "depths")
    os.makedirs(unreal / "depths")
    fx, fy, cx, cy = KVEC
    for f in sorted(os.listdir(root / "depths")):
        z = png.read_png(str(root / "depths" / f)).astype(np.float64) / 5000.0
        h, w = z.shape
        xn, yn = np.meshgrid((np.arange(w) - cx) / fx, (np.arange(h) - cy) / fy)
        ray = z * np.sqrt(1.0 + xn * xn + yn * yn)
        np.savetxt(unreal / "depths" / (f[:-4] + ".depth"), ray.reshape(-1), fmt="%.6f")
    return root, paeth, unreal


def run_track(root, out, read_ahead, monkeypatch, extra=()):
    monkeypatch.setattr(tcli, "READ_AHEAD", read_ahead)
    run_quiet(tcli.main, track_args(root, out, ["--device", "cpu", "--chunk", "2", *extra]))
    return tum(root / out)


def test_prefetch_writes_the_calling_thread_trajectory(seqs, monkeypatch):
    root, paeth, _ = seqs
    assert tcli.READ_AHEAD == "process"
    plain = run_track(root, "none.txt", None, monkeypatch)
    assert plain.shape[0] == 6
    for mode in ("process", "thread"):
        np.testing.assert_array_equal(run_track(paeth, f"{mode}.txt", mode, monkeypatch), plain)


def test_unreal_depth_goes_through_the_native_prefetcher(seqs, monkeypatch):
    _, _, unreal = seqs
    if RUNTIME not in sys.path:
        sys.path.insert(0, RUNTIME)
    import bindings

    calls = {"submit": 0, "fetch": 0, "made": 0}

    class Counting(bindings.DepthPrefetcher):
        def __init__(self, num_threads=2):
            calls["made"] += 1
            super().__init__(num_threads)

        def submit(self, path):
            calls["submit"] += 1
            return super().submit(path)

        def fetch(self, path, height, width):
            calls["fetch"] += 1
            return super().fetch(path, height, width)

    monkeypatch.setattr(bindings, "DepthPrefetcher", Counting)
    unreal_args = ["--dataset-type", "unreal"]
    read_ahead = run_track(unreal, "unreal_thread.txt", "thread", monkeypatch, unreal_args)
    assert calls["made"] == 1
    # every frame after the first is submitted ahead of its read, and read
    assert calls["submit"] == 5 and calls["fetch"] == 6
    on_thread = run_track(unreal, "unreal_none.txt", None, monkeypatch, unreal_args)
    assert calls["made"] == 1
    np.testing.assert_array_equal(read_ahead, on_thread)
