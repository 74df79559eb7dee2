"""How ``cli track``'s read-ahead pays on PNGs that take the decoder's slow path.

``cli synth`` writes filter 0 on every row; real datasets' PNGs use the
average and Paeth filters, which ``data/png.py`` undoes in Python loops.
This writes 8d's VGA sequence (``cli synth`` defaults), re-encodes its
frames with the Paeth filter (:func:`paeth_png`), and measures

  * decoding alone: a batch of the Paeth frames on the calling thread, in
    two threads and in two spawned processes (frames/s of decoding);
  * ``cli track --chunk 1`` in f32 under bench options with each
    ``cli.READ_AHEAD`` mode (None: every file on the calling thread;
    "thread"; "process"), in rounds whose order alternates (ABC CBA ...),
    wall time between device synchronisations, and the median frames/s of
    each mode.

    python3 -m mba_vo_tpu_torch.experiments.read_ahead [--rounds 4]
        [--frames 21] [--device cuda] [--out FILE]

Run it from the repository's root on the card: it takes bench options
from ``chip_smoke.py``.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import statistics
import struct
import sys
import tempfile
import time
import zlib

import numpy as np

MODES = (None, "thread", "process")


def paeth_png(img: np.ndarray) -> bytes:
    """An 8-bit grey PNG with the Paeth filter (4) on every row, encoded
    through zlib."""
    from ..data.png import SIGNATURE, _chunk

    x = img.astype(np.int32)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    rows = ((x - pred) & 0xFF).astype(np.uint8)
    raw = np.concatenate([np.full((x.shape[0], 1), 4, np.uint8), rows], axis=1)
    header = struct.pack(">IIBBBBB", x.shape[1], x.shape[0], 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def paeth_copy(seq: str, out: str) -> None:
    """``seq`` copied to ``out`` with its blurred and sharp frames
    re-encoded by :func:`paeth_png`."""
    import shutil

    from ..data.png import read_png

    shutil.copytree(seq, out)
    for d in ("images", "sharp"):
        for name in sorted(os.listdir(os.path.join(seq, d))):
            with open(os.path.join(out, d, name), "wb") as f:
                f.write(paeth_png(read_png(os.path.join(seq, d, name))))


def decode_rate(paths, mode) -> float:
    """Frames/s of decoding ``paths`` on the calling thread (None) or in a
    pool of two threads or two spawned processes, the pool's start
    included."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    from ..data.png import read_png

    t0 = time.perf_counter()
    if mode is None:
        for p in paths:
            read_png(p)
    else:
        pool = (ThreadPoolExecutor(2) if mode == "thread" else ProcessPoolExecutor(
            2, mp_context=multiprocessing.get_context("spawn")))
        with pool:
            list(pool.map(read_png, paths))
    return len(paths) / (time.perf_counter() - t0)


def run(rounds=4, frames=21, device="cuda", out=print) -> dict:
    import dataclasses

    import torch

    from .. import cli
    from ..utils.config import tracker_config_to_dict

    sys.path.insert(0, os.getcwd())
    import chip_smoke

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    res = {"decode": {}, "track": {str(m): [] for m in MODES}}
    with tempfile.TemporaryDirectory(prefix="read_ahead_") as root:
        seq, paeth = os.path.join(root, "vga"), os.path.join(root, "vga_paeth")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["synth", "--output", seq, "--device", device,
                             "--num-frames", str(frames - 1)]) == 0
        paeth_copy(seq, paeth)
        cfg = dataclasses.replace(chip_smoke.bench_config("float32"),
                                  keyframe_max_flow_mag0=15.0, keyframe_max_flow_mag1=30.0)
        config = os.path.join(seq, "config.json")
        with open(config, "w") as f:
            json.dump(tracker_config_to_dict(cfg), f)
        images = [os.path.join(paeth, "images", n)
                  for n in sorted(os.listdir(os.path.join(paeth, "images")))]
        for mode in MODES:
            res["decode"][str(mode)] = decode_rate(images, mode)
        out("decoding " + f"{len(images)} Paeth VGA frames, frames/s: " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["decode"].items()))
        argv = chip_smoke.track_argv(paeth, os.path.join(root, "est.txt"), device, config,
                                     ["--chunk", "1"])
        # one untimed run: the first pass reads the files from disk
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(argv)
        order = list(MODES)
        try:
            for r in range(rounds):
                for mode in (order if r % 2 == 0 else order[::-1]):
                    cli.READ_AHEAD = mode
                    sync()
                    t0 = time.perf_counter()
                    with contextlib.redirect_stdout(io.StringIO()):
                        assert cli.main(argv) == 0
                    sync()
                    res["track"][str(mode)].append(frames / (time.perf_counter() - t0))
        finally:
            cli.READ_AHEAD = "process"
    res["median"] = {k: statistics.median(v) for k, v in res["track"].items()}
    out(f"cli track --chunk 1, f32, {frames} Paeth VGA frames, frames/s by run: " + "; ".join(
        f"{k} " + " ".join(f"{x:.3f}" for x in v) for k, v in res["track"].items()))
    out("medians: " + ", ".join(f"{k} {v:.3f}" for k, v in res["median"].items()))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rounds", type=int, default=4)
    p.add_argument("--frames", type=int, default=21)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if args.device == "cuda":
        from .kernel_variants import card_line

        print(card_line())
    res = run(args.rounds, args.frames, args.device)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
