"""The port's command line: a checkpointed and resumed ``track`` run
equals the uninterrupted run (per frame with the backend, and with the
joint window), the checkpoint loads under ``torch.load(weights_only=True)``,
and ``synth`` writes the JAX command line's files.

``synth`` computes in float32 in both packages (the reference fixes
jnp.float32), so its files agree to float32 rounding, not to the last bit.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from mba_vo_tpu import cli as jcli
from mba_vo_tpu_torch import cli as tcli
from mba_vo_tpu_torch.data import datasets as tds

from torch_cli_common import make_eth3d, run_quiet, track_args, tum


@pytest.fixture(scope="module")
def eth3d(tmp_path_factory):
    return make_eth3d(tmp_path_factory.mktemp("torch_cli_resume_seq"))


def test_checkpointed_and_resumed_run_equals_the_straight_run(eth3d, tmp_path):
    args = track_args(eth3d, "t_straight.txt", ["--backend", "ba+pg", "--device", "cpu"])
    run_quiet(tcli.main, args)
    ckpt = tmp_path / "ckpt"
    first = track_args(eth3d, "t_first.txt", ["--backend", "ba+pg", "--device", "cpu",
                                              "--max-frames", "3", "--checkpoint-every", "3",
                                              "--checkpoint-dir", str(ckpt)])
    run_quiet(tcli.main, first)
    state = torch.load(ckpt / "state" / "state.pt", weights_only=True)
    assert len(state["backend"]["keyframes"]) >= 2 and state["keyframe_levels"]
    resumed = track_args(eth3d, "t_resumed.txt", ["--backend", "ba+pg", "--device", "cpu",
                                                  "--resume", "--checkpoint-dir", str(ckpt)])
    out = run_quiet(tcli.main, resumed)
    assert "resumed at frame 3" in out
    straight, tail = tum(eth3d / "t_straight.txt"), tum(eth3d / "t_resumed.txt")
    np.testing.assert_array_equal(tail, straight[3:])


def test_resumed_joint_window_run_equals_the_straight_run(eth3d, tmp_path):
    """The joint path's chunks start where a call starts (and after each
    keyframe), so the uninterrupted run keeps the same checkpoint cadence."""
    opts = ["--backend", "ba", "--device", "cpu", "--chunk", "2", "--joint-window",
            "--checkpoint-every", "3"]
    run_quiet(tcli.main, track_args(eth3d, "t_jstraight.txt", [
        *opts, "--checkpoint-dir", str(tmp_path / "straight")]))
    ckpt = tmp_path / "ckpt"
    run_quiet(tcli.main, track_args(eth3d, "t_jfirst.txt", [
        *opts, "--max-frames", "3", "--checkpoint-dir", str(ckpt)]))
    state = torch.load(ckpt / "state" / "state.pt", weights_only=True)
    assert state["joint_knots"]
    run_quiet(tcli.main, track_args(eth3d, "t_jresumed.txt", [
        *opts, "--resume", "--checkpoint-dir", str(ckpt)]))
    np.testing.assert_array_equal(tum(eth3d / "t_jresumed.txt"),
                                  tum(eth3d / "t_jstraight.txt")[3:])


@pytest.fixture(scope="module")
def synth_pair(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_synth")
    argv = ["synth", "--num-frames", "3", "--height", "48", "--width", "64",
            "--num-samples", "5", "--trajectory", "loop", "--texture", "random",
            "--noise", "1.5", "--seed", "2"]
    run_quiet(jcli.main, argv + ["--output", str(root / "jax")])
    run_quiet(tcli.main, argv + ["--output", str(root / "torch"), "--device", "cpu"])
    return root / "jax", root / "torch"


def test_synth_writes_the_same_files(synth_pair):
    jdir, tdir = synth_pair
    for name in ("times.txt", "intrinsics.txt"):
        assert (tdir / name).read_text() == (jdir / name).read_text()
    np.testing.assert_allclose(tum(tdir / "groundtruth.txt"), tum(jdir / "groundtruth.txt"),
                               rtol=0, atol=2e-9)
    names = sorted(os.listdir(jdir / "depths"))
    assert names == sorted(os.listdir(tdir / "depths")) and len(names) == 4
    for n in names:
        a, b = np.load(jdir / "depths" / n), np.load(tdir / "depths" / n)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)


def test_synth_pngs_differ_only_at_float32_knife_edges(synth_pair):
    """8-bit frames: equal pixels, except (a) one grey level where the
    float32 render lies within float32 rounding of an integer, and (b) the
    one-pixel image border of the loop's closing frame, whose pose is the
    identity up to float32 rounding: its border taps sit exactly on the
    image edge, where either package's rounding can put a tap out of bounds
    (sampled as 0). Both kinds are counted."""
    jdir, tdir = synth_pair
    last = sorted(os.listdir(jdir / "images"))[-1]
    level, border = 0, 0
    for d in ("images", "sharp"):
        names = sorted(os.listdir(jdir / d))
        assert names == sorted(os.listdir(tdir / d))
        for n in names:
            a = np.asarray(PILImage.open(jdir / d / n)).astype(int)
            b = tds.load_gray_image(str(tdir / d / n)).astype(int)
            diff = np.abs(a - b)
            if d == "images" and n == last:
                edge = np.ones_like(diff, bool)
                edge[1:-1, 1:-1] = False
                border += int((diff[edge] > 0).sum())
                diff = np.where(edge, 0, diff)
            assert diff.max() <= 1, (d, n)
            level += int((diff > 0).sum())
    assert level <= 4, level
    assert border <= 2 * (48 + 64), border


