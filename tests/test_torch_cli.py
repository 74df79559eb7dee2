"""The port's command line (mba_vo_tpu_torch/cli.py) against the JAX
package's, on the CPU in float64: the eth3d-format fixture of
tests/torch_cli_common.py (8-bit PNG frames, 16-bit PNG depth / 5000, sharp
keyframes, a times file) goes through ``track`` with the keyframe backend
per frame, in chunks and with the joint window, and the TUM files must
agree to TUM_TOL; ``eval`` prints the same numbers; ``--shard-devices``
outside ``torch.distributed.run`` raises the reference's ValueError; the
config loaders behave as the JAX ones.
tests/test_torch_cli_models.py has the camera models, overlays and
``synth --scene 3d``.

The backend's corners are detected in float32 in both packages, where XLA
and torch round the detector's sums differently
(tests/test_torch_vo_backend.py); the trajectories agree to TUM_TOL all
the same. tests/test_torch_cli_resume.py has checkpoint/resume and
``synth``.
"""

import json

import numpy as np
import pytest
import torch

from mba_vo_tpu import cli as jcli
from mba_vo_tpu.utils import config as jconfig
from mba_vo_tpu_torch import cli as tcli
from mba_vo_tpu_torch.utils import config as tconfig

from torch_cli_common import N_FRAMES, make_eth3d, run_quiet, track_args, tum

TUM_TOL = 1e-8    # TUM files print 9 decimals


@pytest.fixture(scope="module")
def eth3d(tmp_path_factory):
    return make_eth3d(tmp_path_factory.mktemp("torch_cli_seq"))


CASES = {
    "ba_per_frame": ["--backend", "ba"],
    "ba_pg_chunk2": ["--backend", "ba+pg", "--chunk", "2"],
    "ba_pg_per_frame": ["--backend", "ba+pg"],
    "ba_joint_chunk2": ["--backend", "ba", "--chunk", "2", "--joint-window"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_track_matches_jax(eth3d, case):
    extra = CASES[case]
    out_j = run_quiet(jcli.main, track_args(eth3d, f"j_{case}.txt", extra))
    out_t = run_quiet(tcli.main, track_args(eth3d, f"t_{case}.txt", [*extra, "--device", "cpu"]))
    a, b = tum(eth3d / f"j_{case}.txt"), tum(eth3d / f"t_{case}.txt")
    assert a.shape == b.shape == (N_FRAMES + 1, 8)
    np.testing.assert_allclose(b, a, rtol=0, atol=TUM_TOL)
    # the same per-frame lines: frame, time, position and kernel length
    assert out_t.count("frame ") == out_j.count("frame ") == N_FRAMES + 1
    assert out_t.count("loop-closure edge") == out_j.count("loop-closure edge")


def test_eval_prints_the_same_numbers(eth3d):
    run_quiet(jcli.main, track_args(eth3d, "j_eval.txt"))
    argv = ["eval", "--est", str(eth3d / "j_eval.txt"), "--ref", str(eth3d / "groundtruth.txt")]
    for extra in ([], ["--with-scale"]):
        out_j = json.loads(run_quiet(jcli.main, argv + extra))
        out_t = json.loads(run_quiet(tcli.main, argv + extra))
        assert out_t.keys() == out_j.keys()
        for k in out_j:
            np.testing.assert_allclose(out_t[k], out_j[k], rtol=1e-12)


def test_unported_options_raise(eth3d, tmp_path):
    """Nothing is left unported: the ROADMAP table of unported options is
    gone, and sharding asked for by the flag or by a backend config, run
    outside torch.distributed.run (no process group), raises the
    reference's ValueError naming the visible count. The sharded command
    line runs in tests/test_torch_parallel.py."""
    assert not hasattr(tcli, "ROADMAP_ITEM") and not hasattr(tcli, "_not_ported")
    base = track_args(eth3d, "t_x.txt", ["--device", "cpu"])
    with pytest.raises(ValueError, match="shard_devices=2 but only 1 devices are visible"):
        tcli.main(base + ["--shard-devices", "2"])
    (tmp_path / "sharded.json").write_text(json.dumps({"shard_devices": 2}))
    argv = base + ["--backend", "ba"]
    argv[argv.index("--backend-config") + 1] = str(tmp_path / "sharded.json")
    with pytest.raises(ValueError, match="shard_devices=2 but only 1 devices are visible"):
        tcli.main(argv)
    assert not (eth3d / "t_x.txt").exists()


def test_cuda_device_without_a_card_raises(eth3d):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(track_args(eth3d, "t_cuda.txt"))


def test_cuda_device_under_the_launcher_without_a_card_raises(eth3d, monkeypatch):
    """Under ``torch.distributed.run``, ``track --device cuda`` with no card
    raises as ``synth`` does, before any process group is made: the rank is
    not moved to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    launcher = dict(MASTER_ADDR="localhost", MASTER_PORT="29531", WORLD_SIZE="2", RANK="0",
                    LOCAL_RANK="0", LOCAL_WORLD_SIZE="2")
    for k, v in launcher.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="track --device cuda but no CUDA device is "
                                           "visible; pass --device cpu"):
        tcli.main(track_args(eth3d, "t_launcher.txt", ["--shard-devices", "2"]))
    assert not torch.distributed.is_initialized()
    assert not (eth3d / "t_launcher.txt").exists()


def test_backend_config_from_dict_matches_jax():
    data = {"window_size": 5, "max_hamming": 80.0,
            "detector": {"score_threshold": 2.0, "cell_h": 10, "cell_w": 10,
                         "max_keypoints": 100},
            "ba": {"max_iterations": 7, "huber_a": 3.0},
            "pose_graph": {"max_iterations": 9}}
    from mba_vo_tpu_torch import interop

    assert tconfig.backend_config_from_dict(data) == interop.backend_config_from_fields(
        jconfig.backend_config_from_dict(data))
    for bad in ({"window": 3}, {"ba": {"iterations": 3}}, {"pose_graph": {"lam": 1.0}}):
        with pytest.raises(ValueError, match="unknown"):
            tconfig.backend_config_from_dict(bad)
        with pytest.raises(ValueError, match="unknown"):
            jconfig.backend_config_from_dict(bad)


def test_tracker_config_round_trip_matches_jax(tmp_path):
    data = {"num_pyramid_levels": 2, "num_virtual_poses": [3, 3], "dtype": "float64",
            "detector": {"score_threshold": 5.0, "cell_h": 12, "cell_w": 12,
                         "max_keypoints": 256}}
    from mba_vo_tpu_torch import interop

    tc = tconfig.tracker_config_from_dict(data)
    assert tc == interop.config_from_fields(jconfig.tracker_config_from_dict(data))
    tconfig.save_tracker_config(tc, str(tmp_path / "c.json"))
    assert tconfig.load_tracker_config(str(tmp_path / "c.json")) == tc
    with pytest.raises(ValueError, match="unknown TrackerConfig keys"):
        tconfig.tracker_config_from_dict({"levels": 3})
