"""The port imports torch and numpy only: importing every module of
mba_vo_tpu_torch loads neither JAX nor the JAX package, nor PIL or orbax
(the port reads and writes its PNGs with data/png.py and checkpoints with
torch.save), nor builds or loads a kernel. That holds for
ops/cuda_build.py (which builds all nine kernel sources),
ops/cuda_sampling.py (K1, K1-v), ops/cuda_residual.py (K2, K3),
ops/cuda_layout.py (K5), ops/cuda_image.py (K4), ops/cuda_lm.py (K6-K9,
the LM iteration and the knot prior), ops/cuda_ba.py (K10-K12, the bundle
adjustment's iteration), the sweep harnesses
experiments/kernel_variants.py, experiments/residual_kernels.py,
experiments/ba_kernels.py,
experiments/f32_sensitivity.py and experiments/pose_order.py, the
backend, the command line, the loop benchmark, the camera/trajectory/sensor
models, the scene renderer, the overlay and profiling utilities and the
sharding package parallel/ (whose modules import torch.distributed, never
jax.distributed) as for every other module."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import mba_vo_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

PROBE = """
import importlib, pkgutil, sys
import mba_vo_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mba_vo_tpu_torch.__path__, "mba_vo_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from mba_vo_tpu_torch.ops import (cuda_ba, cuda_build, cuda_image, cuda_layout, cuda_lm,
                                  cuda_residual, cuda_sampling)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mba_vo_tpu", "triton", "PIL", "orbax"))
from mba_vo_tpu_torch.experiments import kernel_variants
import os
built = os.path.exists(cuda_build.BUILD_DIR)
libs = {**cuda_build._libs, **cuda_sampling._loaded, **cuda_residual._loaded,
        **cuda_layout._loaded, **cuda_image._loaded, **cuda_lm._loaded, **cuda_ba._loaded}
print(len(names), bad, libs, cuda_build.BUILD_LOG, built,
      all(f"mba_vo_tpu_torch.{m}" in names for m in (
          "experiments.kernel_variants", "experiments.loop_bench", "cli",
          "backend.vo_backend", "utils.checkpoint", "data.png", "models.camera",
          "models.trajectory", "models.sensors", "core.navstate", "data.scene3d",
          "utils.viz", "utils.profiling", "backend.dynamic_points", "parallel",
          "parallel.mesh", "parallel.distributed", "parallel.sharded",
          "parallel.sharded_ba", "utils.collectives", "ops.cuda_build",
          "ops.cuda_residual", "experiments.residual_kernels",
          "experiments.f32_sensitivity", "ops.cuda_layout", "ops.cuda_image",
          "experiments.pose_order", "experiments.paired_fps", "experiments.ptx_ops",
          "ops.cuda_lm", "ops.cuda_ba", "experiments.ba_kernels")))
"""


# importing must not create the build directory; it may be there already
EXPECT_BUILT = str((ROOT / "build" / "mba_vo_tpu_torch").exists())


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, rest = out.stdout.split(maxsplit=2)
    assert int(n) >= 55
    # no library loaded, nothing compiled, the harness among the modules
    assert bad == "[]" and rest.split() == ["{}", "{}", EXPECT_BUILT, "True"], out.stdout


def test_package_layout_mirrors_the_reference():
    subpackages = {m.name for m in pkgutil.iter_modules(mba_vo_tpu_torch.__path__) if m.ispkg}
    assert {"core", "ops", "solver", "tracker", "utils", "data", "backend",
            "models", "parallel"} <= subpackages
    # the sharding package exports the reference subpackage's names
    import mba_vo_tpu_torch.parallel as tpar

    assert {"make_mesh", "pad_keypoints", "shard_level_data", "optimize_level_sharded",
            "make_ba_mesh", "shard_ba_problem", "run_bundle_adjustment_sharded"} <= set(dir(tpar))
