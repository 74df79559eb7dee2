"""The port imports torch and numpy only: importing every module of
mba_vo_tpu_torch loads neither JAX nor the JAX package, nor builds or loads
a kernel. That holds for ops/cuda_sampling.py (two kernels) and for the sweep
harness experiments/kernel_variants.py as for every other module."""

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
from mba_vo_tpu_torch.ops import cuda_sampling
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "mba_vo_tpu", "triton"))
from mba_vo_tpu_torch.experiments import kernel_variants
import os
built = os.path.exists(cuda_sampling._BUILD_DIR)
print(len(names), bad, cuda_sampling._libs, cuda_sampling.BUILD_LOG, built,
      "mba_vo_tpu_torch.experiments.kernel_variants" in names)
"""


# importing must not create the build directory; it may be there already
EXPECT_BUILT = str((ROOT / "build" / "mba_vo_tpu_torch").exists())


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, rest = out.stdout.split(maxsplit=2)
    assert int(n) >= 23
    # no library loaded, nothing compiled, the harness among the modules
    assert bad == "[]" and rest.split() == ["{}", "{}", EXPECT_BUILT, "True"], out.stdout


def test_package_layout_mirrors_the_reference():
    subpackages = {m.name for m in pkgutil.iter_modules(mba_vo_tpu_torch.__path__) if m.ispkg}
    assert {"core", "ops", "solver", "tracker", "utils", "data"} <= subpackages
