"""The port imports torch and numpy only: importing every module of
mba_vo_tpu_torch loads neither JAX nor the JAX package, nor builds or loads
a kernel."""

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
print(len(names), bad, cuda_sampling._lib)
"""


def test_every_module_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad, lib = out.stdout.split(maxsplit=2)
    assert int(n) >= 20
    assert bad == "[]" and lib.strip() == "None", out.stdout


def test_package_layout_mirrors_the_reference():
    subpackages = {m.name for m in pkgutil.iter_modules(mba_vo_tpu_torch.__path__) if m.ispkg}
    assert {"core", "ops", "solver", "tracker", "utils", "data"} <= subpackages
