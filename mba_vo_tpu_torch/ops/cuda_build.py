"""Build and load the port's CUDA kernels.

Nine sources under ``mba_vo_tpu_torch/csrc/``, each compiled with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``:

  * ``window_bilinear.cu`` (K1) and ``window_bilinear_tiled.cu`` (K1-v):
    the windowed samplers, bound in ``ops/cuda_sampling.py``;
  * ``residual_rows.cu`` (K2) and ``normal_equations.cu`` (K3): the
    residual/Jacobian rows and the Huber normal equations, bound in
    ``ops/cuda_residual.py``; both include ``bulk_copy.cuh`` (bulk copies
    into shared memory on an mbarrier);
  * ``frame_layout.cu`` (K5), the patch layout, bound in
    ``ops/cuda_layout.py``; it shares ``spline_pose.cuh`` (the spline's
    poses on the device) with ``residual_rows.cu``;
  * ``image_bilinear.cu`` (K4), the direct path's whole-image sampler,
    bound in ``ops/cuda_image.py``;
  * ``lm_step.cu`` (K6-K8), the LM iteration's step, decision and commit,
    bound in ``ops/cuda_lm.py``; it shares ``spline_pose.cuh`` too;
  * ``knot_prior.cu`` (K9), the joint path's knot prior (its cost, g and
    H), bound in ``ops/cuda_lm.py`` too; it shares ``spline_pose.cuh``'s
    quaternion product and log;
  * ``bundle_adjust.cu`` (K10-K12), the backend's bundle-adjustment LM
    iteration (the normal equations, the Schur step, the decision and
    commit), bound in ``ops/cuda_ba.py``; it shares ``spline_pose.cuh``'s
    quaternion product, log and exp.

:func:`load` with ``defines`` builds one source a second time with those
macros set, into a library of its own name: a harness's build
(``bundle_adjust.cu`` with ``BA_PHASE_CLOCKS``, whose kernels stamp their
phases, for ``experiments/ba_kernels.py``), never one the path loads.

At first use :func:`build` compiles every source not built yet, all of
them at once (one ``nvcc`` process each), into ``build/mba_vo_tpu_torch/``
at the root of the checkout, keyed by a hash of the source, the headers
under ``csrc/`` and the flags.
nvcc's ``-Xptxas -v`` log (registers, shared memory, spills) is kept beside
each library and read into :data:`BUILD_LOG`. Nothing here runs when the
module is imported, so CPU-only installs import it freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

# nvcc's output per source (with -Xptxas -v: registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "window_bilinear": _CSRC / "window_bilinear.cu",
    "window_bilinear_tiled": _CSRC / "window_bilinear_tiled.cu",
    "residual_rows": _CSRC / "residual_rows.cu",
    "normal_equations": _CSRC / "normal_equations.cu",
    "frame_layout": _CSRC / "frame_layout.cu",
    "image_bilinear": _CSRC / "image_bilinear.cu",
    "lm_step": _CSRC / "lm_step.cu",
    "knot_prior": _CSRC / "knot_prior.cu",
    "bundle_adjust": _CSRC / "bundle_adjust.cu",
}
# flags of some sources only. K2, K4, K5, K6, K9 and K10-K12 round every operation as
# the plain versions' torch ops do, one at a time: a multiply-add contracted into
# one rounding moves a warped position or a patch anchor by an ulp, and on
# the image's border or an integer pixel (where a standing start lands
# exactly) that flips an in-image flag or picks another pixel (K6's
# retraction makes the knots those anchors come from; K9 is held to its
# plain version bit for bit; K10-K12 round their elementwise chains as the
# plain BA's torch ops do)
SOURCE_FLAGS = {name: ["-fmad=false"]
                for name in ("residual_rows", "frame_layout", "image_bilinear", "lm_step",
                             "knot_prior", "bundle_adjust")}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mba_vo_tpu_torch"
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_flags() -> List[str]:
    """nvcc's flags for every source, the compile-time constants of the
    kernels included: K1's band heights and K2/K3's largest tangent count,
    set in the modules that bind them and checked when a library loads."""
    from . import cuda_residual, cuda_sampling

    return ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            f"-DWB_BAND={cuda_sampling.BAND_ROWS}", f"-DWB_TOP={cuda_sampling.TOP_ROWS}",
            f"-DMAX_TANGENTS={cuda_residual.MAX_TANGENTS}"]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return str(nvcc)


def _start(name: str, headers: bytes, defines: Tuple[str, ...] = ()):
    """(the library's path, None where it is built already, else the
    running nvcc and its temporary output) for ``SOURCES[name]`` with the
    macros ``defines`` set (a library of its own name)."""
    flags = nvcc_flags() + SOURCE_FLAGS.get(name, []) + [f"-D{d}" for d in defines]
    source = SOURCES[name]
    key = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(flags).encode()).hexdigest()[:16]
    stem = "_".join((name,) + tuple(d.lower() for d in defines))
    path = BUILD_DIR / f"{stem}_{key}.so"
    if path.exists():
        log = path.with_suffix(".log")
        BUILD_LOG[stem] = log.read_text() if log.exists() else ""
        return path, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen([_nvcc(), *flags, "-o", str(tmp), str(source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return path, (stem, path, tmp, proc)


def _finish(running) -> None:
    failed = []
    for stem, path, tmp, proc in running:
        BUILD_LOG[stem], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}: nvcc failed ({proc.returncode}):\n{BUILD_LOG[stem]}")
        else:
            path.with_suffix(".log").write_text(BUILD_LOG[stem])
            os.replace(tmp, path)
    if failed:
        raise RuntimeError("\n".join(failed))


def _headers() -> bytes:
    return b"".join(h.read_bytes() for h in sorted(_CSRC.glob("*.cuh")))


def build() -> Dict[str, Path]:
    """Compile every kernel library whose source was not built already, all
    compilers started together; returns the libraries' paths by name."""
    paths, running = {}, []
    headers = _headers()
    for name in SOURCES:
        paths[name], job = _start(name, headers)
        if job is not None:
            running.append(job)
    _finish(running)
    return paths


def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The library built from ``SOURCES[name]`` (building every source not
    built yet on the first call), loaded once a process. With ``defines``
    the source is built alone a second time with those macros set, into a
    library of its own name: a harness's build (``bundle_adjust.cu``'s
    ``BA_PHASE_CLOCKS``), never the one the path loads."""
    stem = "_".join((name,) + tuple(d.lower() for d in defines))
    if stem not in _libs:
        if defines:
            path, job = _start(name, _headers(), tuple(defines))
            _finish([job] if job is not None else [])
        else:
            path = build()[name]
        _libs[stem] = ctypes.CDLL(str(path))
    return _libs[stem]
