"""Which step of the windowed residual path moves the float32 tracker.

Runs two float32 paths of ``chip_smoke.py`` several times, each under one
variant of the windowed residual path and on the inputs as they are and
moved by about one float32 unit in the last place, and prints one JSON
line per run:

  * ``5a``: the bench scenario's 16 frames through ``track_frame`` from
    rest, bench options (LM iterations per level of each frame, K1
    launches, ATE);
  * ``9d``: the realism ladder at its test recipe (128x160), every rung
    (ATE by rung, K1 launches).

The variants:

  * ``as_is``: the package as it is (K2 from the knots, K3 on the card);
  * ``plain_k2``, ``plain_k3``, ``plain_k2k3``: the plain versions of K2's
    two entries, of K3, or of both, on the same tensors (``ops.residual``'s
    dispatchers replaced by ``*_plain``);
  * ``jacfwd``: the pose Jacobian by ``torch.func.jacfwd`` through the
    retraction and the spline, the formulation the closed form replaced;
    it reaches the path only through the plain version of K2's first entry
    (on the card the entry computes the poses' tangents itself, so
    ``jacfwd`` alone runs as ``as_is`` there); ``jacfwd_plain``: that and
    ``plain_k2k3``;
  * ``parent_layout``: ``blur_rows``' tangent rows [F, N, P, D] handed on
    in the memory order the earlier residual stage left them in ([N, F, P,
    D]), which sets the order of ``affine_correct_jvp``'s moment sums;
  * with ``--parent DIR`` (an earlier checkout, unpacked from ``git
    archive``, loaded as the package ``parent_port``): ``parent_residual``,
    that checkout's ``compute_residuals_windowed`` (its pose Jacobian, warp
    and blur rows, and its own K1); ``parent_assemble``, its ``assemble``
    and ``normal_equations`` (the normal equations; the LM's loop calls the
    latter); ``parent_both``.

Each variant runs on the inputs as they are and then under each seed of
``--seeds``, with every pixel of every input frame scaled by 1 + s 2^-m
(``--move m``, 23 by default: about one float32 unit in the last place),
s a seeded sign in {-1, 1}: how far rounding alone moves the same path.
``as_is`` runs once more at the end, to show that a run repeats.
``--root DIR`` runs the package and ``chip_smoke.py`` of another checkout
instead, where only ``as_is`` applies. Run it as a file from anywhere:

    python3 mba_vo_tpu_torch/experiments/f32_sensitivity.py [--root DIR]
        [--parent DIR] [--device cuda] [--variants as_is,plain_k2,...]
        [--seeds 6] [--move 23] [--frames 16] [--out FILE]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

VARIANTS = ("as_is", "plain_k2", "plain_k3", "plain_k2k3", "jacfwd", "jacfwd_plain",
            "parent_layout")
MOVE = 23      # the inputs' relative move is 2^-MOVE (set by --move)
PARENT_VARIANTS = ("parent_residual", "parent_assemble", "parent_both")
PLAIN = {"plain_k2": ("warp_tangents", "blur_rows"), "plain_k3": ("normal_equations",),
         "plain_k2k3": ("warp_tangents", "blur_rows", "normal_equations")}


def load_parent(root: str):
    """The package of the checkout at ``root``, imported as ``parent_port``
    (its modules import one another relatively, so nothing of it mixes with
    the package under test); returns its ``ops.residual``."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "mba_vo_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "parent_port", os.path.join(pkg, "__init__.py"), submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules["parent_port"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("parent_port.ops.residual")


def virtual_poses_and_tangents_jacfwd(knots, cap_times, exp_times, num_vir, degree):
    """``ops.residual.virtual_poses_and_tangents`` with the tangents from
    ``torch.func.jacfwd`` of the retracted spline's poses at zero
    retraction, laid out [6K, F, V, 7] ([3K translations; 3K rotations])."""
    import torch
    from torch.func import jacfwd

    from mba_vo_tpu_torch.core.spline import (
        spline_pose_at_times, spline_retract, virtual_pose_times,
    )
    from mba_vo_tpu_torch.ops import residual

    pt, pq = residual.sample_virtual_poses(knots, cap_times, exp_times, num_vir, degree)
    K = knots.num_knots
    times = virtual_pose_times(cap_times, exp_times, num_vir).reshape(-1)
    z = torch.zeros((K, 3), dtype=knots.t.dtype, device=knots.t.device)

    def pose7(d_t, d_o):
        p = spline_pose_at_times(spline_retract(knots, d_t, d_o), times, degree)
        return torch.cat([p.t, p.q], dim=-1)

    Jt, Jo = jacfwd(pose7, argnums=(0, 1))(z, z)              # [T, 7, K, 3] each
    T = times.shape[0]
    J = torch.cat([Jt.reshape(T, 7, 3 * K), Jo.reshape(T, 7, 3 * K)], dim=-1)
    return pt, pq, J.permute(2, 0, 1).reshape(6 * K, *pt.shape[:2], 7)


@contextlib.contextmanager
def variant(name: str, parent=None):
    """Swap the module attributes ``name`` asks for (``parent``: the
    earlier checkout's ``ops.residual``); restored on leaving."""
    from mba_vo_tpu_torch.ops import residual

    swaps = []      # (module, attribute, replacement)
    for k in PLAIN.get("plain_k2k3" if name == "jacfwd_plain" else name, ()):
        swaps.append((residual, k, getattr(residual, f"{k}_plain")))
    if name in ("jacfwd", "jacfwd_plain"):
        swaps.append((residual, "virtual_poses_and_tangents",
                      virtual_poses_and_tangents_jacfwd))
    if name == "parent_layout":
        rows = residual.blur_rows

        def blur_rows(*args):
            r, J = rows(*args)
            return r, J.permute(1, 0, 2, 3).contiguous().permute(1, 0, 2, 3)
        swaps.append((residual, "blur_rows", blur_rows))
    if name in ("parent_residual", "parent_both"):
        swaps.append((residual, "compute_residuals_windowed",
                      parent.compute_residuals_windowed))
    if name in ("parent_assemble", "parent_both"):
        # evaluate looks assemble up in residual; the LM's loop calls
        # residual.normal_equations and scales its sums in its own stages
        swaps += [(residual, "assemble", parent.assemble),
                  (residual, "normal_equations", parent.normal_equations)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    for m, k, fn in swaps:
        setattr(m, k, fn)
    try:
        yield
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)


def _scaled(x, seed: int):
    """x (a tensor or an array) times 1 + s 2^-MOVE, s a seeded sign a pixel."""
    import torch

    sign = np.where(np.random.default_rng(seed).random(tuple(x.shape)) < 0.5, -1.0, 1.0)
    if torch.is_tensor(x):
        return x * (1.0 + torch.as_tensor(sign, dtype=x.dtype, device=x.device) * 2.0 ** -MOVE)
    return x * (1.0 + sign * 2.0 ** -MOVE)


@contextlib.contextmanager
def scaled_frames(seed):
    """With a seed, every frame ``scene3d.synthesize_blurred_image_scene``
    makes is scaled by :func:`_scaled`; without, nothing changes."""
    from mba_vo_tpu_torch.data import scene3d

    if seed is None:
        yield
        return
    original = scene3d.synthesize_blurred_image_scene
    calls = [0]

    def synth(*args, **kwargs):
        calls[0] += 1
        return _scaled(original(*args, **kwargs), seed * 1000 + calls[0])

    scene3d.synthesize_blurred_image_scene = synth
    try:
        yield
    finally:
        scene3d.synthesize_blurred_image_scene = original


def run(smoke, device, name, img, traj, frames, seed=None, parent=None):
    """One variant through 5a and 9d, on the inputs moved by ``seed`` (None:
    as they are); returns the JSON-able result. K1's launches count the
    earlier checkout's K1 too where its residual runs."""
    from mba_vo_tpu_torch.ops import cuda_sampling as cs

    counters = [cs] + ([sys.modules["parent_port.ops.cuda_sampling"]]
                       if "parent_port.ops.cuda_sampling" in sys.modules else [])

    def k1_launches():
        return sum(c.LAUNCHES for c in counters)

    if seed is not None:
        frames = [(cap, _scaled(blur, seed * 1000 + i)) for i, (cap, blur) in enumerate(frames)]
    with variant(name, parent):
        for c in counters:
            c.LAUNCHES = 0
        poses, seconds, iters = smoke.run_tracker(smoke.bench_config("float32"), device, img,
                                                  frames)
        k1_5a = k1_launches()
        others = k1_5a - cs.LAUNCHES           # the earlier checkout's, which ladder keeps
        with scaled_frames(seed):
            rungs, k1_9d = smoke.ladder(128, 160, 120.0, "float32", cs, device=device)
        k1_9d += k1_launches() - cs.LAUNCHES - others
    return {"variant": name, "seed": seed, "move": MOVE,
            "5a": {"ate_m": smoke.ate(poses, traj, frames), "k1_launches": k1_5a,
                   "lm_iterations": iters, "seconds": sum(seconds)},
            "9d": {"ate_m": rungs, "k1_launches": k1_9d}}


def main(argv=None) -> int:
    global MOVE
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                   "..", ".."),
                    help="checkout whose package and chip_smoke.py run")
    ap.add_argument("--parent", default=None,
                    help="earlier checkout whose residual and assemble the parent_* variants run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--seeds", type=int, default=6, help="ulp<seed> runs, seeds 1..N")
    ap.add_argument("--move", type=int, default=MOVE,
                    help="the seeded runs move each pixel by a relative 2^-MOVE")
    ap.add_argument("--frames", type=int, default=None, help="5a frames (default 16)")
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args(argv)
    MOVE = args.move
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke as smoke

    if args.device == "cuda" and not torch.cuda.is_available():
        print("f32_sensitivity: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = args.frames or smoke.LONG_FRAMES
    img, traj, frames = smoke.make_scenario(args.device, n)
    names = [v for v in args.variants.split(",") if v]
    if args.parent:
        names += PARENT_VARIANTS
    unknown = set(names) - set(VARIANTS) - (set(PARENT_VARIANTS) if args.parent else set())
    if unknown:
        ap.error(f"unknown variants {sorted(unknown)}")
    parent = load_parent(args.parent) if args.parent else None
    runs = [(v, seed) for v in names for seed in [None] + list(range(1, args.seeds + 1))]
    runs.append(("as_is", None))
    sink = open(args.out, "w") if args.out else None
    try:
        if args.device == "cuda":
            from mba_vo_tpu_torch.experiments.kernel_variants import card_line
            print(json.dumps({"root": os.path.abspath(args.root), "card": card_line(),
                              "torch": torch.__version__}), flush=True)
        for name, seed in runs:
            line = json.dumps(run(smoke, args.device, name, img, traj, frames, seed, parent))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
