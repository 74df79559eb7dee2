"""Where the tracker's float64 runs on CUDA and on the CPU part.

Tracks the loop benchmark's sequence (``experiments/loop_bench.py``: its
``cli synth`` recipe and ``TRACKER_CONFIG``, tracker-only, one frame a call
as ``cli track --chunk 1`` runs it) with one ``BlurAwareTracker`` on
"cuda" and one on "cpu" in lockstep, from the same decoded files, and
prints per frame the largest difference of the two poses at full
precision (the TUM files print 9 decimals). The first frame whose knots
differ in any bit is tracked once more on the card, from a copy of the
card tracker's state before it, under a dispatch mode that runs every aten
op also on CPU copies of its inputs: the ops whose outputs then differ are
counted by name (``empty`` ops, whose outputs hold whatever memory did, are
not compared); every call of the kernels K1, K2 (``warp_tangents``,
``blur_rows``) and K3 (``normal_equations``), which the mode cannot see
into, is held against its plain version on the CPU, bit for bit.

    python3 -m mba_vo_tpu_torch.experiments.device_parting [--num-frames 60]
        [--out FILE]

Needs a card; ``--device cpu`` runs both sides on the CPU (the rehearsal:
nothing parts).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import copy
import io
import json
import os
import tempfile

import numpy as np


def _compare(a, b) -> bool:
    """Equal bit for bit (NaNs equal), for tensors and anything else."""
    import torch

    if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
        a, b = a.detach().cpu(), b.detach().cpu()
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.is_floating_point():
            return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
        return bool(torch.equal(a, b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_compare(x, y) for x, y in zip(a, b))
    return a == b


def op_differences(run, device):
    """Run ``run()`` under a dispatch mode that repeats every aten op taking
    a ``device`` tensor on CPU copies of its inputs. Returns (ops by name,
    ops whose outputs differ by name, the first differing op, the calls of
    each kernel with those that differ from the plain version on the CPU)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode, _disable_current_modes
    from torch.utils._pytree import tree_flatten, tree_map

    from ..ops import cuda_residual, cuda_sampling, residual, window_sampling

    def to_cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, torch.device):
            return torch.device("cpu")
        return x

    total, differ, first = collections.Counter(), collections.Counter(), []

    class CompareOnCpu(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            flat, _ = tree_flatten((args, kwargs, out))
            tensors = [a for a in flat if isinstance(a, torch.Tensor)]
            if (not any(a.device.type == device for a in tensors)
                    or any(a.device.type == "meta" for a in tensors)
                    or func.overloadpacket.__name__.startswith("empty")):
                return out
            try:
                ref = func(*tree_map(to_cpu, args), **tree_map(to_cpu, kwargs))
            except Exception:   # an op with no CPU counterpart for these arguments
                return out
            name = func.overloadpacket.__name__
            total[name] += 1
            if not _compare(out, ref):
                differ[name] += 1
                if not first:
                    first.append(name)
            return out

    # each kernel: (its wrapper's module, the wrapper's name, the plain
    # version, how many leading arguments the plain version takes)
    kernels = {
        "k1": (cuda_sampling, "window_bilinear_cuda", window_sampling.window_bilinear_plain, 3),
        "warp_tangents": (cuda_residual, "warp_tangents_cuda", residual.warp_tangents_plain, 12),
        "blur_rows": (cuda_residual, "blur_rows_cuda", residual.blur_rows_plain, 8),
        "normal_equations": (cuda_residual, "normal_equations_cuda",
                             residual.normal_equations_plain, 5),
    }
    calls = {k: [0, 0] for k in kernels}
    originals = {k: getattr(mod, name) for k, (mod, name, _, _) in kernels.items()}

    def held(kernel):
        _, _, plain, n_args = kernels[kernel]

        def call(*args, **kw):
            with _disable_current_modes():
                out = originals[kernel](*args, **kw)
                ref = plain(*tree_map(to_cpu, tuple(args[:n_args])))
            calls[kernel][0] += 1
            calls[kernel][1] += int(not _compare(out, ref))
            return out
        return call

    for k, (mod, name, _, _) in kernels.items():
        setattr(mod, name, held(k))
    try:
        with CompareOnCpu():
            run()
    finally:
        for k, (mod, name, _, _) in kernels.items():
            setattr(mod, name, originals[k])
    return total, differ, (first[0] if first else None), calls


def run(num_frames=60, height=240, width=320, noise=1.5, device="cuda") -> dict:
    import torch

    from .. import cli
    from ..data import datasets as ds
    from ..tracker.blur_tracker import BlurAwareTracker
    from ..utils.config import tracker_config_from_dict
    from .loop_bench import TRACKER_CONFIG

    with tempfile.TemporaryDirectory(prefix="parting_") as root:
        seq = os.path.join(root, "seq")
        with contextlib.redirect_stdout(io.StringIO()):
            assert cli.main(["synth", "--output", seq, "--num-frames", str(num_frames),
                             "--height", str(height), "--width", str(width),
                             "--num-samples", "7", "--trajectory", "loop", "--texture",
                             "random", "--noise", str(noise), "--device", device]) == 0
        names = sorted(os.listdir(os.path.join(seq, "images")))
        times = {}
        with open(os.path.join(seq, "times.txt")) as f:
            for line in f:
                name, cap, exp = line.split()
                times[name] = (float(cap), float(exp))
        K = np.array([float(x) for x in open(os.path.join(seq, "intrinsics.txt")).read().split(",")])
        frames = [(ds.load_gray_image(os.path.join(seq, "images", n)),
                   ds.load_gray_image(os.path.join(seq, "sharp", n)),
                   np.load(os.path.join(seq, "depths", n[:-4] + ".npy")), *times[n])
                  for n in names]
    cfg = tracker_config_from_dict(TRACKER_CONFIG)
    hw = frames[0][0].shape
    dev = BlurAwareTracker(cfg, K, hw, device=device)
    cpu = BlurAwareTracker(cfg, K, hw, device="cpu")
    per_frame, first = [], None
    for i, (blur, sharp, depth, cap, exp) in enumerate(frames):
        before = copy.deepcopy(dev)
        pd = dev.track_frame(sharp, blur, cap, exp, depth)
        pc = cpu.track_frame(sharp, blur, cap, exp, depth)
        per_frame.append(float((torch.cat([pd.t, pd.q]).cpu()
                                - torch.cat([pc.t, pc.q])).abs().max()))
        same = dev.knots is None or (_compare(dev.knots.t, cpu.knots.t)
                                     and _compare(dev.knots.q, cpu.knots.q))
        if not same and first is None:
            first = i
            total, differ, first_op, calls = op_differences(
                lambda: before.track_frame(sharp, blur, cap, exp, depth), dev.device.type)
    out = dict(device=torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
               num_frames=len(frames), per_frame_max_abs=per_frame,
               first_frame_knots_differ=first)
    if first is not None:
        out.update(ops=sum(total.values()), ops_differ=dict(differ.most_common()),
                   ops_differ_total=sum(differ.values()), first_op_differ=first_op,
                   calls_differ={k: dict(calls=c, differ=d) for k, (c, d) in calls.items()})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-frames", type=int, default=60)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    res = run(num_frames=args.num_frames, device=args.device)
    print("per frame max |pose CUDA - pose CPU|: " + " ".join(
        f"{d:.1e}" for d in res["per_frame_max_abs"]))
    print(json.dumps({k: v for k, v in res.items() if k != "per_frame_max_abs"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
