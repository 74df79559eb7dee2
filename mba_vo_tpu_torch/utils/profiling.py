"""Profiling hooks: wall time per named stage, and torch.profiler traces.

Counterpart of ``mba_vo_tpu/utils/profiling.py``. A stage ends with a
synchronisation of the CUDA devices its ``sync_on`` tensors live on (none
for CPU tensors), so its time covers the device work it queued.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _cuda_devices(obj, out: set) -> set:
    """The CUDA devices of every tensor in a nest of tuples, lists and
    dicts."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            out.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, out)
    return out


class StageTimer:
    """Accumulates wall time per named stage."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        """Time the body; at its end synchronise the CUDA devices of the
        tensors in ``sync_on`` (read then, so a list the body fills counts)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(sync_on, set()):
                torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean_ms(self, name: str) -> float:
        return 1e3 * self.totals[name] / max(self.counts[name], 1)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            n = self.counts[name]
            tot = self.totals[name]
            lines.append(f"{name:32s} total {tot * 1e3:9.2f} ms  "
                         f"calls {n:5d}  mean {tot / n * 1e3:8.3f} ms")
        return "\n".join(lines)


# how long profile_trace keeps its window open before and after the body
PAD_S = 0.05


def _synchronize_all() -> None:
    for dev in range(torch.cuda.device_count()):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """torch.profiler over the body (CPU, and CUDA where available); the
    chrome trace goes to ``log_dir/trace.json``. Yields the profiler.

    The profiler keeps a device record only where it falls inside its
    window on the host's clock. So with CUDA every device is synchronised
    before the window opens (no earlier work in flight) and again inside it
    after the body (the body's kernels end before it closes), and the
    window stays open PAD_S seconds on each side of the body, so that an
    offset between the device's clock and the host's does not push a short
    body's kernels out of it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
        _synchronize_all()
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        if cuda:
            time.sleep(PAD_S)
        yield prof
        if cuda:
            _synchronize_all()
            time.sleep(PAD_S)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
