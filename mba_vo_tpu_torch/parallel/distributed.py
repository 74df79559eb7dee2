"""Multi-process plumbing: ``torch.distributed`` from the launcher's
environment, and (host, device) pod meshes.

Counterpart of ``mba_vo_tpu/parallel/distributed.py``. The reference
initialises ``jax.distributed`` once per host and shards over a 2-D
(host, device) mesh; here every shard is a process of its own, launched by
``python -m torch.distributed.run`` (one process per GPU, or several
sharing one), and a pod mesh is the same process group with the
reference's axis names and shape. Its reductions run over every rank: the
reference's psum over the full (host, device) axis tuple.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import KP_AXIS, Mesh, _mesh, visible_ranks

HOST_AXIS = "host"

# a rank that takes another branch than its peers fails its next collective
# after this long instead of hanging the run
TIMEOUT = datetime.timedelta(seconds=120)

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def local_device() -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the visible cards,
    so ranks may share one), or the CPU without a card."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize_from_env() -> bool:
    """Initialise the default process group from the launcher's environment
    (``torch.distributed.run`` sets MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK and LOCAL_RANK); returns True when a multi-process group exists
    afterwards.

    A no-op that returns False when the variables are absent. The backend
    is NCCL when every local rank has a card of its own and gloo when ranks
    share a card (NCCL refuses two ranks on one GPU) or there is none;
    tensors stay on the rank's device either way. Rank 0 prints the choice.
    """
    if dist.is_initialized():
        return True
    if any(k not in os.environ for k in _ENV):
        return False
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    backend = "nccl" if cards >= local_world else "gloo"
    device = local_device()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    if dist.get_rank() == 0:
        print(f"torch.distributed: {dist.get_world_size()} ranks, backend {backend} "
              f"({cards} cards for {local_world} local ranks), rank 0 on {device}",
              flush=True)
    return True


def make_pod_mesh(
    n_hosts: Optional[int] = None,
    devices_per_host: Optional[int] = None,
    axes: Tuple[str, str] = (HOST_AXIS, KP_AXIS),
) -> Mesh:
    """(host, device) mesh over the first n_hosts x devices_per_host ranks,
    host-major (rank = host * devices_per_host + device).

    Defaults read the launch: LOCAL_WORLD_SIZE ranks a host, and as many
    hosts as fill the default group. Explicit factors fold the ranks of one
    machine into a pod, e.g. (2, 2) on 4 ranks."""
    world = visible_ranks()
    if devices_per_host is None:
        devices_per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_hosts is None:
        n_hosts = max(1, world // devices_per_host)
    return _mesh(n_hosts * devices_per_host, tuple(axes), (n_hosts, devices_per_host))


def pod_axis_names(mesh: Mesh) -> Tuple[str, ...]:
    """The axis-name tuple a fully global reduction runs over."""
    return tuple(mesh.axis_names)
