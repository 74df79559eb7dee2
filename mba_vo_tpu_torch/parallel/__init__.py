"""Multi-process sharding of the tracker and the backend on
``torch.distributed``.

Counterpart of ``mba_vo_tpu/parallel/``: keypoints shard over the ranks of
a mesh and every normal-equation assembly is an all-reduce over its
process group, one process per shard (``python -m torch.distributed.run``).
"""

from .mesh import make_mesh, pad_keypoints, shard_level_data
from .sharded import optimize_level_sharded
from .sharded_ba import (
    make_ba_mesh,
    run_bundle_adjustment_sharded,
    shard_ba_problem,
)
