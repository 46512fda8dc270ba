"""Multi-device helpers (port of gagan_tpu/parallel/): data parallelism over
``torch.distributed`` ranks (``mesh.py``) and hook composition.  Spatial
(height) sharding of ``parallel/spatial.py`` is the next slice of ROADMAP
item 10: its functions raise."""

from .mesh import (
    Mesh,
    check_replica_consistency,
    create_mesh,
    place_state,
    shard_batch,
    shard_train_step,
    share_rows,
    spawn,
)
from .spatial import merge_hooks

__all__ = [
    "Mesh",
    "check_replica_consistency",
    "create_mesh",
    "merge_hooks",
    "place_state",
    "shard_batch",
    "shard_train_step",
    "share_rows",
    "spawn",
]
