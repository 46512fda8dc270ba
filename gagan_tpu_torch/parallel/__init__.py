"""Multi-device helpers (port of gagan_tpu/parallel/) over
``torch.distributed`` ranks: data parallelism (``mesh.py``: each rank its
share of the batch, gradients averaged over the ranks) and spatial (height)
sharding (``spatial.py``: each rank the whole batch and its row blocks of
the large maps, with halo exchanges), and hook composition."""

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
from .spatial import (
    d_spatial_constraint,
    gather_rows,
    merge_hooks,
    spatial_sharding_hooks,
    spatial_synthesis_fn,
)

__all__ = [
    "Mesh",
    "check_replica_consistency",
    "create_mesh",
    "d_spatial_constraint",
    "gather_rows",
    "merge_hooks",
    "place_state",
    "shard_batch",
    "shard_train_step",
    "share_rows",
    "spatial_sharding_hooks",
    "spatial_synthesis_fn",
    "spawn",
]
