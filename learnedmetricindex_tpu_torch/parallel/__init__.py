"""Search over a store sharded by bucket over a list of devices
(counterpart of ``learnedmetricindex_tpu/parallel``): ``create_mesh``
lists a machine's devices, ``shard_store`` / ``shard_packed_store``
build a :class:`ShardedStore`, ``sharded_search`` searches it."""

from learnedmetricindex_tpu_torch.parallel.mesh import create_mesh, data_model_axes
from learnedmetricindex_tpu_torch.parallel.sharded_index import (
    ShardedStore,
    shard_packed_store,
    shard_store,
    sharded_search,
)

__all__ = [
    "ShardedStore",
    "create_mesh",
    "data_model_axes",
    "shard_packed_store",
    "shard_store",
    "sharded_search",
]
