"""Multi-device execution over a list of devices (counterpart of
``learnedmetricindex_tpu/parallel``): ``create_mesh`` lists a machine's
devices (``device_list`` reads ``--shard-devices``), ``sharded_kmeans``
clusters rows split over them, ``shard_store`` / ``shard_packed_store``
build a :class:`ShardedStore`, ``sharded_search`` searches it and
``ShardedDynamicIndex`` mutates it."""

from learnedmetricindex_tpu_torch.parallel.distributed import sharded_kmeans
from learnedmetricindex_tpu_torch.parallel.mesh import create_mesh, data_model_axes, device_list
from learnedmetricindex_tpu_torch.parallel.sharded_index import (
    ShardedStore,
    shard_packed_store,
    shard_store,
    sharded_search,
)


def __getattr__(name):
    # lazy, as in the JAX package: sharded_mutation pulls in the mutation layer
    if name == "ShardedDynamicIndex":
        from learnedmetricindex_tpu_torch.parallel.sharded_mutation import ShardedDynamicIndex

        return ShardedDynamicIndex
    raise AttributeError(name)


__all__ = [
    "ShardedDynamicIndex",
    "ShardedStore",
    "create_mesh",
    "data_model_axes",
    "device_list",
    "shard_packed_store",
    "shard_store",
    "sharded_kmeans",
    "sharded_search",
]
