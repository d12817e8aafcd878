"""Index layer of the port: navigation, the bucket store and scan path,
the ``LearnedIndex``, its mutation (``DynamicIndex``) and its ``.npz``
serialization."""

from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore
from learnedmetricindex_tpu_torch.index.builder import LearnedIndexBuilder
from learnedmetricindex_tpu_torch.index.index import LearnedIndex
from learnedmetricindex_tpu_torch.index.mutation import DynamicIndex

__all__ = ["BucketStore", "LearnedIndexBuilder", "LearnedIndex", "DynamicIndex"]
