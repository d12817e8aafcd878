"""Index layer of the port: navigation, the bucket store and scan path,
the ``LearnedIndex``, its mutation (``DynamicIndex``) and its ``.npz``
serialization."""
