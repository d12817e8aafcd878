"""Index layer of the port: navigation, the bucket store and scan path,
the ``LearnedIndex`` and its ``.npz`` serialization."""
