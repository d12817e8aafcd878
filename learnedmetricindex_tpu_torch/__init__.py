"""Learned Metric Index, PyTorch + CUDA port (build, search, mutation,
serving, the experiment driver).

The same index as :mod:`learnedmetricindex_tpu`, built and served from
PyTorch on an NVIDIA GPU.  ``LearnedIndexBuilder`` clusters each tree
node with k-means and trains the stacked node MLPs to imitate it;
``LearnedIndex.search`` navigates the tree (best-first or joint), scans
the visited buckets with a hand-written CUDA kernel
(``csrc/scan_pairs.cu``), merges, reranks the shortlist in exact f32 and
resolves the 1-based ids.  ``LMI_GATHER_MODE=kernel`` moves the merge's
candidate gather onto a second hand kernel (``csrc/gather_rows.cu``).
An index saved by either package (``save_index``, ``.npz``) loads in
the other.  ``DynamicIndex`` takes inserts, deletes and compactions on a
built index (``save``/``load`` checkpoints cross between the packages
too), and ``serve.SearchServer`` micro-batches concurrent requests over
it, with a JSON-over-HTTP front end (``python -m
learnedmetricindex_tpu_torch.serve``).  The experiment driver, ``python
-m learnedmetricindex_tpu_torch.cli``, builds an index over SISAP'23 data
(``data.py``) or seeded blobs, sweeps visit counts and writes SISAP
result files (``eval.py``, which also scores them); ``Baseline`` is
exact kNN for the ground truth, ``NeuralNetwork`` the reference's
one-model API and ``utils/`` the logging and trace helpers.

A tensor corpus is searched through a *virtual* store, the id grid over
the unmoved tensor (``LearnedIndex.get_bucket_store``), and
``prepare_packed_store`` packs a copy; ``parallel`` shards a store by
bucket over a list of devices (``shard_store``, ``shard_packed_store``,
``sharded_search``; ``LearnedIndex.get_sharded_store``).

Devices are explicit: every entry point that creates tensors takes a
``device`` and nothing picks one.  Asking for ``cuda`` on a machine
without a usable GPU raises.  CPU tensors run the plain PyTorch version
of each kernel; CUDA tensors always run the kernel.

The exact stages (the rerank, ``exact_knn``, k-means) run their matmuls
in full f32 whatever the caller's TF32 settings, which the package
leaves as it found them (``ops/precision.py``).

This package imports ``torch`` and never ``jax``.
"""

from __future__ import annotations

from learnedmetricindex_tpu_torch.baseline import Baseline
from learnedmetricindex_tpu_torch.config import BuildConfiguration, ModelParameters
from learnedmetricindex_tpu_torch.index.builder import LearnedIndexBuilder
from learnedmetricindex_tpu_torch.index.index import LearnedIndex
from learnedmetricindex_tpu_torch.index.mutation import DynamicIndex
from learnedmetricindex_tpu_torch.index.serialization import (
    load_index,
    save_index,
)
from learnedmetricindex_tpu_torch.models.train import NeuralNetwork
from learnedmetricindex_tpu_torch.parallel import (
    ShardedStore,
    create_mesh,
    shard_packed_store,
    shard_store,
    sharded_search,
)

__version__ = "0.1.0"

__all__ = [
    "Baseline",
    "BuildConfiguration",
    "DynamicIndex",
    "LearnedIndex",
    "LearnedIndexBuilder",
    "ModelParameters",
    "NeuralNetwork",
    "ShardedStore",
    "create_mesh",
    "load_index",
    "save_index",
    "shard_packed_store",
    "shard_store",
    "sharded_search",
    "__version__",
]
