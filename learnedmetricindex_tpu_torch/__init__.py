"""Learned Metric Index, PyTorch + CUDA port (build and search).

The same index as :mod:`learnedmetricindex_tpu`, built and served from
PyTorch on an NVIDIA GPU.  ``LearnedIndexBuilder`` clusters each tree
node with k-means and trains the stacked node MLPs to imitate it;
``LearnedIndex.search`` navigates the tree (best-first or joint), scans
the visited buckets with a hand-written CUDA kernel
(``csrc/scan_pairs.cu``), merges, reranks the shortlist in exact f32 and
resolves the 1-based ids.  ``LMI_GATHER_MODE=kernel`` moves the search's
row gathers onto a second hand kernel (``csrc/gather_rows.cu``).  An
index saved by either package (``save_index``, ``.npz``) loads in the
other.

Devices are explicit: every entry point that creates tensors takes a
``device`` and nothing picks one.  Asking for ``cuda`` on a machine
without a usable GPU raises.  CPU tensors run the plain PyTorch version
of each kernel; CUDA tensors always run the kernel.

This package imports ``torch`` and never ``jax``.
"""

from __future__ import annotations

import torch

# Full-f32 matmuls everywhere: the rerank and precision="highest" are
# exact-f32 contracts, and TF32 keeps only ~3 decimal digits.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from learnedmetricindex_tpu_torch.config import BuildConfiguration  # noqa: E402
from learnedmetricindex_tpu_torch.index.builder import LearnedIndexBuilder  # noqa: E402
from learnedmetricindex_tpu_torch.index.index import LearnedIndex  # noqa: E402
from learnedmetricindex_tpu_torch.index.serialization import (  # noqa: E402
    load_index,
    save_index,
)

__version__ = "0.1.0"

__all__ = [
    "BuildConfiguration",
    "LearnedIndex",
    "LearnedIndexBuilder",
    "load_index",
    "save_index",
    "__version__",
]
