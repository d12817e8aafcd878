"""Learned Metric Index, PyTorch + CUDA port (search path).

The same index as :mod:`learnedmetricindex_tpu`, served from PyTorch on
an NVIDIA GPU: navigation through the stacked MLP tree, the bucket scan
as one hand-written CUDA kernel (``csrc/scan_pairs.cu``), a dense merge,
an exact f32 rerank of the shortlist and the 1-based id resolve.  An
index built and saved by the JAX package (``save_index``, ``.npz``)
loads here unchanged.

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
from learnedmetricindex_tpu_torch.index.index import LearnedIndex  # noqa: E402
from learnedmetricindex_tpu_torch.index.serialization import (  # noqa: E402
    load_index,
    save_index,
)

__version__ = "0.1.0"

__all__ = [
    "BuildConfiguration",
    "LearnedIndex",
    "load_index",
    "save_index",
    "__version__",
]
