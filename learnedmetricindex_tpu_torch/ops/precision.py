"""Full-f32 matmuls for the exact stages, scoped to the call.

The rerank, ``exact_knn``, ``restricted_knn``, k-means and the scan's
plain version are exact-f32 contracts (the JAX package passes
``precision=HIGHEST`` at each of those calls); TF32 keeps only ~3
decimal digits.  :func:`full_f32` turns TF32 off for the matmuls inside
it and puts the caller's settings back afterwards, also after an
exception, so importing or calling the port never changes them.

PyTorch keeps two records of the setting: the process-wide one
(``torch.set_float32_matmul_precision``) and one per backend
(``torch.backends.<backend>.matmul.fp32_precision``), and refuses to
read the first when the two disagree.  Both are saved; where the first
cannot be read, only the per-backend one is set.
"""

from __future__ import annotations

import contextlib

import torch

# the per-backend records that torch.set_float32_matmul_precision writes
_MATMUL_BACKENDS = (torch.backends.cuda.matmul, torch.backends.mkldnn.matmul)


@contextlib.contextmanager
def full_f32():
    """Full-f32 (IEEE) matmuls inside; the caller's settings restored
    on the way out.  Usable as a decorator: ``@full_f32()``."""
    saved = [b.fp32_precision for b in _MATMUL_BACKENDS]
    try:
        legacy = torch.get_float32_matmul_precision()
    except RuntimeError:  # the per-backend records disagree with it: leave it be
        legacy = None
    if legacy is not None:
        torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    try:
        yield
    finally:
        if legacy is not None:
            torch.set_float32_matmul_precision(legacy)
        for backend, value in zip(_MATMUL_BACKENDS, saved):
            backend.fp32_precision = value
