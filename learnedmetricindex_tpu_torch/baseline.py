"""Brute-force baseline index (counterpart of
``learnedmetricindex_tpu/baseline.py``).

The reference ``Baseline``'s API: ``build()`` does nothing, ``search``
is exact cosine kNN returning 1-based ids, here
``ops/knn.py::exact_knn`` on ``device`` in full f32 (tiled matmuls and a
tie-exact top-k).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from learnedmetricindex_tpu_torch.data import normalize
from learnedmetricindex_tpu_torch.index.index import resolve_device
from learnedmetricindex_tpu_torch.ops.knn import exact_knn
from learnedmetricindex_tpu_torch.utils.logging import Logger


class Baseline(Logger):
    def __init__(self, *, device):
        self.device = resolve_device(device)
        # (data, its normalized f32 rows on the device): repeat searches
        # of one corpus (a visit-count sweep) normalize and upload it once
        self._norm_cache = None

    def build(self, data) -> float:
        s = time.perf_counter()
        self.logger.info("No build step for the brute-force baseline.")
        return time.perf_counter() - s

    def _normalized(self, data) -> torch.Tensor:
        """Identity-keyed cache: holds both ``data`` and its normalized copy
        on the device for the Baseline's lifetime, and assumes the caller
        does not change ``data`` in place between searches (that would
        serve stale neighbors: pass a fresh array, or a fresh
        ``Baseline``, after changing it)."""
        if self._norm_cache is not None and self._norm_cache[0] is data:
            return self._norm_cache[1]
        normed = torch.as_tensor(normalize(np.asarray(data)), device=self.device)
        self._norm_cache = (data, normed)
        return normed

    def search(self, queries, data, k: int = 10):
        """Exact cosine kNN: ``(dists (Q, k) f32, nns (Q, k) uint32
        1-based, seconds)``."""
        s = time.perf_counter()
        dists, nns = exact_knn(
            self._normalized(data),
            normalize(np.asarray(queries)),
            k=k,
            metric="cosine",
        )
        return dists, nns, time.perf_counter() - s
