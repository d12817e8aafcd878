"""Clustering algorithm registry (counterpart of
``learnedmetricindex_tpu/ops/clustering.py``).

A ``ClusteringAlgorithm`` is ``(data, n_clusters, params) →
(clustering_object, labels)``; the reference's names ``kmeans``,
``faiss_kmeans`` and ``scikit_kmeans`` are all aliases of the port's
:func:`~learnedmetricindex_tpu_torch.ops.kmeans.kmeans` with
faiss-equivalent settings.  The clustering object is the centroid
matrix.  ``params`` keys: ``seed`` (or ``random_state``), ``max_iter``,
``max_points_per_centroid``, ``round_sizes``, ``row_scales`` and
``rows`` (cluster only those row indices of ``data``, returning
``len(rows)`` labels).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from learnedmetricindex_tpu_torch.ops.kmeans import kmeans

ClusteringAlgorithm = Callable[[Any, int, Optional[Dict[str, Any]]], Tuple[Any, np.ndarray]]


def _kmeans(data, n_clusters: int, parameters: Optional[Dict[str, Any]] = None):
    if parameters is None:
        parameters = {"seed": 2023}
    return kmeans(
        data,
        n_clusters,
        n_iters=parameters.get("max_iter", 25),
        seed=parameters.get("seed", parameters.get("random_state", 2023)),
        max_points_per_centroid=parameters.get("max_points_per_centroid", 256),
        round_sizes=parameters.get("round_sizes", False),
        row_scales=parameters.get("row_scales"),
        rows=parameters.get("rows"),
    )


algorithms: Dict[str, ClusteringAlgorithm] = {
    "kmeans": _kmeans,
    "faiss_kmeans": _kmeans,
    "scikit_kmeans": _kmeans,
}
