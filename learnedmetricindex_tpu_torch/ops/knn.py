"""Exact brute-force kNN and the recall metric (counterpart of
``learnedmetricindex_tpu/ops/knn.py``): the correctness oracle.

``dist = 1 - <q, x>`` for ``inner_product``/``cosine`` (normalized
vectors), squared L2 for ``l2``; full f32 (TF32 is off, see the package
``__init__``).  Neighbor ids are 1-based ``uint32``; ties go to the
smaller row index.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch.ops.select import smallest_k

METRICS = ("inner_product", "cosine", "l2")


def _dist_tile(queries: torch.Tensor, tile: torch.Tensor, metric: str) -> torch.Tensor:
    sims = queries @ tile.T
    if metric in ("inner_product", "cosine"):
        return 1.0 - sims
    q2 = (queries * queries).sum(1, keepdim=True)
    x2 = (tile * tile).sum(1)[None, :]
    return q2 - 2.0 * sims + x2


def exact_knn(
    data,
    queries,
    k: int = 10,
    metric: str = "inner_product",
    tile_rows: int = 8192,
    row_scales=None,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-nearest neighbors, streamed over ``tile_rows``-row blocks of
    ``data`` (numpy or a tensor; int8 with ``row_scales`` allowed), so
    the corpus never needs an f32 copy on the device.  Runs on
    ``device``, which defaults to the device of ``data`` when it is a
    tensor; host data needs an explicit ``device``.  Returns ``(dists
    (n_q, k) f32, ids (n_q, k) uint32 1-based)``, ascending."""
    if metric not in METRICS:
        raise ValueError(f"Unknown metric: {metric}")
    if device is None:
        if not isinstance(data, torch.Tensor):
            raise ValueError("exact_knn needs a device for host data")
        device = data.device
    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.asarray(queries, np.float32))
    q = queries.to(device=device, dtype=torch.float32)
    n, d = data.shape
    if k < 1 or q.shape[1] != d:
        raise ValueError("exact_knn needs k >= 1 and queries of the data's width")
    best_d = torch.full((q.shape[0], k), torch.inf, device=device)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.int64, device=device)
    for start in range(0, n, tile_rows):
        block = torch.as_tensor(data[start : start + tile_rows], device=device).float()
        if row_scales is not None:
            sc = torch.as_tensor(row_scales[start : start + tile_rows], device=device)
            block = block * sc.float()[:, None]
        dist = _dist_tile(q, block, metric)
        kk = min(k, dist.shape[1])
        vals, pos = smallest_k(dist, kk)
        # running best first: earlier rows win ties, as in a stable merge
        cat_d = torch.cat([best_d, vals], 1)
        cat_i = torch.cat([best_i, pos + start], 1)
        best_d, sel = smallest_k(cat_d, k)
        best_i = torch.gather(cat_i, 1, sel)
    return best_d.cpu().numpy(), (best_i + 1).cpu().numpy().astype(np.uint32)


def recall(nns, gt_nns, k: int = 10) -> float:
    """SISAP recall: mean over queries of ``|top-k ∩ gt-k| / k``; duplicate
    ids within a row count once."""
    nns = np.asarray(nns)[:, :k].astype(np.int64)
    gt = np.asarray(gt_nns)[:, :k].astype(np.int64)
    if nns.shape[0] != gt.shape[0]:
        raise ValueError("recall needs one ground-truth row per result row")
    if nns.shape[0] == 0:
        return 0.0
    hits = 0
    for row, truth in zip(nns, gt):
        hits += len(np.intersect1d(row, truth))
    return hits / (nns.shape[0] * k)


def restricted_knn(
    store, queries: torch.Tensor, bucket_order: torch.Tensor, k: int,
    *, slab_rows: int = 1 << 20,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN of each query over only the buckets it visits (rows of
    ``bucket_order``, -1 = none), in f32 over the dequantized packed
    ``store`` (an ``index.bucket_store.BucketStore``): the ceiling a
    bucket scan must reach.  Returns ``(dists (Q, k) f32, ids (Q, k)
    int32 1-based, 0 = none)`` on the store's device."""
    device = store.device
    q = queries.to(device=device, dtype=torch.float32)
    n_q, nb = q.shape[0], store.n_buckets
    order = bucket_order.to(device).long()
    visited = torch.zeros((n_q, nb + 1), dtype=torch.bool, device=device)
    visited.scatter_(1, torch.where(order >= 0, order, nb), True)
    visited = visited[:, :nb]
    ptr = torch.as_tensor(store.bucket_chunk_start, dtype=torch.int64, device=device)
    scales = store.scales_flat()
    best_d = torch.full((n_q, k), torch.inf, device=device)
    best_s = torch.full((n_q, k), -1, dtype=torch.int64, device=device)
    for s0 in range(0, store.chunk_data.shape[0], slab_rows):
        sc = scales[s0 : s0 + slab_rows]
        x = store.chunk_data[s0 : s0 + slab_rows].float() * sc[:, None]
        slot = torch.arange(s0, s0 + x.shape[0], device=device)
        bucket = torch.searchsorted(ptr, slot // store.chunk, right=True) - 1
        ok = visited[:, bucket] & (sc != 0.0)[None, :]
        dist = torch.where(ok, 1.0 - q @ x.T, torch.inf)
        vals, pos = smallest_k(dist, min(k, dist.shape[1]))
        cat_d = torch.cat([best_d, vals], 1)
        cat_s = torch.cat([best_s, torch.where(torch.isinf(vals), -1, pos + s0)], 1)
        best_d, sel = smallest_k(cat_d, k)
        best_s = torch.gather(cat_s, 1, sel)
    ids_flat = store.chunk_ids.reshape(-1)
    ids = torch.where(best_s >= 0, ids_flat[best_s.clamp_min(0)], 0)
    return best_d, ids
