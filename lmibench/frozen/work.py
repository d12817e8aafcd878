"""The bucket scan's least time on the card, counted from the inputs.

The arithmetic follows ``chip_smoke.py::scan_work`` and the peaks at its
top (commit b3ffd3826c26c05cb00d092b6ec25ccd26c9f8e8), with one change:
everything is counted from what a search is handed (its visit sets,
the bucket sizes of the corpus, the store type the configuration
states), never from the program's plan or store, so a change to the
plan cannot change the count.

* multiply-adds: each query with each row of each bucket it visits;
* operations: 2 a multiply-add at the peak of the scan mode's type.  An
  exact f32 product runs as bf16 passes on the tensor cores: three over
  an int8 store (its rows are exact in bf16), six over an f32 store;
* bytes: each bucket that some query visits, its rows (and row scales)
  read once; the queries read once as f32; one list of ``k_scan``
  distances and ids (4 + 4 bytes) per (query, visited bucket) written
  once.

The bound is the larger of operations over the peak and bytes over the
memory rate.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

#: NVIDIA H100 SXM, published dense peaks at 700 W (operations a second)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
#: search precision -> the type the scan multiplies in
SCAN_MODE = {"default": "bf16", "highest": "f32", "int8": "int8"}
#: bytes a stored row takes beyond its d values: the int8 store's f32 row scale
ROW_BYTES = {"int8": lambda d: d + 4, "float32": lambda d: 4 * d}


def scan_work(visits: np.ndarray, sizes: np.ndarray, d: int, store: str, precision: str,
              k_scan: int) -> Dict[str, float]:
    """``visits``: (Q, V) bucket ids, -1 for an unused visit; ``sizes``:
    rows a bucket.  Returns multiply-adds, operations, bytes and the
    bound in seconds, with which of the two sets it."""
    visits = np.asarray(visits)
    sizes = np.asarray(sizes, np.int64)
    q = visits.shape[0]
    # a query's distinct visited buckets that hold rows
    v = np.where(visits >= 0, visits, -1)
    v = np.sort(v, axis=1)
    distinct = (v >= 0) & np.concatenate([np.ones((q, 1), bool), v[:, 1:] != v[:, :-1]], 1)
    vis = np.where(distinct, v, 0)
    rows = np.where(distinct, sizes[vis], 0)
    macs = float(rows.sum()) * d
    mode = SCAN_MODE[precision]
    if mode == "f32":
        ops, peak = 2.0 * macs * (6 if store == "float32" else 3), PEAK_OPS["bf16"]
    else:
        ops, peak = 2.0 * macs, PEAK_OPS[mode]
    buckets = np.unique(v[distinct])
    lists = int((distinct & (rows > 0)).sum())
    nbytes = (float(sizes[buckets].sum()) * ROW_BYTES[store](d) + q * d * 4.0
              + lists * k_scan * 8.0)
    t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
    return {"macs": macs, "ops": ops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
