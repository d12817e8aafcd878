"""Result storage and evaluation (counterpart of
``learnedmetricindex_tpu/eval.py``).

* ``store_results`` writes the SISAP'23 challenge result schema: attrs
  ``algo / data / buildtime / querytime / params / size`` and datasets
  ``knns`` (1-based ids) and ``dists``, dtypes as given, so a file
  either package writes reads the same in the other;
* the evaluation: ``recall = mean |top-k ∩ gt-k| / k`` over result files
  or arrays, into ``res.csv`` rows, a recall-vs-time plot, and the
  oracle-navigation ceiling of a partition.

h5py and matplotlib are imported inside the functions that use them, so
importing this module needs neither.
"""

from __future__ import annotations

import csv
import os
from pathlib import Path
from typing import Iterable

import numpy as np

from learnedmetricindex_tpu_torch.ops.knn import recall as _recall


def store_results(
    dst: str,
    algo: str,
    kind: str,
    dists: np.ndarray,
    anns: np.ndarray,
    buildtime: float,
    querytime: float,
    params: str,
    size: str,
) -> None:
    """Write a challenge-format result file (needs h5py)."""
    import h5py

    Path(dst).parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(dst, "w") as f:
        f.attrs["algo"] = algo
        f.attrs["data"] = kind
        f.attrs["buildtime"] = buildtime
        f.attrs["querytime"] = querytime
        f.attrs["size"] = size
        f.attrs["params"] = params
        f.create_dataset("knns", anns.shape, dtype=anns.dtype)[:] = anns
        f.create_dataset("dists", dists.shape, dtype=dists.dtype)[:] = dists


def load_results(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        return (
            np.asarray(f["knns"]),
            np.asarray(f["dists"]),
            dict(f.attrs),
        )


def load_groundtruth(path: str, key: str = "knns") -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f[key])


def evaluate_result_file(
    result_path: str, groundtruth, k: int = 10
) -> dict:
    """Recall of one result file vs groundtruth (array or HDF5 path)."""
    if isinstance(groundtruth, (str, os.PathLike)):
        groundtruth = load_groundtruth(str(groundtruth))
    knns, dists, attrs = load_results(result_path)
    r = _recall(knns, groundtruth, k)
    return {
        "algo": attrs.get("algo", ""),
        "data": attrs.get("data", ""),
        "size": attrs.get("size", ""),
        "params": attrs.get("params", ""),
        "buildtime": float(attrs.get("buildtime", 0.0)),
        "querytime": float(attrs.get("querytime", 0.0)),
        "recall": r,
        "file": str(result_path),
    }


def evaluate_to_csv(
    result_paths: Iterable[str],
    groundtruth,
    csv_path: str = "res.csv",
    k: int = 10,
) -> list:
    """Evaluate many result files into a ``res.csv`` (one row a file,
    the keys of :func:`evaluate_result_file`)."""
    rows = [evaluate_result_file(p, groundtruth, k) for p in result_paths]
    if rows:
        Path(csv_path).parent.mkdir(parents=True, exist_ok=True)
        with open(csv_path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0]))
            writer.writeheader()
            writer.writerows(rows)
    return rows


def plot_results(rows, out_path: str = "result.png"):
    """Recall-vs-query-time scatter of ``rows`` into ``out_path``.
    Requires matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise RuntimeError("plot_results requires matplotlib") from e

    fig, ax = plt.subplots(figsize=(7, 5))
    for row in rows:
        ax.scatter(row["recall"], row["querytime"], label=row["params"][:40])
    ax.set_xlabel("recall@k")
    ax.set_ylabel("query time (s)")
    ax.set_yscale("log")
    ax.grid(True, alpha=0.3)
    if len(rows) <= 12:
        ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def oracle_navigation_recall(bucket_of_gt: np.ndarray, visits) -> dict:
    """Partition-quality ceiling: recall@k when navigation is an ORACLE
    that always visits, for each query, the ``v`` buckets containing the
    most of that query's true top-k neighbors.

    ``bucket_of_gt``: (n_queries, k) — the bucket id of each ground-truth
    neighbor (``bucket_ids[gt - 1]``).  Returns ``{v: recall}`` for each
    ``v`` in ``visits``.

    The gap between this ceiling and the measured search recall at the
    same visit count is pure NAVIGATION loss (the router ranking buckets
    wrong); the gap between this ceiling and 1.0 is pure PARTITION loss
    (the learned partition scattering a query's neighbors over more than
    ``v`` buckets).  Diagnostic for multi-level recall plateaus."""
    bucket_of_gt = np.asarray(bucket_of_gt)
    n_q, k = bucket_of_gt.shape
    visits = sorted(set(int(v) for v in visits))
    # per-query descending bucket-occupancy counts, padded to k groups
    bs = np.sort(bucket_of_gt, axis=1)
    new_group = np.concatenate(
        [np.ones((n_q, 1), bool), bs[:, 1:] != bs[:, :-1]], axis=1
    )
    # rank of each element within its group == position - group start
    group_id = np.cumsum(new_group, axis=1) - 1  # (n_q, k), 0-based
    counts = np.zeros((n_q, k), np.int64)
    np.add.at(counts, (np.arange(n_q)[:, None], group_id), 1)
    counts.sort(axis=1)
    counts = counts[:, ::-1]  # descending group sizes per query
    cum = np.cumsum(counts, axis=1)
    return {
        v: float(cum[:, min(v, k) - 1].mean() / k) for v in visits
    }
