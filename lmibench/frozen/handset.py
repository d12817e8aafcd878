"""The hand-set MLP-4 index, frozen.

Copied from ``chip_smoke.py::flagship_index`` and ``make_corpus`` at
commit b3ffd3826c26c05cb00d092b6ec25ccd26c9f8e8.  The MLP-4 (d -> hidden
-> n_buckets) encodes the nearest-centroid partition exactly: hidden
units j and n_buckets + j are relu(+c_j.x) and relu(-c_j.x), the second
layer takes their difference to logit j and adds -|c_j|^2 / 2, so the
argmax is the nearest centroid in L2.  The centroids are ``n_buckets``
corpus rows chosen by a CPU generator seeded with the run's seed.  The
widths and the navigation path are those of a trained MLP-4; only the
values are set by hand, so set-up takes seconds instead of k-means and
training.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def centroid_rows(n_rows: int, n_buckets: int, seed: int) -> torch.Tensor:
    """The corpus rows (0-based) that serve as centroids."""
    return torch.randperm(n_rows, generator=torch.Generator().manual_seed(seed))[:n_buckets]


def mlp4_params(centroids: torch.Tensor, hidden: int) -> List[Dict[str, np.ndarray]]:
    """``[{"w": (1, d, hidden), "b": (1, hidden)}, {"w": (1, hidden, nb), "b": (1, nb)}]``
    as float32 arrays: the layout of ``index_from_arrays``'s stacked layers."""
    nb, d = centroids.shape
    if hidden < 2 * nb:
        raise ValueError(f"hidden width {hidden} cannot hold 2 x {nb} centroid units")
    c = centroids.float().cpu().numpy()
    w1 = np.zeros((1, d, hidden), np.float32)
    w2 = np.zeros((1, hidden, nb), np.float32)
    w1[0, :, :nb], w1[0, :, nb : 2 * nb] = c.T, -c.T
    w2[0, np.arange(nb), np.arange(nb)] = 1.0
    w2[0, nb + np.arange(nb), np.arange(nb)] = -1.0
    b2 = (-0.5 * (c * c).sum(1))[None, :].astype(np.float32)
    return [{"w": w1, "b": np.zeros((1, hidden), np.float32)}, {"w": w2, "b": b2}]
