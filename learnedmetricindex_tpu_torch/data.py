"""Dataset I/O and synthetic data.

Host side (numpy), the port's own copy of the JAX package's
``data.py``: the SISAP'23 file layout and download (``prepare``), HDF5
loading (``load_h5``, ``load_dataset``; h5py is imported where a file is
read, so importing this module needs none), row normalization and the
seeded ``synthetic_blobs`` the CLI runs offline on.  The same seed gives
the same bits as the JAX package's functions.

Device side: :class:`BlobGenerator`, the regime of the JAX package's
benchmark corpus (``bench.py``, ``RowGenerator``): unit-norm points
around ``n_clusters`` random unit centers with Gaussian noise of
``noise / √d`` per coordinate.  Its bits differ from the JAX generator's
(different PRNG); the distribution is the same.  Rows come in blocks, so
a corpus far larger than one f32 copy on the device can be produced and
consumed block by block.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

SISAP_URL = "https://sisap-23-challenge.s3.amazonaws.com/SISAP23-Challenge"

#: dataset kind → HDF5 key, as the reference CLI's defaults pair them
KIND_TO_KEY = {
    "pca32v2": "pca32",
    "pca96v2": "pca96",
    "clip768v2": "emb",
    "hammingv2": "hamming",
}


def normalize(x: np.ndarray) -> np.ndarray:
    """Row-wise L2 normalization in f32; all-zero rows stay zero."""
    x = np.asarray(x, dtype=np.float32)
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    norms = np.where(norms == 0.0, 1.0, norms)
    return x / norms


def dataset_urls(kind: str, size: str) -> dict:
    """The SISAP'23 LAION challenge URLs of a kind and size."""
    return {
        "query": f"{SISAP_URL}/public-queries-10k-{kind}.h5",
        "dataset": f"{SISAP_URL}/laion2B-en-{kind}-n={size}.h5",
    }


def prepare(
    kind: str, size: str, data_dir: str = "data", download: bool = True
) -> Tuple[str, str]:
    """Paths of the dataset and query HDF5 files, downloading only what is
    missing.

    Staged files are used as they are: place them at
    ``<data_dir>/<kind>/<size>/dataset.h5`` and ``.../query.h5``.  With
    ``download=False`` a missing file raises ``FileNotFoundError`` naming
    the expected path and its source URL instead of downloading."""
    urls = dataset_urls(kind, size)
    paths = {}
    for version, url in urls.items():
        target = os.path.join(data_dir, kind, size, f"{version}.h5")
        if not os.path.exists(target):
            if not download:
                raise FileNotFoundError(
                    f"{target} is not staged and download=False; stage "
                    f"the file there (source: {url}) to run offline"
                )
            from urllib.request import urlretrieve

            Path(target).parent.mkdir(parents=True, exist_ok=True)
            urlretrieve(url, target)
        if not os.path.exists(target):
            raise FileNotFoundError(f"Failed to download {url}")
        paths[version] = target
    return paths["dataset"], paths["query"]


def load_h5(path: str, key: str) -> np.ndarray:
    """Dataset ``key`` of an HDF5 file as f32 (needs h5py)."""
    import h5py

    with h5py.File(path, "r") as f:
        return np.asarray(f[key], dtype=np.float32)


def load_dataset(
    kind: str,
    size: str,
    data_dir: str = "data",
    key: Optional[str] = None,
    preprocess: bool = True,
    download: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """``(data, queries)`` of a SISAP kind and size, normalized if
    ``preprocess``; ``download=False`` needs the files staged
    (:func:`prepare`)."""
    key = key or KIND_TO_KEY.get(kind, kind)
    dataset_path, query_path = prepare(kind, size, data_dir, download=download)
    data = load_h5(dataset_path, key)
    queries = load_h5(query_path, key)
    if preprocess:
        data, queries = normalize(data), normalize(queries)
    return data, queries


def synthetic_blobs(
    n: int,
    d: int,
    n_queries: int,
    n_clusters: int = 16,
    seed: int = 2023,
    normalized: bool = True,
    cluster_std: float = 0.25,
) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded Gaussian blobs (``cluster_std`` per coordinate around unit
    centers), normalized onto the unit sphere unless ``normalized`` is
    false.  Returns ``(data, queries)``, the queries drawn from the same
    mixture after the data."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)

    def sample(count: int) -> np.ndarray:
        assignment = rng.integers(0, n_clusters, size=count)
        points = centers[assignment] + cluster_std * rng.normal(
            size=(count, d)
        ).astype(np.float32)
        return points.astype(np.float32)

    data, queries = sample(n), sample(n_queries)
    if normalized:
        data, queries = normalize(data), normalize(queries)
    return data, queries


class BlobGenerator:
    """Draws rows of one mixture from a ``torch.Generator`` on ``device``;
    the same seed and the same sequence of calls give the same rows."""

    def __init__(self, n_clusters: int, d: int, seed: int, noise: float, *, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        centers = torch.randn(
            n_clusters, d, generator=self.generator, device=self.device
        )
        self.centers = centers / centers.norm(dim=1, keepdim=True)
        self.scale = noise / d**0.5

    def rows(self, n: int) -> torch.Tensor:
        """(n, d) f32 unit-norm rows."""
        k, d = self.centers.shape
        assign = torch.randint(0, k, (n,), generator=self.generator, device=self.device)
        x = torch.randn(n, d, generator=self.generator, device=self.device)
        x = x.mul_(self.scale).add_(self.centers[assign])
        return x.div_(x.norm(dim=1, keepdim=True))
