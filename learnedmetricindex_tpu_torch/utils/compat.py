"""Reference-parity utility functions (the port's copy of the JAX
package's ``utils/compat.py``): the cosine-distance helper, the list
serializer, path matching and pickle save, so code written against the
reference's helper surface ports directly."""

from __future__ import annotations

import pickle
from typing import Any, List, Tuple, Union

import numpy as np
import torch

from learnedmetricindex_tpu_torch.data import normalize
from learnedmetricindex_tpu_torch.ops.precision import full_f32


def pairwise_cosine(x, y, *, device) -> np.ndarray:
    """Full cosine-distance matrix ``1 - cos(x_i, y_j)``, one f32 matmul
    of the normalized rows on ``device``.  O(|x|·|y|) memory: meant for
    small inputs, like the reference baseline."""
    xs = torch.as_tensor(normalize(np.asarray(x)), device=device)
    ys = torch.as_tensor(normalize(np.asarray(y)), device=device)
    with full_f32():
        sims = xs @ ys.T
    return (1.0 - sims).cpu().numpy()


def save_as_pickle(filename: str, obj) -> None:
    """Pickle ``obj`` to ``filename`` (prefer ``LearnedIndex.save``: its
    ``.npz`` round-trips between the packages)."""
    with open(filename, "wb") as f:
        pickle.dump(obj, f)


def serialize(lst: List[Any]) -> str:
    """Comma-join a list for artifact file names."""
    return ",".join(map(str, lst))


def filter_path_idxs(
    paths: np.ndarray, path: Union[Tuple, np.ndarray]
) -> np.ndarray:
    """Indexes of the rows of ``paths`` equal to ``path``."""
    return np.where(np.all(np.asarray(paths) == np.asarray(path), axis=1))[0]
