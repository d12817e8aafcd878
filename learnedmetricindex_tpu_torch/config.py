"""Build configuration (counterpart of ``learnedmetricindex_tpu/config.py``).

The same configuration surface as the JAX package: per-level
hyperparameters (clustering algorithm, epochs, model type, learning
rate, number of categories) with scalar→list broadcast and validation,
materializing ``level_configurations`` and ``n_levels``, plus ``seed``,
``batch_size``, ``chunk_size``, ``dtype`` and ``update_rule``.
``to_dict``/``from_dict`` use the JAX package's keys, so a saved
``.npz`` loads in either package.

The port keeps its own copy: the JAX package's check of model types
imports its jax MLP registry, and this one reads the port's.  Every
invalid argument raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Sequence, Union

SUPPORTED_CLUSTERINGS = ("kmeans", "faiss_kmeans", "scikit_kmeans")
# "faiss_kmeans"/"scikit_kmeans" are accepted for CLI compatibility with
# the reference; all three run the port's Lloyd's k-means (ops/kmeans.py).
UPDATE_RULES = ("minibatch", "reference")
CLASS_WEIGHTS = (None, "balanced")


@dataclass(frozen=True)
class ModelParameters:
    """Per-level model hyperparameters."""

    clustering_algorithm: str
    model_type: str
    epochs: int
    lr: float
    n_categories: int
    # None = unweighted cross-entropy; "balanced" = inverse-frequency
    # per-class weights computed per node at build time
    class_weight: Optional[str] = None

    def __iter__(self):
        return iter(dataclasses.astuple(self))


def _expand(arg: Union[List[Any], Any], n_levels: int) -> List[Any]:
    """Broadcast a scalar or singleton list to ``n_levels`` entries."""
    if isinstance(arg, (list, tuple)):
        if len(arg) == 1:
            return [arg[0]] * n_levels
        return list(arg)
    return [arg] * n_levels


class BuildConfiguration:
    """Per-level build hyperparameters with broadcast and validation."""

    def __init__(
        self,
        clustering_algorithms: Union[Sequence[str], str],
        epochs: Union[Sequence[int], int],
        model_types: Union[Sequence[str], str],
        lrs: Union[Sequence[float], float],
        n_categories: Sequence[int],
        *,
        class_weights: Union[Sequence[Optional[str]], Optional[str]] = None,
        seed: int = 2023,
        batch_size: int = 256,
        chunk_size: int = 1024,
        dtype: str = "float32",
        update_rule: str = "minibatch",
    ):
        if update_rule not in UPDATE_RULES:
            raise ValueError(f"Unknown update_rule: {update_rule!r} (one of {UPDATE_RULES})")
        n_categories = list(n_categories)
        self._validate(clustering_algorithms, epochs, model_types, lrs, n_categories)

        n_levels = len(n_categories)
        self.clustering_algorithms: List[str] = _expand(clustering_algorithms, n_levels)
        self.epochs: List[int] = _expand(epochs, n_levels)
        self.model_types: List[str] = _expand(model_types, n_levels)
        self.lrs: List[float] = _expand(lrs, n_levels)
        self.class_weights: List[Optional[str]] = _expand(class_weights, n_levels)
        for w in self.class_weights:
            if w not in CLASS_WEIGHTS:
                raise ValueError(f"Unknown class_weight mode: {w!r} (None or 'balanced')")
        self.n_categories: List[int] = n_categories

        self.seed = int(seed)
        self.batch_size = int(batch_size)
        self.chunk_size = int(chunk_size)
        self.dtype = dtype
        self.update_rule = update_rule

        self.level_configurations: List[ModelParameters] = [
            ModelParameters(
                clustering_algorithm=self.clustering_algorithms[i],
                model_type=self.model_types[i],
                epochs=self.epochs[i],
                lr=self.lrs[i],
                n_categories=self.n_categories[i],
                class_weight=self.class_weights[i],
            )
            for i in range(n_levels)
        ]
        self.n_levels = n_levels

    @staticmethod
    def _validate(clustering_algorithms, epochs, model_types, lrs, n_categories):
        from learnedmetricindex_tpu_torch.models.mlp import MLP_REGISTRY

        if not n_categories:
            raise ValueError("n_categories must specify at least one level")
        if not all(isinstance(c, int) and c > 0 for c in n_categories):
            raise ValueError("n_categories must be positive integers")
        per_level = [clustering_algorithms, epochs, model_types, lrs]
        are_lists = all(isinstance(a, (list, tuple)) for a in per_level)
        are_scalars = (
            isinstance(clustering_algorithms, str)
            and isinstance(epochs, int)
            and isinstance(model_types, str)
            and isinstance(lrs, float)
        )
        if not (are_lists or are_scalars):
            raise ValueError(
                "clustering_algorithms, epochs, model_types, and lrs must "
                "all be lists or all be single values"
            )
        for arg in per_level:
            if isinstance(arg, (list, tuple)) and len(arg) not in (1, len(n_categories)):
                raise ValueError(
                    "per-level arguments must be lists of size 1 or the "
                    "same size as n_categories"
                )

        def as_list(a):
            return list(a) if isinstance(a, (list, tuple)) else [a]

        for algo in as_list(clustering_algorithms):
            if algo not in SUPPORTED_CLUSTERINGS:
                raise ValueError(f"Unknown clustering algorithm: {algo}")
        for m in as_list(model_types):
            if m not in MLP_REGISTRY:
                raise ValueError(f"Unknown model type: {m} (supported: {sorted(MLP_REGISTRY)})")

    def to_dict(self) -> dict:
        return {
            "clustering_algorithms": self.clustering_algorithms,
            "epochs": self.epochs,
            "model_types": self.model_types,
            "lrs": self.lrs,
            "n_categories": self.n_categories,
            "class_weights": self.class_weights,
            "seed": self.seed,
            "batch_size": self.batch_size,
            "chunk_size": self.chunk_size,
            "dtype": self.dtype,
            "update_rule": self.update_rule,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BuildConfiguration":
        return cls(
            d["clustering_algorithms"],
            d["epochs"],
            d["model_types"],
            d["lrs"],
            d["n_categories"],
            class_weights=d.get("class_weights"),
            seed=d.get("seed", 2023),
            batch_size=d.get("batch_size", 256),
            chunk_size=d.get("chunk_size", 1024),
            dtype=d.get("dtype", "float32"),
            update_rule=d.get("update_rule", "minibatch"),
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"BuildConfiguration({self.to_dict()})"
