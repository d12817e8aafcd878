"""Build configuration, shared with the JAX package.

:class:`BuildConfiguration` is the JAX package's class
(``learnedmetricindex_tpu/config.py``) with one change: its model-type
check reads this package's MLP registry.  The original check imports
``learnedmetricindex_tpu.models.mlp``, which imports jax, so
constructing the original class (as ``from_dict`` does on load) would
pull jax into the port.
"""

from __future__ import annotations

from learnedmetricindex_tpu import config as _config


class BuildConfiguration(_config.BuildConfiguration):
    """Per-level build hyperparameters with broadcast and validation
    (see :class:`learnedmetricindex_tpu.config.BuildConfiguration`)."""

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
            if isinstance(arg, (list, tuple)) and len(arg) not in (
                1, len(n_categories)
            ):
                raise ValueError(
                    "per-level arguments must be lists of size 1 or the "
                    "same size as n_categories"
                )

        def as_list(a):
            return list(a) if isinstance(a, (list, tuple)) else [a]

        for algo in as_list(clustering_algorithms):
            if algo not in _config.SUPPORTED_CLUSTERINGS:
                raise ValueError(f"Unknown clustering algorithm: {algo}")
        for m in as_list(model_types):
            if m not in MLP_REGISTRY:
                raise ValueError(
                    f"Unknown model type: {m} (supported: "
                    f"{sorted(MLP_REGISTRY)})"
                )
