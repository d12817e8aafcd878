"""Index save / load (counterpart of
``learnedmetricindex_tpu/index/serialization.py``).

The same ``.npz`` format, read and written with numpy alone: stacked
model parameters per level, class masks, leaf validity, the build
configuration (JSON) and optionally ``data_prediction``.  An index saved
by either package loads in the other.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from learnedmetricindex_tpu_torch.config import BuildConfiguration
from learnedmetricindex_tpu_torch.index.index import (
    LearnedIndex,
    LevelModels,
    resolve_device,
)
from learnedmetricindex_tpu_torch.index.navigation import TreeLayout
from learnedmetricindex_tpu_torch.models.mlp import StackedMLP

FORMAT_VERSION = 1


def save_index(index: LearnedIndex, path: str, data_prediction: Optional[np.ndarray] = None) -> None:
    params = [lv.mlp.to_numpy() for lv in index.levels]
    arrays = {
        "__meta__": np.frombuffer(
            json.dumps(
                {
                    "format_version": FORMAT_VERSION,
                    "config": index.config.to_dict(),
                    "n_levels": index.n_levels,
                    "model_types": [lv.model_type for lv in index.levels],
                    "n_layers": [len(p) for p in params],
                }
            ).encode(),
            dtype=np.uint8,
        ),
        "leaf_valid": index.leaf_valid,
    }
    if data_prediction is not None:
        arrays["data_prediction"] = np.asarray(data_prediction)
    for li, (level, layers) in enumerate(zip(index.levels, params)):
        arrays[f"level{li}_class_mask"] = level.class_mask.cpu().numpy()
        for lj, layer in enumerate(layers):
            arrays[f"level{li}_layer{lj}_w"] = layer["w"]
            arrays[f"level{li}_layer{lj}_b"] = layer["b"]
    # through an open handle: savez would append ".npz" to a bare path
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def index_from_arrays(
    config: Union[BuildConfiguration, dict],
    level_params: Sequence[Sequence[Dict[str, np.ndarray]]],
    class_masks: Sequence[np.ndarray],
    model_types: Sequence[str],
    leaf_valid: np.ndarray,
    device,
) -> LearnedIndex:
    """Build the port's index from numpy arrays: per level, the stacked
    layers ``[{"w": (M, in, out), "b": (M, out)}, ...]``, the (M, C)
    class mask and the model type."""
    device = resolve_device(device)
    if isinstance(config, dict):
        config = BuildConfiguration.from_dict(config)
    levels: List[LevelModels] = [
        LevelModels(
            mlp=StackedMLP.from_numpy(params, device),
            class_mask=torch.as_tensor(np.asarray(mask, bool), device=device),
            model_type=mt,
        )
        for params, mask, mt in zip(level_params, class_masks, model_types)
    ]
    return LearnedIndex(
        levels=levels,
        layout=TreeLayout.create(config.n_categories),
        config=config,
        leaf_valid=leaf_valid,
        device=device,
    )


def load_index(path: str, device) -> Tuple[LearnedIndex, Optional[np.ndarray]]:
    """``(index on device, data_prediction or None)`` from a ``.npz``
    written by either package's ``save_index``."""
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(bytes(f["__meta__"].tobytes()).decode())
        if meta["format_version"] != FORMAT_VERSION:
            raise ValueError(
                f"{path}: format version {meta['format_version']}, expected {FORMAT_VERSION}"
            )
        n_levels = meta["n_levels"]
        level_params = [
            [
                {"w": f[f"level{li}_layer{lj}_w"], "b": f[f"level{li}_layer{lj}_b"]}
                for lj in range(meta["n_layers"][li])
            ]
            for li in range(n_levels)
        ]
        masks = [f[f"level{li}_class_mask"] for li in range(n_levels)]
        leaf_valid = f["leaf_valid"]
        data_prediction = np.asarray(f["data_prediction"]) if "data_prediction" in f else None
    index = index_from_arrays(
        meta["config"], level_params, masks, meta["model_types"], leaf_valid, device
    )
    return index, data_prediction
