"""Index save / load (counterpart of
``learnedmetricindex_tpu/index/serialization.py``).

The same ``.npz`` format, read and written with numpy alone: stacked
model parameters per level, class masks, leaf validity, the build
configuration (JSON) and optionally ``data_prediction``.  A mutable
deployment (:class:`~learnedmetricindex_tpu_torch.index.mutation.DynamicIndex`)
saves its packed store beside the models (``kind: "dynamic"``).  An
index or a deployment saved by either package loads in the other.
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


def _index_arrays(index: LearnedIndex, **meta) -> dict:
    """The models' arrays and the ``__meta__`` record (with ``meta``)."""
    params = [lv.mlp.to_numpy() for lv in index.levels]
    arrays = {
        "__meta__": np.frombuffer(
            json.dumps(
                {
                    "format_version": FORMAT_VERSION,
                    **meta,
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
    for li, (level, layers) in enumerate(zip(index.levels, params)):
        arrays[f"level{li}_class_mask"] = level.class_mask.cpu().numpy()
        for lj, layer in enumerate(layers):
            arrays[f"level{li}_layer{lj}_w"] = layer["w"]
            arrays[f"level{li}_layer{lj}_b"] = layer["b"]
    return arrays


def _savez(path: str, arrays: dict) -> None:
    # through an open handle: savez would append ".npz" to a bare path
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def save_index(index: LearnedIndex, path: str, data_prediction: Optional[np.ndarray] = None) -> None:
    arrays = _index_arrays(index)
    if data_prediction is not None:
        arrays["data_prediction"] = np.asarray(data_prediction)
    _savez(path, arrays)


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


# ----------------------------------------------------------------------
# mutable deployments: index + packed store + id allocator
# ----------------------------------------------------------------------
_STORE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def save_dynamic_index(dyn, path: str) -> None:
    """Checkpoint a :class:`~learnedmetricindex_tpu_torch.index.mutation.
    DynamicIndex`: the models, the store's packed arrays (the corpus,
    serve-time inserts included, lives only there) and the next id.
    bf16 rows are saved as f32, which holds them exactly (numpy has no
    bf16)."""
    st = dyn.store
    store_dtype = str(st.chunk_data.dtype).replace("torch.", "")
    data = st.chunk_data.float() if st.chunk_data.dtype == torch.bfloat16 else st.chunk_data
    arrays = _index_arrays(dyn.index, kind="dynamic", store_dtype=store_dtype, chunk=st.chunk,
                           n_buckets=st.n_buckets, next_id=dyn.next_id)
    arrays.update({
        "store_chunk_data": data.cpu().numpy(),
        "store_chunk_ids": st.chunk_ids.cpu().numpy(),
        "store_bucket_chunk_start": st.bucket_chunk_start,
        "store_bucket_sizes": st.bucket_sizes,
        "store_row_slot": st.row_slot.cpu().numpy(),
        "store_bucket_chunk_ptr": st.bucket_chunk_ptr,
        "store_bucket_chunk_list": st.bucket_chunk_list,
        "store_bucket_fill": st.bucket_fill,
    })
    if st.chunk_scales is not None:
        arrays["store_chunk_scales"] = st.chunk_scales.cpu().numpy()
    _savez(path, arrays)


def load_dynamic_index(path: str, device):
    """A :class:`~learnedmetricindex_tpu_torch.index.mutation.DynamicIndex`
    on ``device`` from a checkpoint written by either package's
    ``save_dynamic_index``; it searches as the saved one did and goes on
    allocating ids where it stopped."""
    from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore
    from learnedmetricindex_tpu_torch.index.mutation import DynamicIndex

    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(bytes(f["__meta__"].tobytes()).decode())
        if meta.get("kind") != "dynamic":
            raise ValueError(
                f"{path} is a plain index checkpoint (save_index) — "
                "load it with load_index, or re-save the deployment "
                "with save_dynamic_index"
            )
    index, _ = load_index(path, device)
    device = index.device
    with np.load(path, allow_pickle=False) as f:
        dtype = _STORE_DTYPES[meta["store_dtype"]]
        store = BucketStore(
            chunk_data=torch.as_tensor(f["store_chunk_data"]).to(device=device, dtype=dtype),
            chunk_ids=torch.as_tensor(f["store_chunk_ids"], device=device),
            bucket_chunk_start=f["store_bucket_chunk_start"],
            bucket_sizes=f["store_bucket_sizes"],
            chunk=meta["chunk"],
            n_buckets=meta["n_buckets"],
            chunk_scales=(torch.as_tensor(f["store_chunk_scales"], device=device)
                          if "store_chunk_scales" in f else None),
            row_slot=torch.as_tensor(f["store_row_slot"], device=device),
            bucket_chunk_ptr=f["store_bucket_chunk_ptr"],
            bucket_chunk_list=f["store_bucket_chunk_list"],
            bucket_fill=f["store_bucket_fill"],
        )
    return DynamicIndex(index, store, next_id=meta["next_id"])
