"""Insert, delete and compact over a store sharded by bucket over a list
of devices (counterpart of
``learnedmetricindex_tpu/parallel/sharded_mutation.py``).

:class:`ShardedDynamicIndex` gives a :class:`ShardedStore` the surface of
the single store's ``DynamicIndex``:

* **Insert** routes the rows through the index's fixed routers
  (``LearnedIndex.classify``), maps each global bucket to its shard and
  local bucket (``bucket_device``, ``bucket_local``), and gives every
  shard that receives rows one call of ``index/mutation.py::insert_rows``
  with local bucket ids.  Each shard grows on its own when its pool runs
  dry.
* **Delete** resolves ids through the host map id → shard and gives each
  shard one ``delete_ids`` call.
* **Compact** gives each shard one ``compact_store``.  Rows never change
  shards, and each keeps its bucket and scan order, so searches are
  bit-identical before and after.

The JAX package stacks the shards on one padded chunk axis, plans every
shard's slots on the host and writes all of them in one ``shard_map``
scatter, growing the common axis when any shard runs out.  The port
keeps a list of per-device stores, so each shard is mutated by the
single store's own code at its own size.  Like the port's
``DynamicIndex``, the writes land in place (``index/mutation.py``); the
serving layer's one lock serializes them with searches.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch.index.mutation import (
    _INT32_MAX,
    compact_store,
    delete_ids,
    ensure_mutable,
    insert_rows,
)
from learnedmetricindex_tpu_torch.parallel import multiprocess as mp
from learnedmetricindex_tpu_torch.parallel.sharded_index import ShardedStore, shard_store


class ShardedDynamicIndex:
    """A built index over a sharded store that takes inserts and deletes
    while it serves.  The routers stay fixed; the shards move.

    The host keeps the authoritative id → shard map (one byte an id,
    built once from the shards' id grids); each shard's ``row_slot``, on
    its device, maps the id on to its slot (:meth:`locate` reads both).

    >>> dyn = ShardedDynamicIndex.from_built(index, data, pred, devices)
    >>> ids = dyn.insert(new_vectors)
    >>> dyn.delete(ids[:5])
    >>> dists, nns, t = dyn.search(queries, n_buckets=4, k=10)

    ``next_id``: the source deployment's allocator mark when promoting a
    mutated store (``shard_packed_store``); the store records only live
    ids, so the default (the largest live id + 1) could issue a deleted
    id again.

    ``donate`` is accepted for signature parity with the JAX package and
    kept as ``self.donate``; it changes nothing here, because every
    mutation already writes the shards' tensors in place (the JAX package
    donates to let XLA alias the old buffers).

    A store sharded over the ranks of a multi-process world is refused,
    as the JAX package refuses a multi-process mesh."""

    def __init__(self, index, sharded: ShardedStore, next_id: Optional[int] = None,
                 donate: bool = False):
        self.donate = bool(donate)
        if mp.is_multiprocess(sharded.world):
            raise ValueError(
                "ShardedDynamicIndex is single-controller: a multi-process world would need "
                "every process to apply the same mutation log — drive mutations from one "
                "controller or rebuild via shard_store")
        self.index = index
        self.sharded = sharded._replace(shards=[ensure_mutable(s) for s in sharded.shards])
        grids = [s.chunk_ids.reshape(-1).cpu().numpy() for s in self.sharded.shards]
        max_id = max((int(g.max(initial=0)) for g in grids), default=0)
        self._id_shard = np.full(max(max_id, 1), -1,
                                 np.int8 if len(grids) <= 127 else np.int16)
        for i, g in enumerate(grids):
            self._id_shard[g[g > 0] - 1] = i
        self.next_id = int(next_id if next_id is not None else max_id + 1)

    @classmethod
    def from_built(cls, index, data_search, data_prediction: np.ndarray, devices: Sequence,
                   chunk: Optional[int] = None) -> "ShardedDynamicIndex":
        """A mutable sharded store from a build's outputs: ``shard_store``
        of ``data_search`` (rows, a tensor, or ``(int8 values, row
        scales)``) at ``chunk`` (default ``config.chunk_size``)."""
        values, scales = data_search if isinstance(data_search, tuple) else (data_search, None)
        sharded = shard_store(values, index.bucket_ids_from_prediction(data_prediction),
                              int(np.prod(index.config.n_categories, dtype=np.int64)), devices,
                              chunk=chunk or index.config.chunk_size, row_scales=scales)
        return cls(index, sharded)

    @property
    def n_rows(self) -> int:
        """Live (not deleted) rows over every shard."""
        return int(sum(int(s.bucket_sizes.sum()) for s in self.sharded.shards))

    @property
    def store(self) -> ShardedStore:
        """The live store (``SearchServer`` reads it after every mutation)."""
        return self.sharded

    def locate(self, object_ids) -> Tuple[np.ndarray, np.ndarray]:
        """``(shard, slot)`` of each 1-based id, ``(-1, -1)`` for ids not live."""
        object_ids = np.asarray(object_ids, np.int64)
        shard = np.full(len(object_ids), -1, np.int64)
        inside = (object_ids >= 1) & (object_ids <= len(self._id_shard))
        shard[inside] = self._id_shard[object_ids[inside] - 1]
        slot = np.full(len(object_ids), -1, np.int64)
        for i, st in enumerate(self.sharded.shards):
            sel = np.nonzero(shard == i)[0]
            if len(sel):
                ids = torch.as_tensor(object_ids[sel] - 1, device=st.device)
                slot[sel] = st.row_slot[ids].cpu().numpy()
        return shard, slot

    def _grow_id_map(self, max_id: int) -> None:
        cap = len(self._id_shard)
        if max_id > cap:
            grown = np.full(max(max_id, cap + cap // 4), -1, self._id_shard.dtype)
            grown[:cap] = self._id_shard
            self._id_shard = grown

    def insert(self, vectors, object_ids=None) -> np.ndarray:
        """Classify ``(m, d)`` rows (host or tensor) and append each to its
        shard; returns their 1-based ids.  The single store's validation:
        lengths, 1-based ids in int32 and under ``LMI_MAX_OBJECT_ID``, no
        duplicate, no id already live."""
        if not isinstance(vectors, torch.Tensor):
            vectors = np.asarray(vectors, np.float32)
        m = vectors.shape[0]
        if object_ids is None:
            object_ids = np.arange(self.next_id, self.next_id + m, dtype=np.int64)
        else:
            object_ids = np.asarray(object_ids, np.int64)
        if m == 0:
            return object_ids[:0]
        if len(object_ids) != m:
            raise ValueError("vectors / object_ids length mismatch")
        if object_ids.min() < 1:
            raise ValueError("object ids are 1-based (reference convention)")
        max_id = int(object_ids.max())
        if max_id > _INT32_MAX:
            raise ValueError(f"object id {max_id} exceeds int32 range ({_INT32_MAX})")
        id_cap = int(os.environ.get("LMI_MAX_OBJECT_ID", 1 << 28))
        if max_id > id_cap:
            raise ValueError(
                f"object id {max_id} exceeds the configured id-space cap ({id_cap}) — "
                "renumber, or raise LMI_MAX_OBJECT_ID")
        if len(np.unique(object_ids)) != m:
            raise ValueError("duplicate object ids within the insert batch")
        in_map = object_ids[object_ids <= len(self._id_shard)]
        live = self._id_shard[in_map - 1] >= 0
        if live.any():
            raise ValueError(f"object id(s) already live (e.g. {int(in_map[live][0])}) — "
                             "delete first or use fresh ids")
        d = self.sharded.dim
        if vectors.ndim != 2 or vectors.shape[1] != d:
            raise ValueError(f"vectors must be (m, {d}), got {tuple(vectors.shape)}")

        buckets = self.index.bucket_ids_from_prediction(self.index.classify(vectors))
        shard_of = self.sharded.bucket_device[buckets]
        local = self.sharded.bucket_local[buckets]
        shards = list(self.sharded.shards)
        for i in np.unique(shard_of):
            sel = np.nonzero(shard_of == i)[0]
            rows = (vectors[torch.as_tensor(sel, device=vectors.device)]
                    if isinstance(vectors, torch.Tensor) else vectors[sel])
            shards[i] = insert_rows(shards[i], rows, local[sel], object_ids[sel])
        self.sharded = self.sharded._replace(shards=shards)
        self._grow_id_map(max_id)
        self._id_shard[object_ids - 1] = shard_of
        self.next_id = max(self.next_id, max_id + 1)
        return object_ids

    def delete(self, object_ids) -> int:
        """Remove rows by 1-based id (absent ids are skipped, duplicates
        count once); returns how many were live."""
        object_ids = np.unique(np.asarray(object_ids, np.int64))
        object_ids = object_ids[(object_ids >= 1) & (object_ids <= len(self._id_shard))]
        live = object_ids[self._id_shard[object_ids - 1] >= 0]
        if len(live) == 0:
            return 0
        shard_of = self._id_shard[live - 1]
        shards = list(self.sharded.shards)
        n_del = 0
        for i in np.unique(shard_of):
            shards[i], n = delete_ids(shards[i], live[shard_of == i])
            n_del += n
        self.sharded = self.sharded._replace(shards=shards)
        self._id_shard[live - 1] = -1
        return n_del

    def compact(self) -> dict:
        """Repack every shard (``compact_store``): rows keep their shard,
        bucket and scan order, so search output is bit-identical.  Returns
        ``{"chunks_before", "chunks_after"}``, the widest shard's chunk
        count (the JAX package's common chunk axis)."""
        before = self.sharded.n_chunks
        self.sharded = self.sharded._replace(
            shards=[compact_store(s) for s in self.sharded.shards])
        return {"chunks_before": before, "chunks_after": self.sharded.n_chunks}

    def search(self, queries, n_buckets: int = 1, k: int = 10, **knobs):
        """Search the live sharded store (``LearnedIndex.search`` runs
        ``sharded_search`` over it)."""
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries, np.float32)
        return self.index.search(None, queries, None, queries, None, n_buckets=n_buckets, k=k,
                                 store=self.sharded, **knobs)
