"""Dynamic index mutation: insert, delete and compact without a rebuild
(counterpart of ``learnedmetricindex_tpu/index/mutation.py``).

* **Insert** classifies the new rows through the index's fixed routers
  (:meth:`LearnedIndex.classify`) and appends them to their buckets at
  each bucket's high-water fill.  A full bucket takes a chunk from the
  free pool (chunks no bucket's list names) into its chunk list; when
  the pool runs dry the store's tensors grow by ``max(shortfall,
  n_chunks // 8, 1)`` chunks.  The scan reads every bucket through its
  chunk list, so the kernel needs no change and no new instance: it
  takes the number of slots at run time.
* **Delete** sets the row's slot to padding: id 0 and scale 0.0, which
  every scan and the rerank ignore.
* **Compact** repacks the live rows bucket by bucket in their scan
  order, so ties break as before and search output is bit-identical.

The host bookkeeping (chunk demand, free pool, the splice of the chunk
lists, slot assignment, growth of the store and of ``row_slot``) and the
validation are the JAX package's step for step, so the same operations
leave the same layout in both packages.

**In place, by design.**  The JAX package's updates are functional
(``.at[].set`` copies the store).  Here inserts and deletes write the
store's tensors in place (``index_copy_``, ``index_fill_``) and allocate
only when the store grows; compaction allocates the new store.  So
:func:`insert_rows` and :func:`delete_ids` *consume* their input store:
afterwards only the returned store is consistent (the input's host
arrays describe the old layout, its tensors may hold the new rows).  A
caller that searches while another thread mutates serializes the two,
as ``serve.SearchServer`` does with one lock.

:class:`DynamicIndex` names its steps on the profiler's clock
(``utils/profiling.py::span``): ``lmi.mutation.classify``,
``lmi.mutation.insert_rows`` and ``lmi.mutation.delete_ids``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore
from learnedmetricindex_tpu_torch.ops import quantize
from learnedmetricindex_tpu_torch.utils.profiling import span

_INT32_MAX = 2**31 - 1
_STORE_TYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


def _dtype_name(dtype) -> str:
    """``"float32"``, ``"bfloat16"`` or ``"int8"`` from a name, a torch
    dtype or a numpy-like dtype."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    elif isinstance(dtype, str):
        name = dtype
    else:
        try:
            name = np.dtype(dtype).name
        except TypeError:
            name = str(dtype)
    if name not in _STORE_TYPES:
        raise ValueError(f"store dtype must be one of {sorted(_STORE_TYPES)}, got {dtype!r}")
    return name


def _n_rows(vectors) -> int:
    return vectors.shape[0] if isinstance(vectors, torch.Tensor) else len(vectors)


def _require_packed(store: BucketStore, op: str) -> None:
    if store.chunk_data is None:
        raise ValueError(
            f"{op} needs a *packed* store (chunk_data present); this "
            "store is virtual — rebuild with BucketStore.build / "
            "prepare_packed_store, or rebuild the virtual store from "
            "the updated corpus (it holds no copies to mutate)"
        )


def ensure_mutable(store: BucketStore) -> BucketStore:
    """The store with mutation bookkeeping: the per-bucket chunk list
    (the identity over the contiguous CSR), the high-water fill
    (``bucket_sizes`` on a fresh store) and the id → slot map if it has
    none.  No tensor is copied."""
    _require_packed(store, "ensure_mutable")
    out = store
    if out.bucket_chunk_list is None:
        starts = store.bucket_chunk_start.astype(np.int64)
        out = store._replace(
            bucket_chunk_ptr=starts.copy(),
            bucket_chunk_list=np.arange(int(starts[-1]), dtype=np.int32),
            bucket_fill=store.bucket_sizes.astype(np.int32).copy(),
        )
    if out.row_slot is None:  # a shard of shard_packed_store has its list, not the map
        flat = out.chunk_ids.reshape(-1)
        n_ids = max(int(flat.max()) if flat.numel() else 0, 1)
        live = torch.nonzero(flat > 0)[:, 0]
        row_slot = torch.zeros(n_ids, dtype=torch.int32, device=store.device)
        row_slot[flat[live].long() - 1] = live.to(torch.int32)
        out = out._replace(row_slot=row_slot)
    return out


def _grown(t: torch.Tensor, extra_rows: int) -> torch.Tensor:
    """``t`` with ``extra_rows`` zero rows appended: one new tensor, so the
    peak is old + new."""
    out = t.new_empty((t.shape[0] + extra_rows, *t.shape[1:]))
    out[: t.shape[0]].copy_(t)
    out[t.shape[0] :].zero_()
    return out


def _grow(store: BucketStore, extra_chunks: int) -> BucketStore:
    """``extra_chunks`` zeroed chunks appended to the store's tensors (one
    O(n) copy; callers grow geometrically so copies amortize)."""
    pad = extra_chunks * store.chunk
    return store._replace(
        chunk_data=_grown(store.chunk_data, pad),
        chunk_ids=_grown(store.chunk_ids, extra_chunks),
        chunk_scales=None if store.chunk_scales is None else _grown(store.chunk_scales, pad),
    )


def insert_rows(
    store: BucketStore,
    vectors,
    bucket_ids: np.ndarray,
    object_ids: np.ndarray,
) -> BucketStore:
    """Append rows to their buckets' chunks; returns the updated store.
    The input store is consumed (see the module docstring).

    ``vectors``: ``(m, d)`` floats, host or tensor (an int8 store
    quantizes them where they lie, ``ops.quantize`` semantics, bit-equal
    on any device).  ``bucket_ids``: dense global bucket per row
    (``LearnedIndex.bucket_ids_from_prediction``).  ``object_ids``:
    1-based, caller-allocated (``DynamicIndex`` allocates them)."""
    store = ensure_mutable(store)
    bucket_ids = np.asarray(bucket_ids, np.int64)
    object_ids = np.asarray(object_ids, np.int64)
    m = _n_rows(vectors)
    if m == 0:
        return store
    if not (len(bucket_ids) == len(object_ids) == m):
        raise ValueError("vectors / bucket_ids / object_ids length mismatch")
    if object_ids.min() < 1:
        raise ValueError("object ids are 1-based (reference convention)")
    max_id = int(object_ids.max())
    # ids live in int32 tensors (chunk_ids): a larger one would wrap
    # negative and become an invisible ghost row; row_slot is dense over
    # the id space (4 B per id), so a huge sparse id, reachable from
    # HTTP, is an allocation hazard: both are errors, the second one
    # configurable
    if max_id > _INT32_MAX:
        raise ValueError(
            f"object id {max_id} exceeds int32 range ({_INT32_MAX}); "
            "ids are stored as int32 on device"
        )
    id_cap = int(os.environ.get("LMI_MAX_OBJECT_ID", 1 << 28))
    if max_id > id_cap:
        raise ValueError(
            f"object id {max_id} exceeds the configured id-space cap "
            f"({id_cap}); the id→slot map is dense (4 B per id up to "
            "the max id), so sparse giant ids waste HBM — renumber, "
            "or raise LMI_MAX_OBJECT_ID if the allocation is intended"
        )
    if bucket_ids.min() < 0 or bucket_ids.max() >= store.n_buckets:
        raise ValueError("bucket id out of range")
    # a duplicate live id would make a second row whose twin becomes an
    # undeletable ghost (row_slot points at one of them)
    if len(np.unique(object_ids)) != m:
        raise ValueError("duplicate object ids within the insert batch")
    dev = store.device
    maybe = object_ids[object_ids <= store.row_slot.shape[0]]
    if len(maybe):
        ids_dev = torch.as_tensor(maybe, device=dev)
        slots_of = store.row_slot[ids_dev - 1].long()
        live = (store.chunk_ids.reshape(-1)[slots_of] == ids_dev).cpu().numpy()
        if live.any():
            raise ValueError(
                f"{int(live.sum())} object id(s) already live (e.g. "
                f"{int(maybe[np.argmax(live)])}) — delete first or "
                "use fresh ids"
            )
    d = store.chunk_data.shape[1]
    if tuple(vectors.shape[1:]) != (d,):
        raise ValueError(f"vectors must be (m, {d}), got {tuple(vectors.shape)}")

    chunk = store.chunk
    ptr = store.bucket_chunk_ptr.astype(np.int64)
    clist = store.bucket_chunk_list
    fill = store.bucket_fill.astype(np.int64).copy()
    sizes = store.bucket_sizes.astype(np.int64).copy()

    # --- per-bucket chunk demand ---
    counts_new = np.bincount(bucket_ids, minlength=store.n_buckets)
    affected = np.nonzero(counts_new)[0]
    have = ptr[1:] - ptr[:-1]
    need = -(-(fill + counts_new) // chunk)
    extra_per_bucket = np.maximum(need - have, 0)
    n_extra = int(extra_per_bucket.sum())

    if n_extra:
        # the free pool (allocated, unassigned chunks), then growth
        total = store.n_chunks
        assigned = np.zeros(total, bool)
        assigned[clist] = True
        free = np.nonzero(~assigned)[0]
        if len(free) < n_extra:
            shortfall = n_extra - len(free)
            grow = max(shortfall, total // 8, 1)
            store = _grow(store, grow)
            free = np.concatenate([free, np.arange(total, total + grow, dtype=np.int64)])
        # splice the new chunks behind each bucket's run (the CSR is
        # rebuilt once: host O(n_chunks))
        new_ptr = np.concatenate([[0], np.cumsum(have + extra_per_bucket)]).astype(np.int64)
        new_list = np.zeros(int(new_ptr[-1]), dtype=np.int32)
        src = np.arange(len(clist), dtype=np.int64)
        old_bucket = np.repeat(np.arange(store.n_buckets, dtype=np.int64), have)
        new_list[new_ptr[old_bucket] + (src - ptr[old_bucket])] = clist
        take = 0
        for b in np.nonzero(extra_per_bucket)[0]:
            g = int(extra_per_bucket[b])
            new_list[new_ptr[b] + have[b] : new_ptr[b] + have[b] + g] = free[take : take + g]
            take += g
        ptr, clist = new_ptr, new_list

    # --- slot assignment: within-bucket append at the high-water ---
    order = np.argsort(bucket_ids, kind="stable")
    rank = np.empty(m, np.int64)
    starts_in_sorted = np.concatenate([[0], np.cumsum(counts_new)[:-1]])
    rank[order] = np.arange(m) - starts_in_sorted[bucket_ids[order]]
    pos = fill[bucket_ids] + rank
    slots = clist[ptr[bucket_ids] + pos // chunk].astype(np.int64) * chunk + pos % chunk

    # --- writes, in place ---
    slots_dev = torch.as_tensor(slots, device=dev)
    x = vectors if isinstance(vectors, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(vectors, dtype=np.float32))
    x = x.float()
    if store.chunk_data.dtype == torch.int8:
        q, sc = quantize.quantize_rows(x)  # on the host for host rows: int8 goes up
        rows, scales = q.to(dev), sc.to(dev)
    else:
        rows, scales = x.to(store.chunk_data.dtype).to(dev), None
    store.chunk_data.index_copy_(0, slots_dev, rows)
    store.chunk_ids.view(-1).index_copy_(
        0, slots_dev, torch.as_tensor(object_ids.astype(np.int32), device=dev))
    if store.chunk_scales is not None:
        store.chunk_scales.index_copy_(
            0, slots_dev, scales if scales is not None else torch.ones(m, device=dev))
    row_slot = store.row_slot
    if max_id > row_slot.shape[0]:
        row_slot = _grown(row_slot, max(max_id - row_slot.shape[0], row_slot.shape[0] // 4))
    row_slot.index_copy_(0, torch.as_tensor(object_ids - 1, device=dev),
                         slots_dev.to(torch.int32))

    fill[affected] += counts_new[affected]
    sizes[affected] += counts_new[affected]
    return store._replace(
        row_slot=row_slot,
        bucket_chunk_ptr=ptr,
        bucket_chunk_list=clist,
        bucket_fill=fill.astype(np.int32),
        bucket_sizes=sizes.astype(np.int32),
    )


def compact_store(store: BucketStore, *, donate: bool = False) -> BucketStore:
    """Repack a mutated store on its device: drop delete holes and the
    chunks taken from the pool.  The host reads only the id grid (4 B a
    slot) and computes where each live row goes; the rows move in one
    ``index_select`` into the new store, whose padding slots are then
    zeroed in place, so the peak is old + new store.  Rows keep their
    buckets and their order within each bucket's scan, so ties break as
    before and search output is bit-identical; int8 rows and scales keep
    their exact values.

    ``donate`` is accepted for signature parity with the JAX package and
    changes nothing here: the gather writes into a preallocated output
    (the JAX package donates to let XLA alias the old buffers), and the
    old tensors are freed when the last reference to the input store
    goes."""
    del donate
    store = ensure_mutable(store)
    chunk, dev = store.chunk, store.device
    flat_ids = store.chunk_ids.reshape(-1).cpu().numpy()

    # every listed chunk's slots in scan order (bucket, list position,
    # row): the order the JAX package's lexsort gives; free-pool chunks
    # hold only padding and are named by no list
    ptr, clist = store.chunk_list()
    entry_bucket = np.repeat(np.arange(store.n_buckets, dtype=np.int64), np.diff(ptr))
    scan_slots = (clist.astype(np.int64)[:, None] * chunk + np.arange(chunk)).reshape(-1)
    live = flat_ids[scan_slots] > 0
    src = scan_slots[live]  # old slots, new scan order
    bs = np.repeat(entry_bucket, chunk)[live]

    new_sizes = np.bincount(bs, minlength=store.n_buckets)
    nchunks = -(-new_sizes // chunk)
    starts = np.concatenate([[0], np.cumsum(nchunks)]).astype(np.int64)
    # the scan needs >= 1 chunk; a forced padding chunk stays in the free
    # pool (starts[-1] stays 0), so the next insert draws it from there
    n_chunks_new = max(int(starts[-1]), 1)
    cum = np.concatenate([[0], np.cumsum(new_sizes)]).astype(np.int64)
    within = np.arange(len(src), dtype=np.int64) - cum[bs]
    dst = starts[bs] * chunk + within
    src_for_dst = np.full(n_chunks_new * chunk, -1, np.int64)
    src_for_dst[dst] = src
    valid = src_for_dst >= 0

    gather = torch.as_tensor(np.maximum(src_for_dst, 0), device=dev)
    pad = torch.as_tensor(np.nonzero(~valid)[0], device=dev)
    chunk_data = store.chunk_data.new_empty((len(src_for_dst), store.chunk_data.shape[1]))
    torch.index_select(store.chunk_data, 0, gather, out=chunk_data)
    chunk_data.index_fill_(0, pad, 0)
    chunk_scales = None
    if store.chunk_scales is not None:
        chunk_scales = torch.index_select(store.chunk_scales, 0, gather).index_fill_(0, pad, 0.0)
    ids_new = np.where(valid, flat_ids[np.maximum(src_for_dst, 0)], 0).astype(np.int32)
    row_slot = np.zeros(store.row_slot.shape[0], np.int32)
    row_slot[ids_new[valid] - 1] = np.nonzero(valid)[0].astype(np.int32)
    return store._replace(
        chunk_data=chunk_data,
        chunk_ids=torch.as_tensor(ids_new.reshape(n_chunks_new, chunk), device=dev),
        chunk_scales=chunk_scales,
        row_slot=torch.as_tensor(row_slot, device=dev),
        bucket_chunk_start=starts.astype(np.int32),
        bucket_sizes=new_sizes.astype(np.int32),
        bucket_chunk_ptr=starts.copy(),
        bucket_chunk_list=np.arange(int(starts[-1]), dtype=np.int32),
        bucket_fill=new_sizes.astype(np.int32),
    )


def delete_ids(store: BucketStore, object_ids) -> Tuple[BucketStore, int]:
    """Remove rows by 1-based object id: ``(store, n_deleted)``.  Absent
    and out-of-range ids are skipped, duplicates count once.  Slots
    become padding in place (id 0, scale 0.0); the input store is
    consumed (see the module docstring)."""
    store = ensure_mutable(store)
    object_ids = np.unique(np.asarray(object_ids, np.int64))
    if len(object_ids) == 0:
        return store, 0
    ids = object_ids[(object_ids >= 1) & (object_ids <= store.row_slot.shape[0])]
    if len(ids) == 0:
        return store, 0
    dev = store.device
    ids_dev = torch.as_tensor(ids, device=dev)
    slots = store.row_slot[ids_dev - 1].long()
    slots = slots[store.chunk_ids.reshape(-1)[slots] == ids_dev]
    n_del = int(slots.shape[0])
    if n_del == 0:
        return store, 0
    store.chunk_ids.view(-1).index_fill_(0, slots, 0)
    if store.chunk_scales is not None:
        store.chunk_scales.index_fill_(0, slots, 0.0)
    # live-count bookkeeping
    chunk_bucket = store.chunk_owner()[0]
    sizes = store.bucket_sizes.astype(np.int64).copy()
    np.subtract.at(sizes, chunk_bucket[slots.cpu().numpy() // store.chunk], 1)
    return store._replace(bucket_sizes=sizes.astype(np.int32)), n_del


class DynamicIndex:
    """A built index that takes inserts and deletes while it serves.

    Wraps a :class:`~learnedmetricindex_tpu_torch.index.index.LearnedIndex`
    (its routers stay fixed: the partition is whatever the models
    predict) and a packed store on the index's device, which this object
    owns and mutates.  Navigation and scan use the same vectors.

    >>> dyn = DynamicIndex.from_built(index, data, data_prediction)
    >>> ids = dyn.insert(new_vectors)
    >>> dyn.delete(ids[:5])
    >>> dists, nns, t = dyn.search(queries, n_buckets=4, k=10)
    """

    def __init__(self, index, store: BucketStore, next_id: Optional[int] = None):
        _require_packed(store, "DynamicIndex")
        if store.device != index.device:
            raise ValueError(f"the store lies on {store.device}, the index on {index.device}")
        self.index = index
        self.store = ensure_mutable(store)
        if next_id is None:
            ids = self.store.chunk_ids
            next_id = (int(ids.max()) if ids.numel() else 0) + 1
        self.next_id = int(next_id)

    @classmethod
    def from_built(
        cls,
        index,
        data_search,
        data_prediction: np.ndarray,
        chunk: Optional[int] = None,
        dtype=None,
    ) -> "DynamicIndex":
        """A mutable store from a build's outputs, packed on the index's
        device.  ``data_search``: host rows (packed on the host as
        ``dtype``, default ``config.dtype``; ``"int8"`` quantizes per
        row, ``build_packed_int8``), a tensor, or ``(int8 tensor, row
        scales)``.  A tensor is packed where it lies, in its own type,
        except that a float tensor is quantized first when ``dtype`` is
        ``"int8"`` and cast when it is another float type."""
        bucket_ids = index.bucket_ids_from_prediction(data_prediction)
        n_total = int(np.prod(index.config.n_categories, dtype=np.int64))
        chunk = chunk or index.config.chunk_size
        name = _dtype_name(dtype or index.config.dtype)
        values, scales = data_search if isinstance(data_search, tuple) else (data_search, None)
        if isinstance(values, torch.Tensor):
            values = values.to(index.device)
            if scales is not None:
                scales = torch.as_tensor(scales, dtype=torch.float32, device=index.device)
            elif values.dtype == torch.int8:
                raise ValueError("an int8 corpus needs its row scales: (values, row_scales)")
            elif name == "int8":
                values, scales = quantize.quantize_rows(values)
            else:
                values = values.to(_STORE_TYPES[name])
            store = BucketStore.build_packed_device(
                values, bucket_ids, n_total, chunk=chunk, row_scales=scales)
        else:
            data = np.asarray(values, np.float32)
            if scales is not None:
                data = data * np.asarray(scales, np.float32)[:, None]
            if name == "int8":
                store = BucketStore.build_packed_int8(
                    data, bucket_ids, n_total, chunk=chunk, device=index.device)
            else:
                store = BucketStore.build(
                    data, bucket_ids, n_total, chunk=chunk, dtype=name, device=index.device)
        return cls(index, store)

    @property
    def n_rows(self) -> int:
        """Live (not deleted) rows."""
        return int(self.store.bucket_sizes.sum())

    # ---- persistence: the corpus lives in the store (serve-time inserts
    # exist nowhere else), so a checkpoint holds the packed arrays ----
    def save(self, path: str) -> None:
        from learnedmetricindex_tpu_torch.index.serialization import save_dynamic_index

        save_dynamic_index(self, path)

    @classmethod
    def load(cls, path: str, device) -> "DynamicIndex":
        from learnedmetricindex_tpu_torch.index.serialization import load_dynamic_index

        return load_dynamic_index(path, device)

    def insert(self, vectors, object_ids=None) -> np.ndarray:
        """Classify and append ``(m, d)`` rows (host or tensor); returns
        their 1-based object ids."""
        if not isinstance(vectors, torch.Tensor):
            vectors = np.asarray(vectors, np.float32)
        m = _n_rows(vectors)
        if object_ids is None:
            object_ids = np.arange(self.next_id, self.next_id + m, dtype=np.int64)
        else:
            object_ids = np.asarray(object_ids, np.int64)
        if m == 0:
            return object_ids[:0]
        d = self.store.chunk_data.shape[1]
        if vectors.ndim != 2 or vectors.shape[1] != d:
            raise ValueError(f"vectors must be (m, {d}), got {tuple(vectors.shape)}")
        with span("lmi.mutation.classify"):
            bucket_ids = self.index.bucket_ids_from_prediction(self.index.classify(vectors))
        with span("lmi.mutation.insert_rows"):
            self.store = insert_rows(self.store, vectors, bucket_ids, object_ids)
        self.next_id = max(self.next_id, int(object_ids.max()) + 1)
        return object_ids

    def delete(self, object_ids) -> int:
        with span("lmi.mutation.delete_ids"):
            self.store, n = delete_ids(self.store, object_ids)
        return n

    def search(self, queries, n_buckets: int = 1, k: int = 10, **knobs):
        """Search the live store (knobs as ``LearnedIndex.search``:
        ``policy``, ``precision``, ``rerank``, ``rerank_margin``,
        ``nav_temp``, ``qtile``)."""
        if not isinstance(queries, torch.Tensor):
            queries = np.asarray(queries, np.float32)
        return self.index.search(None, queries, None, queries, None, n_buckets=n_buckets, k=k,
                                 store=self.store, **knobs)

    def compact(self, donate: bool = False) -> None:
        """Repack the store (:func:`compact_store`: rows keep their
        buckets and scan order, search output is bit-identical)."""
        self.store = compact_store(self.store, donate=donate)
