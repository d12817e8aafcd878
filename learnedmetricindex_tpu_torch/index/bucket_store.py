"""Chunked bucket store and the device scan path (counterpart of
``learnedmetricindex_tpu/index/bucket_store.py``).

**Layout.**  Rows are packed sorted by bucket into fixed-size chunks: a
flat ``chunk_data (n_chunks·chunk, d)`` with 1-based object ids
``chunk_ids (n_chunks, chunk)`` (0 = padding slot).  Bucket ``b`` owns
chunks ``bucket_chunk_start[b]:bucket_chunk_start[b+1]``; only a
bucket's last chunk is padded.  Padding slots hold zeros and scale 0.
A mutated store (``index/mutation.py``) carries a per-bucket *chunk
list* instead: bucket ``b`` owns the physical chunks
``bucket_chunk_list[bucket_chunk_ptr[b]:bucket_chunk_ptr[b+1]]``, in
scan order, which need not be contiguous or ascending; chunks no list
names are the free pool (:meth:`BucketStore.chunk_list`).

A *virtual* store (:meth:`BucketStore.build_virtual`) keeps no copy of
the rows: ``data_ref`` is the unmoved ``(n, d)`` corpus (f32, bf16, or
int8 with ``row_scales``) and the id grid doubles as the map from slot
to corpus row (``chunk_ids - 1``).  It costs the id grid and nothing
else; the scan kernel reads each slot's row through the grid.  It is
what ``LearnedIndex.get_bucket_store`` makes of a tensor corpus, as the
JAX package makes one of a device array.

**Scan** (:func:`scan_buckets_device`), for one batch of queries and
their (Q, V) bucket visit order:

1. :func:`build_plan` groups the (query, visit) pairs by bucket and pads
   each bucket's group to whole query tiles: ``qidx`` (query per padded
   slot, -1 = padding), the bucket of each tile (a *pair*), and
   ``pair_rows``, the padded slot of each (query, visit);
2. ``ops.scan_kernel.scan_pairs`` returns, per pair, each query's exact
   top-``k_scan`` over all of the bucket's chunks;
3. :func:`merge_pairs` merges a query's ``V`` candidate lists;
4. :func:`rerank_exact_slots` recomputes exact f32 distances for the
   shortlist; slots resolve to object ids last.

Each step runs under a span (``utils/profiling.py::span``): ``lmi.plan``
(:func:`scan_inputs`), ``lmi.scan``, ``lmi.merge``, ``lmi.rerank`` and
``lmi.resolve``.

Distances are ``1 - <q, x>``; a query with no candidate gets
``dist = inf, id = 0``.

**Gather mode.**  ``LMI_GATHER_MODE=kernel`` (read per search, as the
JAX package reads it) routes the merge's candidate gather through one
``ops.gather_kernel.gather_pairs`` launch; any other value keeps torch
indexing.  The two modes give bit-identical results.  Neither
materializes work-query rows: the scan reads them through ``qidx``.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch import native
from learnedmetricindex_tpu_torch.ops import quantize
from learnedmetricindex_tpu_torch.ops.gather_kernel import gather_pairs, gather_pairs_reference
from learnedmetricindex_tpu_torch.ops.precision import full_f32
from learnedmetricindex_tpu_torch.ops.scan_kernel import MAX_QTILE, scan_pairs
from learnedmetricindex_tpu_torch.ops.select import smallest_k
from learnedmetricindex_tpu_torch.utils.profiling import span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}


class BucketStore(NamedTuple):
    """A packed or a virtual store (see module docstring).  Host CSR
    arrays are numpy; the rest are tensors on the store's device."""

    chunk_ids: torch.Tensor  # (n_chunks, chunk) int32, 1-based, 0 = pad
    bucket_chunk_start: np.ndarray  # (n_buckets + 1,) int32 chunk CSR
    bucket_sizes: np.ndarray  # (n_buckets,) int32 true row counts
    chunk: int
    n_buckets: int
    chunk_data: Optional[torch.Tensor] = None  # (n_chunks·chunk, d) f32 / bf16 / int8, packed
    chunk_scales: Optional[torch.Tensor] = None  # (n_chunks·chunk,) f32, int8 stores
    row_slot: Optional[torch.Tensor] = None  # (n,) int32: object id-1 → slot
    # mutation bookkeeping (index/mutation.py), None on fresh builds: the
    # per-bucket chunk list in scan order and each bucket's high-water
    # row count within it (inserts append there; deletes leave holes)
    bucket_chunk_ptr: Optional[np.ndarray] = None  # (n_buckets + 1,) int64 list CSR
    bucket_chunk_list: Optional[np.ndarray] = None  # (n_assigned,) int32 physical chunks
    bucket_fill: Optional[np.ndarray] = None  # (n_buckets,) int32
    # a virtual store: the unmoved corpus and, for an int8 one, its scales
    data_ref: Optional[torch.Tensor] = None  # (n, d) f32 / bf16 / int8
    row_scales: Optional[torch.Tensor] = None  # (n,) f32

    @property
    def n_chunks(self) -> int:
        return self.chunk_ids.shape[0]

    @property
    def virtual(self) -> bool:
        return self.chunk_data is None

    @property
    def rows_ref(self) -> torch.Tensor:
        """The tensor whose rows the scan reads: the packed slabs, or the
        corpus of a virtual store."""
        return self.data_ref if self.chunk_data is None else self.chunk_data

    @property
    def device(self) -> torch.device:
        return self.rows_ref.device

    @property
    def dim(self) -> int:
        return int(self.rows_ref.shape[-1])

    def nbytes(self) -> int:
        """Device bytes of the slabs and the id grid; a virtual store's
        are the id grid's alone."""
        data = 0 if self.virtual else self.chunk_data.numel() * self.chunk_data.element_size()
        return data + self.chunk_ids.numel() * 4

    def chunk_list(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(ptr (n_buckets + 1,) int64, list int32)``: bucket ``b`` scans
        the physical chunks ``list[ptr[b]:ptr[b+1]]`` in that order.  A
        fresh store's list is the identity over its contiguous CSR."""
        if self.bucket_chunk_list is not None:
            return self.bucket_chunk_ptr.astype(np.int64), self.bucket_chunk_list
        ptr = self.bucket_chunk_start.astype(np.int64)
        return ptr, np.arange(int(ptr[-1]), dtype=np.int32)

    def chunk_owner(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(bucket, position)`` of every physical chunk, int64: the bucket
        whose list holds it and its place in that list (scan order); -1
        and 0 for a chunk of the free pool.  The scan position of slot
        ``s`` is ``position[s // chunk] * chunk + s % chunk``."""
        ptr, clist = self.chunk_list()
        entry_bucket = np.repeat(np.arange(self.n_buckets, dtype=np.int64), np.diff(ptr))
        bucket = np.full(self.n_chunks, -1, np.int64)
        bucket[clist] = entry_bucket
        position = np.zeros(self.n_chunks, np.int64)
        position[clist] = np.arange(len(clist), dtype=np.int64) - ptr[entry_bucket]
        return bucket, position

    def scales_flat(self) -> torch.Tensor:
        """(n_slots,) f32 dequant scale per slot; 0.0 marks padding."""
        if self.chunk_scales is not None:
            return self.chunk_scales
        ids = self.chunk_ids.reshape(-1)
        if self.row_scales is not None:
            return torch.where(ids > 0, self.row_scales[(ids.long() - 1).clamp_min(0)], 0.0)
        return (ids > 0).float()

    def slab(self, s0: int, s1: int) -> torch.Tensor:
        """The stored rows of slots ``s0:s1``, not dequantized (a virtual
        store's padding slots read corpus row 0; their scale is 0)."""
        if not self.virtual:
            return self.chunk_data[s0:s1]
        ids = self.chunk_ids.reshape(-1)[s0:s1].long()
        return self.data_ref[(ids - 1).clamp_min(0)]

    @classmethod
    def build(
        cls,
        data: np.ndarray,
        bucket_ids: np.ndarray,
        n_buckets: int,
        chunk: int = 2048,
        dtype="float32",
        object_ids: Optional[np.ndarray] = None,
        *,
        device,
    ) -> "BucketStore":
        """Pack host rows into the chunked layout (host counting sort),
        stored as ``dtype`` on ``device``."""
        data = np.asarray(data, dtype=np.float32)
        slot_rows, starts, counts = _host_layout(bucket_ids, n_buckets, chunk)
        valid = slot_rows >= 0
        flat = np.zeros((len(slot_rows), data.shape[1]), dtype=np.float32)
        flat[valid] = data[slot_rows[valid]]
        ids, row_slot = _host_ids(slot_rows, object_ids, len(data))
        return cls(
            chunk_data=torch.as_tensor(flat, device=device).to(_DTYPES[dtype]),
            chunk_ids=torch.as_tensor(ids.reshape(-1, chunk), device=device),
            bucket_chunk_start=starts,
            bucket_sizes=counts.astype(np.int32),
            chunk=chunk,
            n_buckets=n_buckets,
            row_slot=torch.as_tensor(row_slot, device=device),
        )

    @classmethod
    def build_packed_int8(
        cls,
        data: np.ndarray,
        bucket_ids: np.ndarray,
        n_buckets: int,
        chunk: int = 2048,
        object_ids: Optional[np.ndarray] = None,
        *,
        device,
    ) -> "BucketStore":
        """Packed store with symmetric per-row int8 quantization done on
        the host in blocks (``ops.quantize`` semantics); the device gets
        only the int8 slabs and per-slot f32 scales."""
        data = np.asarray(data, dtype=np.float32)
        n, d = data.shape
        slot_rows, starts, counts = _host_layout(bucket_ids, n_buckets, chunk)
        valid_idx = np.nonzero(slot_rows >= 0)[0]
        flat = np.zeros((len(slot_rows), d), dtype=np.int8)
        scales = np.zeros(len(slot_rows), dtype=np.float32)
        block = 1_000_000  # bounds the f32 transients to a few block copies
        for s in range(0, len(valid_idx), block):
            vi = valid_idx[s : s + block]
            q, sc = quantize.quantize_rows(torch.from_numpy(data[slot_rows[vi]]))
            flat[vi] = q.numpy()
            scales[vi] = sc.numpy()
        ids, row_slot = _host_ids(slot_rows, object_ids, n)
        return cls(
            chunk_data=torch.as_tensor(flat, device=device),
            chunk_ids=torch.as_tensor(ids.reshape(-1, chunk), device=device),
            chunk_scales=torch.as_tensor(scales, device=device),
            bucket_chunk_start=starts,
            bucket_sizes=counts.astype(np.int32),
            chunk=chunk,
            n_buckets=n_buckets,
            row_slot=torch.as_tensor(row_slot, device=device),
        )

    @classmethod
    def build_virtual(
        cls,
        data_ref: torch.Tensor,
        bucket_ids: np.ndarray,
        n_buckets: int,
        chunk: int = 2048,
        row_scales: Optional[torch.Tensor] = None,
    ) -> "BucketStore":
        """An index-only store over an unmoved corpus tensor (f32, bf16,
        or int8 with ``row_scales``): only the ``(n_chunks, chunk)`` id
        grid is made (the host counting sort of :meth:`build`; ids are
        row + 1), on the corpus's device.  The corpus must stay alive and
        unchanged while the store is searched."""
        if data_ref.dim() != 2 or data_ref.dtype not in _DTYPES.values():
            raise ValueError("a virtual store reads an (n, d) f32, bf16 or int8 corpus, "
                             f"got {tuple(data_ref.shape)} {data_ref.dtype}")
        n = len(bucket_ids)
        if data_ref.shape[0] < n:
            raise ValueError(f"the corpus has {data_ref.shape[0]} rows, the bucket ids {n}")
        if data_ref.dtype == torch.int8 and row_scales is None:
            raise ValueError("an int8 corpus needs its row scales")
        device = data_ref.device
        slot_rows, starts, counts = _host_layout(bucket_ids, n_buckets, chunk)
        ids = np.where(slot_rows >= 0, slot_rows + 1, 0).astype(np.int32)
        if row_scales is not None:
            row_scales = torch.as_tensor(row_scales).to(device=device, dtype=torch.float32)
            row_scales = row_scales.contiguous()
        return cls(
            data_ref=data_ref.contiguous(),
            row_scales=row_scales,
            chunk_ids=torch.as_tensor(ids.reshape(-1, chunk), device=device),
            bucket_chunk_start=starts,
            bucket_sizes=counts.astype(np.int32),
            chunk=chunk,
            n_buckets=n_buckets,
        )

    @classmethod
    def build_packed_device(
        cls,
        data_ref: torch.Tensor,
        bucket_ids: np.ndarray,
        n_buckets: int,
        chunk: int = 2048,
        row_scales: Optional[torch.Tensor] = None,
        slab_batch: int = 128,
        object_ids: Optional[np.ndarray] = None,
        device=None,
    ) -> "BucketStore":
        """Pack a corpus tensor (f32, bf16, or int8 with ``row_scales``)
        where it lies, ``slab_batch`` chunks per gather, so the transient
        is one batch of slabs.  Only the slot layout is computed on the
        host.  The caller may free ``data_ref`` afterwards.

        ``object_ids`` (1-based, one per entry of ``bucket_ids``) names
        the corpus row each entry is (``object_ids - 1``) and the id it
        reports; by default entry ``i`` is row ``i``.  ``device``: where
        the store lives (default the corpus's); each batch of slabs is
        gathered on the corpus's device and copied there."""
        src_device = data_ref.device
        device = src_device if device is None else torch.device(device)
        slot_rows, starts, counts = _host_layout(bucket_ids, n_buckets, chunk)
        ids_host, row_slot = _host_ids(slot_rows, object_ids, len(bucket_ids))
        n_slots = len(ids_host)
        ids = torch.as_tensor(ids_host, device=src_device)
        chunk_data = torch.empty((n_slots, data_ref.shape[1]), dtype=data_ref.dtype, device=device)
        chunk_scales = None
        if row_scales is not None:
            row_scales = torch.as_tensor(row_scales).to(device=src_device, dtype=torch.float32)
            chunk_scales = torch.empty(n_slots, dtype=torch.float32, device=device)
        step = slab_batch * chunk
        for s0 in range(0, n_slots, step):
            cids = ids[s0 : s0 + step]
            live = cids > 0
            rows = torch.clamp_min(cids - 1, 0).long()
            chunk_data[s0 : s0 + step] = torch.where(live[:, None], data_ref[rows], 0).to(device)
            if row_scales is not None:
                chunk_scales[s0 : s0 + step] = torch.where(live, row_scales[rows], 0.0).to(device)
        return cls(
            chunk_data=chunk_data,
            chunk_ids=ids.reshape(-1, chunk).to(device),
            chunk_scales=chunk_scales,
            bucket_chunk_start=starts,
            bucket_sizes=counts.astype(np.int32),
            chunk=chunk,
            n_buckets=n_buckets,
            row_slot=torch.as_tensor(row_slot, device=device),
        )


def _host_layout(bucket_ids, n_buckets: int, chunk: int):
    """The host counting sort shared by every build (the CSR of the JAX
    package's ``build_virtual``): ``slot_rows`` (source row per slot,
    -1 = padding), the chunk CSR and the per-bucket row counts."""
    counts = native.bincount(np.asarray(bucket_ids), n_buckets)
    starts = np.concatenate([[0], np.cumsum(-(-counts // chunk))]).astype(np.int32)
    slot_rows, _ = native.fill_slots(
        np.asarray(bucket_ids), starts.astype(np.int64) * chunk, int(starts[-1]) * chunk
    )
    return slot_rows, starts, counts


def _host_ids(slot_rows: np.ndarray, object_ids, n: int):
    """1-based object id per slot and the inverse map id-1 → slot."""
    if object_ids is None:
        object_ids = np.arange(1, n + 1, dtype=np.int32)
    else:
        object_ids = np.asarray(object_ids, dtype=np.int32)
    valid = slot_rows >= 0
    ids = np.zeros(len(slot_rows), dtype=np.int32)
    ids[valid] = object_ids[slot_rows[valid]]
    row_slot = np.zeros(int(object_ids.max()) if n else 0, dtype=np.int32)
    row_slot[ids[valid] - 1] = np.nonzero(valid)[0].astype(np.int32)
    return ids, row_slot


class ScanPlan(NamedTuple):
    """Pair-level work list of one visit set (see :func:`build_plan`)."""

    qidx: torch.Tensor  # (n_pairs·qtile,) int32 query per padded slot, -1 = pad
    pair_bucket: torch.Tensor  # (n_pairs,) int32 bucket of each query tile
    pair_rows: torch.Tensor  # (Q·V,) int64 padded slot of each (query, visit), -1 = none

    @property
    def n_pairs(self) -> int:
        return self.pair_bucket.shape[0]


def build_plan(bucket_order: torch.Tensor, n_buckets: int, qtile: int) -> ScanPlan:
    """Group the (query, visit) pairs of ``bucket_order`` (Q, V), -1 =
    unused visit, by bucket (stable, so each bucket keeps query order)
    and pad each bucket's group to whole ``qtile`` tiles.  ``qidx`` and
    ``pair_rows`` mean what they mean in the JAX package's
    ``_build_plan_device``; the Mosaic-only parts (packed item
    metadata, static envelopes, the dummy pair) are gone."""
    device = bucket_order.device
    Q, V = bucket_order.shape
    b = bucket_order.reshape(-1).long()
    valid = b >= 0
    bq = torch.where(valid, b, n_buckets)  # unused visits sort last
    order = torch.argsort(bq, stable=True)
    b_sorted = bq[order]
    counts = torch.bincount(bq, minlength=n_buckets + 1)[:n_buckets]
    tiles = -(-counts // qtile)
    tile_end = torch.cumsum(tiles, 0)
    pad_starts = (tile_end - tiles) * qtile
    src_starts = torch.cumsum(counts, 0) - counts
    n_pairs = int(tile_end[-1]) if n_buckets else 0

    valid_sorted = b_sorted < n_buckets
    bs = torch.clamp_max(b_sorted, n_buckets - 1)
    rank = torch.arange(Q * V, device=device) - src_starts[bs]
    slot = pad_starts[bs] + rank
    qidx = torch.full((n_pairs * qtile,), -1, dtype=torch.int32, device=device)
    qidx[slot[valid_sorted]] = (order[valid_sorted] // V).to(torch.int32)
    pair_rows = torch.full((Q * V,), -1, dtype=torch.int64, device=device)
    pair_rows[order] = torch.where(valid_sorted, slot, -1)
    pair_bucket = torch.searchsorted(
        tile_end, torch.arange(n_pairs, device=device), right=True
    ).to(torch.int32)
    return ScanPlan(qidx, pair_bucket, pair_rows)


def gather_mode_is_kernel() -> bool:
    """``LMI_GATHER_MODE=kernel`` turns the gather kernel on."""
    return os.environ.get("LMI_GATHER_MODE", "auto") == "kernel"


def scan_inputs(
    store: BucketStore,
    queries: torch.Tensor,
    bucket_order: torch.Tensor,
    qtile: int,
    mode: str,
) -> Tuple[ScanPlan, tuple]:
    """The plan of ``queries`` (Q, d) f32 visiting ``bucket_order`` and the
    positional arguments of ``ops.scan_kernel.scan_pairs`` for it (over a
    virtual store: its corpus, row scales and flat id grid as the row
    map).

    The scan reads each padded slot's query row through ``qidx``; no
    work-query rows are materialized (the JAX package gathers them only
    because a Pallas ``BlockSpec`` needs a dense tile).  Each bucket's
    chunks come from :meth:`BucketStore.chunk_list` (``ptr`` and
    ``chunk_of``), as the JAX package's ``scan_buckets_device`` reads
    them.  ``int8``
    quantizes the Q query rows once: per-row quantization commutes with
    the per-slot gather, so the bits are those of gather-then-quantize."""
    device = store.device
    plan = build_plan(bucket_order.to(device), store.n_buckets, qtile)
    qscales = None
    if mode == "int8":
        queries, qscales = quantize.quantize_rows(queries)
    ptr, chunk_of = store.chunk_list()
    if store.bucket_chunk_list is None:  # the identity, made where it is read
        chunk_of = torch.arange(len(chunk_of), dtype=torch.int32, device=device)
    args = (
        queries, plan.qidx, plan.pair_bucket,
        torch.as_tensor(ptr.astype(np.int32), device=device),
        torch.as_tensor(chunk_of, dtype=torch.int32, device=device),
    )
    if store.virtual:
        args += (store.data_ref, store.row_scales, qscales, store.chunk_ids.reshape(-1))
    else:
        args += (store.chunk_data, store.scales_flat(), qscales, None)
    return plan, args


def merge_pairs(
    cand_d: torch.Tensor,  # (n_pairs·qtile, k) per-pair candidate distances
    cand_s: torch.Tensor,  # (n_pairs·qtile, k) candidate slots, -1 = none
    pair_rows: torch.Tensor,  # (Q·V,) row of each (query, visit), -1 = none
    *,
    k: int,
    V: int,
    gather_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query has at most ``V`` candidate rows (one per visited
    bucket), so its top-``k`` is one dense (Q, V·k) selection.  Ties go
    to the earlier visit, then the earlier candidate.  ``gather_kernel``
    gathers the candidate rows with one ``gather_pairs`` launch; else
    torch indexing (its plain version) does."""
    gather = gather_pairs if gather_kernel else gather_pairs_reference
    with span("lmi.merge"):
        d, s = gather(cand_d, cand_s, pair_rows, V)
        vals, pos = smallest_k(d, k)
        out_s = torch.gather(s, 1, pos)
        return vals, torch.where(torch.isinf(vals), -1, out_s)


@full_f32()
def rerank_exact_slots(
    cand_s: torch.Tensor,  # (Q, kk) slots, -1 = none
    queries: torch.Tensor,  # (Q, d) f32
    chunk_data: torch.Tensor,  # (n_slots, d); a virtual store's (n, d) corpus
    scales_flat: Optional[torch.Tensor],  # (n_slots,) f32; a virtual store's (n,) or None
    *,
    k: int,
    row_ids: Optional[torch.Tensor] = None,  # (n_slots,) id grid of a virtual store
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact f32 distances for the shortlist, straight from the packed
    slabs (or the corpus rows of a virtual store, slot ``s`` reading row
    ``row_ids[s] - 1``, as the JAX package's virtual rerank reads
    ``data_ref[ids - 1]``), then the top ``k``."""
    rows = torch.clamp_min(cand_s, 0).long()
    if row_ids is not None:
        rows = (row_ids[rows].long() - 1).clamp_min(0)
    vecs = chunk_data[rows].float()  # (Q, kk, d)
    if scales_flat is not None:
        vecs = vecs * scales_flat[rows][:, :, None]
    sims = torch.bmm(vecs, queries[:, :, None])[:, :, 0]
    dists = torch.where(cand_s >= 0, 1.0 - sims, torch.inf)
    out_d, pos = smallest_k(dists, k)
    out_s = torch.gather(cand_s, 1, pos)
    return out_d, torch.where(torch.isinf(out_d), -1, out_s)


def scan_buckets_device(
    store: BucketStore,
    queries: torch.Tensor,  # (Q, d) f32 on the store's device
    bucket_order: torch.Tensor,  # (Q, V) int, -1 = unused visit
    k: int = 10,
    *,
    qtile: int = 128,
    precision: str = "default",
    rerank: bool = True,
    rerank_margin: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``k`` over each query's visited buckets → ``(dists (Q, k)
    f32, ids (Q, k) int32 1-based, 0 = none)`` on the store's device.

    ``precision``: ``"default"`` scans with bf16-rounded operands,
    ``"highest"`` in full f32, ``"int8"`` with per-row int8 queries
    against an int8 store (int32 sums).  With ``rerank`` the scan keeps
    ``k + rerank_margin`` candidates and the final ranking is exact f32
    over that shortlist."""
    mode = {"highest": "f32", "int8": "int8"}.get(precision, "bf16")
    if mode == "int8" and (store.virtual or store.chunk_data.dtype != torch.int8):
        raise ValueError(
            "precision='int8' runs the int8×int8 bulk scan and needs a "
            "packed int8 store (build_packed_int8 / build_packed_device "
            "with row_scales); this store is "
            + ("virtual" if store.virtual else str(store.chunk_data.dtype))
        )
    k_scan = k + rerank_margin if rerank else k
    # a query's results do not depend on its tile (ties go to the earlier
    # row, then the earlier visit), so larger tiles plan as the kernel's
    qtile = min(qtile, MAX_QTILE)
    with span("lmi.plan"):
        plan, args = scan_inputs(store, queries, bucket_order, qtile, mode)
    if plan.n_pairs == 0:  # no query visits a bucket with rows: nothing to scan
        Q = queries.shape[0]
        return (torch.full((Q, k), torch.inf, device=store.device),
                torch.zeros((Q, k), dtype=torch.int32, device=store.device))
    with span("lmi.scan"):
        cand_d, cand_s = scan_pairs(*args, k=k_scan, qtile=qtile, chunk=store.chunk, mode=mode)
    V = bucket_order.shape[1]
    dists, slots = merge_pairs(
        cand_d.reshape(-1, k_scan), cand_s.reshape(-1, k_scan), plan.pair_rows,
        k=k_scan, V=V, gather_kernel=gather_mode_is_kernel(),
    )
    if rerank:
        with span("lmi.rerank"):
            if store.virtual:
                dists, slots = rerank_exact_slots(
                    slots, queries, store.data_ref, store.row_scales, k=k,
                    row_ids=store.chunk_ids.reshape(-1),
                )
            else:
                dists, slots = rerank_exact_slots(
                    slots, queries, store.chunk_data, store.scales_flat(), k=k
                )
    with span("lmi.resolve"):
        ids_flat = store.chunk_ids.reshape(-1)
        ids = torch.where(slots >= 0, ids_flat[torch.clamp_min(slots, 0).long()], 0)
    return dists, ids


def scan_buckets(
    store: BucketStore,
    queries: np.ndarray,
    bucket_order: np.ndarray,
    k: int = 10,
    qtile: int = 128,
    items_per_step: Optional[int] = None,
    precision: str = "highest",
    approx_recall=None,
    rerank: bool = False,
    rerank_margin: int = 6,
    engine: str = "auto",
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact kNN over each query's visit set, host arrays in and out (the
    JAX package's ``scan_buckets``): ``(dists (Q, k) f32, ids (Q, k)
    uint32 1-based, 0 = none)``.  A thin wrapper of
    :func:`scan_buckets_device` on the store's device; ``items_per_step``,
    ``approx_recall`` and ``engine`` are taken for the JAX signature and
    unused (every scan is the CUDA kernel on a GPU, its plain version on
    the CPU, exact per visited bucket)."""
    device = store.device
    if isinstance(queries, torch.Tensor):
        q = queries.to(device=device, dtype=torch.float32).contiguous()
    else:
        q = torch.as_tensor(np.ascontiguousarray(queries, dtype=np.float32)).to(device)
    order = torch.as_tensor(np.asarray(bucket_order, dtype=np.int64)).to(device)
    with torch.no_grad():
        dists, ids = scan_buckets_device(store, q, order, k, qtile=qtile, precision=precision,
                                         rerank=rerank, rerank_margin=rerank_margin)
    return dists.cpu().numpy(), ids.cpu().numpy().astype(np.uint32)
