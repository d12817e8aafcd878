"""Bucket-sharded search over a list of devices (counterpart of
``learnedmetricindex_tpu/parallel/sharded_index.py``).

* **Bucket sharding.**  Leaf buckets are assigned to devices by size
  (the biggest bucket to the lightest device, as the JAX package does),
  and each device holds a self-contained packed sub-store of its
  buckets: their chunk slabs in the corpus's type, the id grid (global
  1-based ids) and, for an int8 corpus, the scales.
* **Local scans, one merge.**  A search runs each shard's own plan, one
  ``scan_pairs`` launch, the dense merge and, with ``rerank``, the exact
  rerank on the shard's slabs, all on the shard's device; the shards'
  ``(Q, k)`` results then move to the first device, side by side in
  device order, and one smallest-``k`` (ties to the lower device, as
  ``lax.top_k`` breaks them) is the answer.

The JAX package runs this as one ``shard_map`` program over a ``Mesh``
and stacks the sub-stores on a leading device axis padded to the widest
one; the port runs it from one process over ``devices`` and keeps each
sub-store at its own size.  ``devices`` may repeat a device: on one GPU
(or the CPU) the shards run there in turn, which checks the sharded
path's results but measures nothing about spreading the scan.

**Across ranks** (``devices`` a ``parallel.multiprocess.World``, the
corpus ``multiprocess.from_process_local``'s rows) each rank holds one
shard, its own.  The fill is routed (the JAX package's
``_fill_from_sharded_corpus``): every rank derives the same bucket
assignment and every shard's slot layout from the replicated
``bucket_ids``, and the slots are exchanged in blocks of bounded bytes,
one ``all_to_all`` a block sending each local row (with its scale, for
int8) to the rank owning its slot, straight into that rank's shard.  A search
scans this rank's shard, one ``all_gather`` brings every rank's ``(Q,
k)`` results in rank order, and the same smallest-``k`` runs on every
rank, so every rank returns the same answer.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch import native
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_buckets_device
from learnedmetricindex_tpu_torch.ops.select import smallest_k
from learnedmetricindex_tpu_torch.parallel import multiprocess as mp


class ShardedStore(NamedTuple):
    """One packed :class:`BucketStore` per device, over its own buckets
    (local bucket ids, global object ids).  Across the ranks of a
    ``world`` a rank holds only its own shard: ``shards`` and ``devices``
    then have one entry, shard ``world.rank`` of ``bucket_device``."""

    shards: List[BucketStore]
    bucket_device: np.ndarray  # (n_buckets,) int32 shard owning each bucket
    bucket_local: np.ndarray  # (n_buckets,) int32 the bucket's index in its shard
    devices: List[torch.device]
    chunk: int
    world: Optional["mp.World"] = None

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_device)

    @property
    def n_chunks(self) -> int:
        """The widest shard's chunk count (the serving layer's capacity
        stat, name-compatible with :class:`BucketStore`)."""
        return max(s.n_chunks for s in self.shards)

    @property
    def device(self) -> torch.device:
        """Where a search's results are merged: the first device."""
        return self.devices[0]

    @property
    def dim(self) -> int:
        return self.shards[0].dim

    def nbytes(self) -> int:
        """Bytes of the shards' device arrays (this rank's shard across ranks)."""
        return sum(s.nbytes() for s in self.shards)

    def nbytes_device_arrays(self) -> int:
        """The JAX package's name for :meth:`nbytes`."""
        return self.nbytes()


def _assign(counts: np.ndarray, n_dev: int) -> Tuple[np.ndarray, np.ndarray, List[np.ndarray]]:
    """Balanced assignment (biggest bucket first, to the lightest device;
    the JAX package's order): ``(bucket_device, bucket_local, the global
    buckets of each device in ascending order)``."""
    order = np.argsort(-np.asarray(counts), kind="stable")
    load = np.zeros(n_dev, dtype=np.int64)
    bucket_device = np.zeros(len(counts), dtype=np.int32)
    for b in order:
        dev = int(np.argmin(load))
        bucket_device[b] = dev
        load[dev] += counts[b]
    bucket_local = np.zeros(len(counts), dtype=np.int32)
    mine = []
    for dev in range(n_dev):
        own = np.nonzero(bucket_device == dev)[0]
        bucket_local[own] = np.arange(len(own))
        mine.append(own)
    return bucket_device, bucket_local, mine


def _devices(devices: Sequence) -> List[torch.device]:
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("a sharded store needs at least one device")
    return devices


def shard_store(
    data,
    bucket_ids: np.ndarray,
    n_buckets: int,
    devices: Sequence,
    chunk: int = 256,
    row_scales=None,
) -> ShardedStore:
    """Partition buckets over ``devices`` (balanced by size) and build one
    packed sub-store per device, in the corpus's type (int8 stays int8,
    with ``row_scales`` the per-row scales; a float64 host array is
    stored as f32).

    ``data`` may be a host array or a tensor.  A tensor is never copied
    through the host: each shard's slabs are gathered on the corpus's
    device and copied to the shard's device, one batch of slabs at a
    time.  Over a ``multiprocess.World`` ``data`` is this rank's
    ``RankRows`` and the fill is routed (:func:`_routed_shard`)."""
    bucket_ids = np.asarray(bucket_ids)
    counts = native.bincount(bucket_ids, n_buckets)
    if isinstance(devices, mp.World):
        bucket_device, bucket_local, mine = _assign(counts, devices.size)
        shard = _routed_shard(data, bucket_ids, bucket_device, bucket_local, mine, devices, chunk)
        return ShardedStore([shard], bucket_device, bucket_local, [devices.device], chunk, devices)
    devices = _devices(devices)
    bucket_device, bucket_local, mine = _assign(counts, len(devices))
    if isinstance(data, torch.Tensor):
        source = data
    else:
        data = np.asarray(data)
        if data.dtype not in (np.float32, np.int8):
            data = data.astype(np.float32)
        source = torch.from_numpy(np.ascontiguousarray(data))
    scales = None
    if row_scales is not None:
        scales = torch.as_tensor(row_scales if isinstance(row_scales, torch.Tensor)
                                 else np.asarray(row_scales, np.float32))
    shard_of_row = bucket_device[bucket_ids]
    shards = []
    for i, dev in enumerate(devices):
        rows = np.nonzero(shard_of_row == i)[0]
        st = BucketStore.build_packed_device(
            source, bucket_local[bucket_ids[rows]], len(mine[i]), chunk=chunk,
            row_scales=scales, object_ids=rows + 1, device=dev)
        shards.append(st._replace(row_slot=None))
    return ShardedStore(shards, bucket_device, bucket_local, devices, chunk)


#: the routed fill's transient bytes a rank sends in one exchange (the
#: JAX package's ``_fill_from_sharded_corpus`` bounds its slot blocks so)
ROUTED_BLOCK_BYTES = 128 << 20


def _routed_shard(rows, bucket_ids, bucket_device, bucket_local, mine, world, chunk):
    """This rank's shard, filled from a corpus split over the ranks
    (``RankRows``; ``bucket_ids`` the same on every rank).

    Every rank derives every shard's slot layout (the one
    :func:`shard_store` packs: the global row of each slot) from the
    replicated bucket ids.  The slots are then exchanged in blocks of
    ``B`` slots a shard: for block ``c`` each rank sends each rank ``r``
    the rows it holds of ``r``'s slots ``c·B .. (c+1)·B`` in slot order
    (an int8 row with its scale's four bytes beside it), one
    ``all_to_all`` a block, and writes what it receives into its own
    slots.  A rank sends at most ``W·B`` rows an exchange,
    :data:`ROUTED_BLOCK_BYTES`, so the device holds the rank's rows, its
    shard and one exchange.  The slots, their rows and their ids are
    :func:`shard_store`'s, so the sub-store is bit-equal to its shard
    ``world.rank``."""
    from learnedmetricindex_tpu_torch.index.bucket_store import _host_layout

    me, W, dev = world.rank, world.size, world.device
    shard_of_row = bucket_device[bucket_ids]
    slot_row = []  # each shard's global row per slot, -1 = padding
    for r in range(W):
        glob = np.nonzero(shard_of_row == r)[0]
        slots, starts, counts = _host_layout(bucket_local[bucket_ids[glob]], len(mine[r]), chunk)
        slot_row.append(np.where(slots >= 0, glob[np.maximum(slots, 0)] if len(glob) else -1, -1))
        if r == me:
            layout = (starts, counts)
    lo, (m, d) = rows.lo, rows.block.shape
    width = d * rows.block.element_size()
    source = rows.block.contiguous().view(torch.uint8).reshape(m, width)
    if rows.scales is not None:
        source = (source, rows.scales.contiguous().view(torch.uint8).reshape(m, 4))
    n_slots = len(slot_row[me])
    data = torch.zeros((n_slots, d), dtype=rows.block.dtype, device=dev)
    scales = (None if rows.scales is None
              else torch.zeros(n_slots, dtype=torch.float32, device=dev))
    step = max(chunk, ROUTED_BLOCK_BYTES // (W * (width + (0 if scales is None else 4))))
    for c0 in range(0, max(len(s) for s in slot_row), step):
        sends = [g[(g >= lo) & (g < lo + m)] - lo for g in (s[c0:c0 + step] for s in slot_row)]
        g = slot_row[me][c0:c0 + step]
        live = np.nonzero(g >= 0)[0]
        holder = np.searchsorted(rows.starts, g[live], side="right") - 1
        at = torch.as_tensor(c0 + live[np.argsort(holder, kind="stable")], device=dev)
        idx = torch.as_tensor(np.concatenate(sends), device=dev)
        send = source[idx] if scales is None else torch.cat([source[0][idx], source[1][idx]], 1)
        got = mp.all_to_all(send, [len(x) for x in sends], np.bincount(holder, minlength=W),
                            world)
        del send
        data[at] = got[:, :width].contiguous().view(data.dtype)
        if scales is not None:
            scales[at] = got[:, width:].contiguous().view(torch.float32).reshape(-1)
    ids = np.where(slot_row[me] >= 0, slot_row[me] + 1, 0).astype(np.int32)
    return BucketStore(
        chunk_ids=torch.as_tensor(ids.reshape(-1, chunk), device=dev),
        bucket_chunk_start=layout[0],
        bucket_sizes=layout[1].astype(np.int32),
        chunk=chunk,
        n_buckets=len(mine[me]),
        chunk_data=data,
        chunk_scales=scales,
    )


def shard_packed_store(store: BucketStore, devices: Sequence) -> ShardedStore:
    """A packed store spread over ``devices`` without a trip through the
    host: each device's sub-store is one chunk-level gather on the
    store's device, copied over.  A bucket's chunks (its chunk list in a
    mutated store, delete holes included) keep their scan order, so
    searches return the same neighbours.  A mutated store's per-bucket
    fill travels with it."""
    if store.virtual:
        raise ValueError(
            "shard_packed_store needs a packed store (virtual stores "
            "reference a row-major corpus — use shard_store on it)"
        )
    devices = _devices(devices)
    counts = np.asarray(store.bucket_sizes, np.int64)
    chunk, d = store.chunk, store.dim
    ptr, clist = store.chunk_list()
    nchunks = np.diff(ptr)
    bucket_device, bucket_local, mine = _assign(counts, len(devices))
    fill = store.bucket_fill if store.bucket_fill is not None else store.bucket_sizes
    src_data = store.chunk_data.view(store.n_chunks, chunk, d)
    src_scales = (None if store.chunk_scales is None
                  else store.chunk_scales.view(store.n_chunks, chunk))
    shards = []
    for own, dev in zip(mine, devices):
        sel = np.concatenate([clist[ptr[b]:ptr[b + 1]] for b in own] or [np.empty(0, np.int32)])
        sel_t = torch.as_tensor(sel.astype(np.int64), device=store.device)
        starts = np.concatenate([[0], np.cumsum(nchunks[own])]).astype(np.int32)
        shards.append(BucketStore(
            chunk_data=src_data.index_select(0, sel_t).reshape(-1, d).to(dev),
            chunk_ids=store.chunk_ids.index_select(0, sel_t).to(dev),
            chunk_scales=(None if src_scales is None
                          else src_scales.index_select(0, sel_t).reshape(-1).to(dev)),
            bucket_chunk_start=starts,
            bucket_sizes=counts[own].astype(np.int32),
            chunk=chunk,
            n_buckets=len(own),
            bucket_chunk_ptr=starts.astype(np.int64),
            bucket_chunk_list=np.arange(int(starts[-1]), dtype=np.int32),
            bucket_fill=np.asarray(fill, np.int32)[own],
        ))
    return ShardedStore(shards, bucket_device, bucket_local, devices, chunk)


def sharded_search(
    sharded: ShardedStore,
    queries,
    bucket_order,
    k: int = 10,
    qtile: int = 128,
    precision: str = "highest",
    engine: str = "auto",
    rerank: bool = False,
    rerank_margin: int = 6,
) -> Tuple[np.ndarray, np.ndarray]:
    """Search the sharded store: per shard its plan, one scan launch, the
    dense merge and (``rerank``) the exact rerank over its own slabs,
    then one smallest-``k`` over the shards' results on the first
    device.  Returns ``(dists (Q, k) f32, ids (Q, k) uint32 1-based, 0 =
    none)`` as numpy.

    ``bucket_order``: (Q, V) global bucket ids, -1 = unused visit.
    ``qtile``: the scan's query tile (the JAX package's default of 16
    suits its TPU kernel; the CUDA kernel computes 128-query tiles,
    and results do not depend on the tile).
    ``precision``: "highest" (f32 scan) or "default" (bf16 operands);
    ``rerank=True`` keeps ``k + rerank_margin`` candidates a shard and
    ranks them in exact f32 before the merge, so the merged ranking is
    exact over the union of the shards' shortlists.
    ``engine``: taken for the JAX package's signature and unused (every
    scan is the CUDA kernel on a GPU, its plain version on the CPU).

    Across ranks every rank passes the same queries and bucket order,
    scans its own shard, and one ``all_gather`` brings every rank's
    results (distances and ids side by side, as bits) in rank order to
    every rank, which merges them as above."""
    if precision not in ("highest", "default"):
        raise ValueError(
            "sharded_search supports precision='highest' or 'default'; "
            f"got {precision!r}"
        )
    order = bucket_order if isinstance(bucket_order, torch.Tensor) else torch.as_tensor(
        np.asarray(bucket_order))
    order = order.long()
    q_host = queries if isinstance(queries, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(queries, dtype=np.float32))
    home = sharded.devices[0]
    valid = order >= 0
    at = order.clamp_min(0)
    owner = torch.as_tensor(sharded.bucket_device, device=order.device)[at]
    local = torch.as_tensor(sharded.bucket_local, device=order.device)[at]
    on_device = {}  # the queries, once per device
    dists, ids = [], []
    world = sharded.world
    with torch.no_grad():
        owners = range(len(sharded.shards)) if world is None else [world.rank]
        for i, shard, dev in zip(owners, sharded.shards, sharded.devices):
            if dev not in on_device:
                on_device[dev] = q_host.to(device=dev, dtype=torch.float32).contiguous()
            local_order = torch.where(valid & (owner == i), local, -1).to(dev)
            d_i, i_i = scan_buckets_device(
                shard, on_device[dev], local_order, k=k, qtile=qtile, precision=precision,
                rerank=rerank, rerank_margin=rerank_margin)
            dists.append(d_i.to(home))
            ids.append(i_i.to(home))
        if world is not None:
            pair = torch.cat([dists[0].contiguous().view(torch.int32), ids[0].to(torch.int32)], 1)
            every = mp.all_gather(pair, world)
            dists = [p[:, :k].contiguous().view(torch.float32) for p in every]
            ids = [p[:, k:] for p in every]
        all_d, all_i = torch.cat(dists, 1), torch.cat(ids, 1)
        vals, pos = smallest_k(all_d, k)
        out_i = torch.where(torch.isinf(vals), 0, torch.gather(all_i, 1, pos))
    return vals.cpu().numpy(), out_i.cpu().numpy().astype(np.uint32)
