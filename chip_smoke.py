#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N]

Drives ``learnedmetricindex_tpu_torch`` through its public entry points
at the reference's flagship configuration — 120 buckets, MLP-4, a
10M×768 int8 packed store, 10k queries visiting 4 buckets, k=10 — in
phases:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles ``csrc/scan_pairs.cu``, ``csrc/scan_merge.cu`` and
   ``csrc/gather_rows.cu`` with nvcc for sm_90a, all at once, and prints
   each kernel instance's registers and spills;
3. kernel vs plain: the scan kernel against its plain PyTorch version on
   the card at d 768, 96 and 100, all three modes over every store type
   they take, k 16 to 600 (every list width, 32 to 1024), qtile
   1/8/100/128, with duplicated rows whose exact ties must go to the
   earlier row in the bucket's scan order; at d 768 also over the same
   stores after inserts (pool chunks, growth) and deletes, their chunk
   lists out of physical order (list widths 32 and 64); f32 over int8
   and bf16 stores also on rows of one power of two, where each distance
   needs all three bf16 terms of a query;
   then the row-map mode (virtual stores over f32, bf16 and int8 +
   row-scale corpora, rows read through the id grid) in modes bf16, f32
   and int8 at k 16/128/1024, also with the chunk lists out of physical
   order, and k past the widest list (1030, 2100: rounds of at most
   1024, one launch a round, no slot listed twice) over mutated int8 and
   f32 stores and a virtual bf16 store; then rows that all tie (one row
   a bucket, padding slots, chunk lists out of physical order) at list
   widths 64, 256 and 1024 and k 1100 in every mode over every store
   type, each list the bucket's first rows in scan order, and pairs
   whose split blocks are all padding but one; then the scan's split
   forced to segments of 1 and 2 chunks (every mode over every store
   type at list widths 32 to 1024, mutated and virtual stores, k 1100
   in rounds under floors): the scan kernel over the items and the merge
   kernel bit-equal to the scan kernel over whole buckets, and within the
   bar of the plain version (every other case runs the wrapper's own
   split); then bf16 and f32 over the int8 and the f32 store and int8
   over the int8 store at list width 32, the default, ``highest`` and
   ``int8`` searches' scans and their five wgmma bodies, at k 16 and 32
   and qtile 1/8/100/128 (chunks of 320 and 130 rows, the stores mutated,
   forced segments; the widest resident query tiles, d 1152 of bf16 over
   int8 rows, 1664 of int8 queries, 896 over f32 rows and of f32 over int8
   and f32 rows), int8 over the int8 store at k 33 and at the widest
   tiles of its wide-list body (d 1408 at list width 64, 896 at 128), f32
   over the int8 store at k 33, 64 and 106 (its wide-list body, d 752
   rounded up to its widest tile, 768), bf16 over the f32 store at k 33,
   64 and 106 (its wide-list body, d 752 and 100), and the launches there
   that keep
   the mma.sync body (virtual stores of an f32 corpus, int8 queries and f32
   at k 64 over a virtual store of an int8 corpus,
   int8 rows of 100 bytes, int8 at k 64 and 106 past that body's widest
   tiles, f32 over int8 rows of 100 bytes at k 64 and past its wide-list
   body's widest tile (d 784 at k 64, 896 at 106), bf16 over f32 rows past
   the wide body's widest tile (d 800 at k 64, 772 at 106) and of 408
   bytes at k 64, d 900 and 102 over f32
   rows, f32 over int8 rows at d 1040, f32 over f32 rows at k 33, k 1040
   in rounds under floors), each case naming the body its launches took;
4. corpus: a seeded 10M×768 int8 corpus (+ f32 row scales) on the
   device and the exact f32 top-10 of the queries;
5. search path: an index whose MLP-4 encodes a nearest-centroid
   partition exactly, .npz round trip, packed store, timed searches and
   checks against exact kNN restricted to each query's visited buckets;
   then, at the flagship shape, the scan kernel, its plain version and
   the library yardstick (per bucket one matmul + ``torch.topk``) timed
   with CUDA events beside the least time the card could take (bound),
   each with the body and the split the wrapper chose (slots, segment
   length, items; each default search is one launch of the wgmma body,
   the ``highest`` search one of the f32-mode wgmma body, its recall
   against exact kNN over the visited buckets equal to the same search's
   through the scan's plain version; the ``int8`` search one launch of the
   int8 wgmma body, its recall equal to the same search's through the
   scan's plain version and its results bit-equal to it, timed; the
   ``int8`` ``search(k=100)`` one launch of the int8 wgmma body with wide
   lists at ``k_scan`` 106, its results bit-equal to the same search's
   through the scan's plain version and its recall@100 equal to that
   search's, timed; each default ``search(k=100)`` one launch of
   the wide-list wgmma body at ``k_scan`` 106, timed, its recall@100
   against exact kNN over the visited buckets at least 0.999 and within
   0.001 of the same search's through the scan's plain version, timed
   beside it; the ``highest`` ``search(k=100)`` one launch of the f32-mode
   wgmma body with wide lists at ``k_scan`` 106, timed, equal to exact kNN
   over the visited buckets (ids differing only at ties) and its
   recall@100 equal to the same search's through the scan's plain
   version),
   the merge kernel (``merge_case``) where pairs split: at the hand-set
   index's first 1,024 queries (k_scan 16, and 106: its lists staged in
   shared memory) and at the flagship plan
   with segments forced to 20 chunks (and, over the f32 store below, at
   ``k_scan`` 106 in f32), each against its plain version and
   ``smallest_k`` over the lists side by side, its bytes bound and its
   share of the scan at that shape, and at the flagship's own plan, where
   no pair splits, the scan launch checked to merge nothing; the split's
   host work a launch,
   the f32 kernel's and plain version's distances against float64 (the
   kernel's error may not exceed the plain version's), the same at
   ``k_scan`` 106 (``search(k=100)``, list width 128; the library call's
   ``topk(106)``) and, in int8 and f32, at 64 (list width 64; in f32 both
   wide scans against float64 too), and
   the search's split between navigation, the scan and the rest; then
   the same rows dequantized into an f32 store (31 GB): the scan in f32
   over it (six products a k-step: the six-term wgmma body at ``k_scan``
   16, the mma.sync body at 106) at ``k_scan`` 16 and 106 against its plain
   version, cuBLAS SGEMM + ``torch.topk`` (TF32 off) and its bound (six
   bf16 passes, the CUDA cores' FMA route beside it), at 16 both against
   float64; the scan in bf16 over it at 106 and 64 (the wgmma body over
   f32 rows with wide lists: the default ``search(k=100)`` over
   ``BuildConfiguration(dtype="float32")``) and at 16 (the wgmma body over
   f32 rows: its default search) beside its plain version, the library
   call and the bound, with the bytes read if each pair or each block read
   its bucket once, and the peak device memory of those scans; whole
   ``search(precision="highest")`` and default searches over that store at
   k 10 and a default ``search(k=100)``, the first equal to exact kNN over
   the visited buckets and of the same recall as the search through the
   scan's plain version, each one launch of the six-term wgmma body, each
   default search one launch of the wgmma body over f32 rows (at k 100
   with wide lists), held to the same search through the scan's plain
   version at the bf16 bar, both recalls printed;
   then the same index over a virtual store of the device corpus
   (``get_bucket_store``: the id grid, no copy): default and ``highest``
   searches equal to the packed store's, each one launch of the row-map
   wgmma bodies (bf16, f32), a ``k=1100`` search equal to exact kNN over
   the visited buckets (its rounds on the mma.sync body), the store's
   bytes and the peak device memory while each store is made and over
   the phase, and the row-map scans at k_scan 16 in bf16 and f32 beside
   the packed scans (their lists bit-equal), their plain versions, the
   library calls and the bounds, and the ``k=1100`` search's scan alone
   (k_scan 16, the 1024-wide round, k_scan 1106) beside its plain version,
   the library call and the bound;
   then the store sharded by bucket over ``[cuda:0] * 4`` (from the
   device corpus, and from the packed store): a visit-4 default search
   equal to the single store's, one scan launch a shard, each shard's
   rows and scan time;
6. build path: ``LearnedIndexBuilder`` at the bench's flagship
   configuration (1 level, 120 buckets, 4 epochs, batch 1024, lr 0.01,
   balanced class weights, seed 2023), save, load, packed store, search
   with ``LMI_GATHER_MODE=auto`` and ``=kernel`` (bit-identical) in warm,
   alternating rounds; the gather split (the first kernel-mode call, and
   by CUDA events what gathering the work queries as rows would cost the
   scan, ``operand_queries`` and the merge, and each gather's host time
   a call); the merge gather kernel and the row gather kernel against
   their plain versions and ``index_select`` at the path's shapes; then
   the 2-level [10, 10] index searched best-first at visits 1-8;
7. dynamic path: the 1-level built index and its store as a
   ``DynamicIndex`` (no copy): 500,000 inserted rows in one batch (pool
   chunks, a growth), 64 inserts of 64 rows, 250,000 deletes, each timed,
   with the peak device memory; searches of the mutated store at the
   default precision and ``highest`` (gather modes in turns) held to
   exact kNN over the visited buckets, no deleted id returned, inserted
   rows finding themselves; the scan kernel against its plain version
   on the mutated plan; compaction with bit-identical search output and
   no kernel built anew; one serving dispatch's plan (1,024 queries) with
   the merge kernel at it (``merge_case``, the kernels line's
   ``scan_merge`` row); ``SearchServer`` with 16 clients of 64 queries
   for ~10 s while a thread inserts and deletes (latency p50/p95, QPS,
   batches against requests); one call to each HTTP endpoint;
   then the multi-device phase, part (b): that mutated store promoted to
   four shards on ``[cuda:0] * 4`` (``shard_packed_store`` and a
   ``ShardedDynamicIndex`` with its ``next_id``): 500,000 inserts, 64
   inserts of 64 rows, 250,000 deletes and a compaction, each followed by
   a visit-4 search of the 10k queries held to exact kNN over the
   visited buckets (one scan launch a shard, no deleted id, compaction
   bit-identical, no kernel built anew), then ``SearchServer`` over it
   with 16 clients and a mutator for ~5 s (``[sharded-dynamic]`` lines);
8. experiment driver: the flagship index and corpus freed, the CLI
   (``cli.sweep``, and the result files where h5py imports) at
   ``--synthetic 1000000 --synthetic-dim 768``, 120 buckets, MLP-4, 4
   epochs, batch 1024, chunk 2048, ``-b 1 2 4 8 120``, at its default f32
   store (every scan of the sweep on the wgmma body over f32 rows), then
   ``--index-type baseline`` at the same flags as the ground truth: each
   visit count
   exact over its visited buckets, recall not falling as visits rise and
   ≥ 0.999 at every bucket; one search under ``utils/profiling.
   device_trace``, its eight longest device operations and the device's
   busy share of the search;
9. the multi-device phase, part (a): the same sweep over ``[cuda:0] *
   4`` (``cli.sweep(..., devices=)``, the build over the device list and
   one store sharded over it) on the host data ``phase_cli`` drew, at
   ``--n-categories 120`` (sharded k-means, the root trained data
   parallel) and ``12 10`` (level 1 expert parallel, ``kmeans_nodes``
   over the devices): recall against the baseline, each visit count
   exact over its visited buckets, one scan launch a shard a search,
   the build's times and each shard's scan beside ``phase_cli``'s
   (``[multi]`` lines);
10. the multi-process phase: a child process of this script joins a
   world of one rank over NCCL (``parallel/multiprocess.py``:
   ``initialize`` from ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
   ``WORLD_SIZE``), takes ``phase_cli``'s host data through ``.npy``
   files as ``from_process_local`` rows, and at ``--n-categories 120``
   and ``12 10`` builds over the world, fills the store sharded over it
   through ``all_to_all`` exchanges of bounded bytes and searches it at
   each visit count: one scan launch and one ``all_gather`` a search,
   each visit count exact over its visited buckets, recall at 120
   buckets within 0.03 of ``phase_cli``'s, the rank's scan held to its
   plain version, the fill's peak within its shard and four exchanges;
   the build's, a step's and a warm search's seconds beside
   ``phase_cli``'s, the collectives' time by CUDA events, the fill's
   peak and the peak device memory (``[multi-process]`` lines).

Each path runs with the launch counts set to 0 just before it and read
just after; on every path the merges equal the scan launches that split
a pair (``scan_split``), and no other scan launch merges.  Any failure
raises (exit code 1).  Without CUDA it exits non-zero and prints no
result.  The last two lines are the kernels JSON
and the result JSON.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.data import BlobGenerator
from learnedmetricindex_tpu_torch.index import bucket_store as bucket_store_module
from learnedmetricindex_tpu_torch.index import mutation
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs
from learnedmetricindex_tpu_torch.index.serialization import index_from_arrays
from learnedmetricindex_tpu_torch.ops import cuda_build, gather_kernel, quantize, scan_kernel
from learnedmetricindex_tpu_torch.ops.knn import recall, restricted_knn
from learnedmetricindex_tpu_torch.ops.precision import full_f32
from learnedmetricindex_tpu_torch.ops.select import smallest_k

ROOT = Path(__file__).resolve().parent
WORK_DIR = ROOT / "build" / "chip_smoke"

# the scan kernel against its plain version: sorted candidate distances,
# and slot ids that may differ only where the distances are tied
RTOL, ATOL = 1e-4, 1e-5
TIE_RTOL, TIE_ATOL = 1e-6, 1e-7
# ... where "tied" for f32 sums of 768 products means within their
# rounding: the kernel (tensor-core sums of exact products) and cuBLAS
# add in other orders; the bf16 and f32 bodies differed from it by up to
# ~2e-6 on unit vectors (H100 runs); int8 sums are exact in both, so int8
# keeps the tight bar
FLOAT_TIE_ATOL = 5e-6
# two bf16 searches of one store through different scan bodies (their lists
# sum in other orders): distances within this, and this share of the sorted
# ids equal
BF16_ATOL, BF16_SAME_IDS = 3e-3, 0.99
# f32 queries against rows that each hold one power of two (split_terms_check):
# every product is exact, so the plain version's f32 matmul is exact, and a
# distance needs all three bf16 terms of its query value.  The kernel stays
# within this share of 1 + |dot| of it; the same queries without their lo
# terms must miss the bar, or the check could not tell the bodies apart
SPLIT_REL_ERR = 2.0**-20
REPLACES = "learnedmetricindex_tpu/ops/scan_kernel.py:325"
# read_counts' keys of the scan's launches on its eleven wgmma bodies (bf16
# over int8 rows, bf16 over f32 rows, f32 over int8 rows, bf16 over int8
# rows at list widths 64 and 128, f32 over f32 rows, int8 over int8 rows,
# int8 over int8 rows at list widths 64 and 128, f32 over int8 rows at
# list widths 64 and 128, bf16 over f32 rows at list widths 64 and 128,
# bf16 and f32 over a row map of an int8 corpus)
WGMMA_INT8, WGMMA_F32 = "scan_pairs wgmma body", "scan_pairs wgmma f32 body"
WGMMA_F32MODE = "scan_pairs wgmma f32-mode body"
WGMMA_WIDE = "scan_pairs wgmma wide-list body"
WGMMA_F32X = "scan_pairs wgmma six-term body"
WGMMA_S8 = "scan_pairs wgmma int8 body"
WGMMA_S8_WIDE = "scan_pairs wgmma int8 wide-list body"
WGMMA_F32MODE_WIDE = "scan_pairs wgmma f32-mode wide-list body"
WGMMA_F32_WIDE = "scan_pairs wgmma f32 wide-list body"
WGMMA_INT8_ROWMAP = "scan_pairs wgmma row-map body"
WGMMA_F32MODE_ROWMAP = "scan_pairs wgmma f32-mode row-map body"
# the widest resident query tiles of the row-map bodies (bf16: body 10, f32:
# body 11): WRing<RowMap<int8_t> | RowMap<F32Mode>>::MAX_QD in csrc/scan_pairs.cu
ROWMAP_MAX_QD = {"bf16": 896, "f32": 768}
KERNEL_SOURCE = "learnedmetricindex_tpu_torch/csrc/scan_pairs.cu"
# the merge of a split scan takes the place of the Pallas kernel's running
# top-k across a pair's chunks (its `insert`, carried in VMEM chunk to chunk)
MERGE_REPLACES = "learnedmetricindex_tpu/ops/scan_kernel.py:231"
MERGE_SOURCE = "learnedmetricindex_tpu_torch/csrc/scan_merge.cu"
GATHER_REPLACES = "learnedmetricindex_tpu/ops/gather_kernel.py:151"
GATHER_SOURCE = "learnedmetricindex_tpu_torch/csrc/gather_rows.cu"
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published device-memory rate
# published dense peaks of the H100 SXM at 700 W (operations/s): bf16 and
# int8 on the tensor cores, f32 on the CUDA cores.  The scan's bound takes
# the fastest exact form of its products on this card (scan_work): f32
# queries over an int8 or bf16 store are three bf16 terms whose products
# with the store's values are exact, so three bf16 passes; over an f32
# store both sides are three terms and the six products that reach f32
# precision are six bf16 passes (the CUDA cores' FMA route, 2 operations
# a multiply-add at the f32 rate, is printed beside it)
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
# warm searches per gather mode on the built index, the modes in turns
MODE_ROUNDS = 6
# calls enqueued back to back, without a sync, to read a wrapper's host time a call,
# in rounds that take the functions compared in turns
HOST_CALLS = 200
HOST_ROUNDS = 6
# GPU clock cycles the stream spins (torch.cuda._sleep) before a queued timing:
# ~50 ms at the H100's 1.98 GHz, longer than the host takes to enqueue the calls
# (enqueueing 50 calls of four launches can take more than 10 ms)
SPIN_CYCLES = 100_000_000


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warmup,
    from CUDA events around the whole run."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def queued_ms(fn, reps: int) -> float:
    """Device milliseconds of ``fn()`` with its launches waiting in the
    queue: the stream spins first, the host enqueues all ``reps`` calls
    meanwhile, and the events then time the kernels back to back rather
    than the host's rate of launching them (checked: the spin must still
    hold the stream when the last call is enqueued)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    check(not start.query(), "queued_ms: the spin ended before the calls were enqueued")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_candidates(kd, ks, rd, rs, mode: str, what: str) -> tuple:
    """Kernel (kd, ks) against plain (rd, rs), both ascending per query:
    int8 bit-equal (distances and slots), f32/bf16 within the bars with
    slots differing only inside the tie band.  Returns (largest finite
    |distance difference|, largest |difference| where slots differ)."""
    kd, ks, rd, rs = (t.cpu().numpy() for t in (kd, ks, rd, rs))
    check(np.array_equal(np.isinf(kd), np.isinf(rd)), f"{what}: filled entries differ")
    np.testing.assert_allclose(kd, rd, rtol=RTOL, atol=ATOL, err_msg=what)
    mism = ks != rs
    tie_gap = 0.0
    if mode == "int8":
        check(np.array_equal(kd.view(np.uint32), rd.view(np.uint32)) and not mism.any(),
              f"{what}: int8 must be bit-equal")
    elif mism.any():
        np.testing.assert_allclose(kd[mism], rd[mism], rtol=TIE_RTOL, atol=FLOAT_TIE_ATOL,
                                   err_msg=f"{what}: slots differ off ties")
        tie_gap = float(np.abs(kd[mism] - rd[mism]).max())
    fin = np.isfinite(rd)
    return (float(np.abs(kd[fin] - rd[fin]).max()) if fin.any() else 0.0), tie_gap


def scan_partner(store, copies) -> np.ndarray:
    """``partner[slot]``: for each group of object ids that hold one row
    (a row of ``copies``), every copy's slot mapped to the slot of the
    copy just before it in the bucket's scan order (-1 elsewhere).  In a
    fresh store scan order is slot order; in a mutated one a chunk taken
    from the pool may sit below the bucket's older chunks.  A virtual
    store's slots are found through its id grid."""
    _, position = store.chunk_owner()
    n_slots = store.n_chunks * store.chunk
    if store.row_slot is not None:
        row_slot = store.row_slot.cpu().numpy()
    else:
        ids = store.chunk_ids.reshape(-1).cpu().numpy()
        row_slot = np.zeros(int(ids.max()), np.int64)
        row_slot[ids[ids > 0] - 1] = np.nonzero(ids > 0)[0]
    slots = row_slot[np.asarray(copies) - 1].astype(np.int64)  # (groups, n_copies)
    pos = position[slots // store.chunk] * store.chunk + slots % store.chunk
    order = np.argsort(pos, axis=1)
    ranked = np.take_along_axis(slots, order, axis=1)
    partner = np.full(n_slots, -1, np.int64)
    partner[ranked[:, 1:].reshape(-1)] = ranked[:, :-1].reshape(-1)
    return partner


def distinct_slots(slots, what: str) -> None:
    """No slot is listed twice for one query (rounds of a wide k must
    neither repeat nor skip a row at their boundaries)."""
    flat = slots.reshape(-1, slots.shape[-1])
    s, _ = torch.sort(flat, dim=1)
    dup = (s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)
    check(not bool(dup.any()), f"{what}: a slot is listed twice for one query")


def earlier_duplicate_first(slots, partner, what: str) -> int:
    """Every list that holds the later copy of a duplicated row holds the
    earlier copy (``partner[later] = earlier``, from ``scan_partner``)
    before it: exact ties go to the earlier row in the bucket's scan
    order.  Returns how many later copies were checked."""
    flat = slots.reshape(-1, slots.shape[-1]).cpu().numpy()
    earlier = np.where(flat >= 0, partner[np.maximum(flat, 0)], -1)
    rows, cols = np.nonzero(earlier >= 0)
    for r, j in zip(rows, cols):
        check(bool((flat[r, :j] == earlier[r, j]).any()),
              f"{what}: slot {flat[r, j]} listed without its earlier copy {earlier[r, j]} before it")
    return len(rows)


def same_neighbors(da, ia, db, ib, what: str) -> int:
    """Two (Q, k) search results agree: distances to the bar, ids except
    where the f32 distances tie.  Returns how many ids differ at ties."""
    np.testing.assert_allclose(da, db, rtol=RTOL, atol=ATOL, err_msg=what)
    mism = ia != ib
    if mism.any():
        np.testing.assert_allclose(da[mism], db[mism], rtol=TIE_RTOL, atol=FLOAT_TIE_ATOL,
                                   err_msg=f"{what}: ids differ off ties")
    return int(mism.sum())


# ----------------------------------------------------------------------
# phases
# ----------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; nothing was run")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    log(smi)
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    built = cuda_build.build_many([scan_kernel.SOURCE, scan_kernel.MERGE_SOURCE,
                                   gather_kernel.SOURCE])
    for (path, seconds), src in zip(built, (KERNEL_SOURCE, MERGE_SOURCE, GATHER_SOURCE)):
        log(f"[build] {src} -> {path.relative_to(ROOT)} "
            f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)}) in {seconds:.1f} s")
        report = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
        if shutil.which("c++filt"):  # the kernel instances' template arguments
            report = subprocess.run(["c++filt"], input=report, capture_output=True, text=True,
                                    timeout=60).stdout
        for line in report.splitlines():
            # each instance's registers and spills, and any wgmma that ptxas serialized
            if any(w in line for w in ("entry function", "registers", "spill", "serialized")):
                log(f"[build]   {line.strip()}")
    log(f"[build] the three kernels, compiled in parallel: {time.perf_counter() - t0:.1f} s")


def reset_counts() -> None:
    scan_kernel.LAUNCHES = 0
    scan_kernel.WGMMA_LAUNCHES = 0
    scan_kernel.WGMMA_F32_LAUNCHES = 0
    scan_kernel.WGMMA_F32MODE_LAUNCHES = 0
    scan_kernel.WGMMA_WIDE_LAUNCHES = 0
    scan_kernel.WGMMA_F32X_LAUNCHES = 0
    scan_kernel.WGMMA_S8_LAUNCHES = 0
    scan_kernel.WGMMA_S8_WIDE_LAUNCHES = 0
    scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES = 0
    scan_kernel.WGMMA_F32_WIDE_LAUNCHES = 0
    scan_kernel.WGMMA_INT8_ROWMAP_LAUNCHES = 0
    scan_kernel.WGMMA_F32MODE_ROWMAP_LAUNCHES = 0
    scan_kernel.MERGE_LAUNCHES = 0
    scan_kernel.SPLIT_LAUNCHES = 0
    gather_kernel.LAUNCHES = 0
    gather_kernel.PAIR_LAUNCHES = 0


def read_counts() -> dict:
    """Launches a kernel; of the scan's, those of its eleven wgmma bodies
    (bf16 over int8 rows, bf16 over f32 rows, f32 over int8 rows, bf16 over
    int8 rows at list widths 64 and 128, f32 over f32 rows, int8 over int8
    rows, int8 over int8 rows at list widths 64 and 128, f32 over int8 rows
    at list widths 64 and 128, bf16 over f32 rows at list widths 64 and
    128, bf16 and f32 over a row map of an int8 corpus), the rest on the
    mma.sync body; ``scan_split``: the scan launches that split a pair, each
    with one merge."""
    bodies = body_launches()
    return {"scan_pairs": scan_kernel.LAUNCHES, "scan_merge": scan_kernel.MERGE_LAUNCHES,
            "scan_split": scan_kernel.SPLIT_LAUNCHES,
            "gather_pairs": gather_kernel.PAIR_LAUNCHES, "gather_rows": gather_kernel.LAUNCHES,
            WGMMA_INT8: bodies[1], WGMMA_F32: bodies[2], WGMMA_F32MODE: bodies[3],
            WGMMA_WIDE: bodies[4], WGMMA_F32X: bodies[5], WGMMA_S8: bodies[6],
            WGMMA_S8_WIDE: bodies[7], WGMMA_F32MODE_WIDE: bodies[8],
            WGMMA_F32_WIDE: bodies[9], WGMMA_INT8_ROWMAP: bodies[10],
            WGMMA_F32MODE_ROWMAP: bodies[11]}


def body_launches() -> dict:
    """The scan's launches so far on each wgmma body, by its number in
    ``scan_kernel.BODY_NAMES``."""
    others = {2: scan_kernel.WGMMA_F32_LAUNCHES, 3: scan_kernel.WGMMA_F32MODE_LAUNCHES,
              4: scan_kernel.WGMMA_WIDE_LAUNCHES, 5: scan_kernel.WGMMA_F32X_LAUNCHES,
              6: scan_kernel.WGMMA_S8_LAUNCHES, 7: scan_kernel.WGMMA_S8_WIDE_LAUNCHES,
              8: scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES, 9: scan_kernel.WGMMA_F32_WIDE_LAUNCHES,
              10: scan_kernel.WGMMA_INT8_ROWMAP_LAUNCHES,
              11: scan_kernel.WGMMA_F32MODE_ROWMAP_LAUNCHES}
    return {1: scan_kernel.WGMMA_LAUNCHES - sum(others.values()), **others}


def kv_stores(dev, d: int, seed: int = 7, chunk: int = 320):
    """A small multi-chunk store of each type at width ``d`` (an empty
    bucket, padding slots, chunk 320 by default: not a whole number of
    128-row tiles), 60 rows duplicated later in their own bucket, and 300
    queries visiting 3 buckets (the first 60 are the duplicated rows and
    visit their bucket; 20 leave their last visit unused).  Returns the
    stores, the queries, their visits, the chunk, the (60, 2) object ids
    of the duplicated rows and what ``mutate_kv_stores`` needs."""
    g = BlobGenerator(16, d, seed=seed, noise=0.45, device=dev)
    n, nb = 6000, 7
    data = g.rows(n)
    rng = np.random.default_rng(seed)
    bucket_ids = rng.integers(0, nb, size=n)
    bucket_ids[bucket_ids == 3] = 4  # bucket 3 empty
    src = rng.choice(n // 2, size=60, replace=False)
    dst = n // 2 + rng.choice(n // 2, size=60, replace=False)
    data[torch.as_tensor(dst, device=dev)] = data[torch.as_tensor(src, device=dev)]
    bucket_ids[dst] = bucket_ids[src]
    q_int, q_sc = quantize.quantize_rows(data)
    stores = {
        "f32": BucketStore.build_packed_device(data, bucket_ids, nb, chunk=chunk),
        "bf16": BucketStore.build_packed_device(data.bfloat16(), bucket_ids, nb, chunk=chunk),
        "int8": BucketStore.build_packed_device(q_int, bucket_ids, nb, chunk=chunk, row_scales=q_sc),
    }
    queries = g.rows(300)
    queries[:60] = data[torch.as_tensor(src, device=dev)]
    order = np.empty((300, 3), np.int64)
    for i in range(300):
        perm = rng.permutation(nb)
        if i < 60:
            perm = np.concatenate([[bucket_ids[src[i]]], perm[perm != bucket_ids[src[i]]]])
        order[i] = perm[:3]
    order = torch.as_tensor(order, device=dev)
    order[-20:, 2] = -1
    copies = np.stack([src + 1, dst + 1], axis=1)  # object ids of each duplicated row
    return stores, queries, order, chunk, copies, (g, data, bucket_ids, src)


def mutate_kv_stores(stores, copies, made, seed: int = 7):
    """The ``kv_stores`` stores after what serving does to a store: a third
    copy of each duplicated row inserted into its bucket, 2,000 new rows
    (the pool is empty, so the stores grow), 300 deletes of other rows;
    then the chunks moved to other physical places, each bucket's list
    keeping its scan order, so lists run out of physical order and some
    later copies sit at lower slots.  Returns the stores and the copies'
    ids, three a row."""
    g, data, bucket_ids, src = made
    n, nb = data.shape[0], max(s.n_buckets for s in stores.values())
    rng = np.random.default_rng(seed)
    third = np.arange(n + 1, n + 1 + len(src))
    extra = g.rows(2000)
    extra_buckets = rng.integers(0, nb, 2000)
    extra_buckets[extra_buckets == 3] = 4  # bucket 3 stays empty
    victims = rng.choice(np.setdiff1d(np.arange(1, n + 1), copies), 300, replace=False)
    out = {}
    for name, store in stores.items():
        n0 = store.n_chunks
        store = mutation.insert_rows(store, data[torch.as_tensor(src, device=data.device)],
                                     bucket_ids[src], third)
        store = mutation.insert_rows(store, extra, extra_buckets,
                                     np.arange(third[-1] + 1, third[-1] + 2001))
        store, n_del = mutation.delete_ids(store, victims)
        check(store.n_chunks > n0 and n_del == 300, f"mutated {name} store: grew, 300 deleted")
        out[name] = shuffled_chunks(store, seed)
        ptr, clist = out[name].chunk_list()
        check(any((np.diff(clist[a:b]) < 0).any() for a, b in zip(ptr[:-1], ptr[1:])),
              f"mutated {name} store: a chunk list runs out of physical order")
    return out, np.concatenate([copies, third[:, None]], axis=1)


def shuffled_chunks(store, seed: int):
    """The same store with its chunks at other physical places: each
    bucket's list names them in the old scan order.  A virtual store
    moves only its id grid's chunks."""
    dev = store.device
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(store.n_chunks), device=dev)
    inv = torch.argsort(perm)  # new physical chunk → old
    slots = (inv[:, None] * store.chunk + torch.arange(store.chunk, device=dev)).reshape(-1)
    ptr, clist = store.chunk_list()
    if store.virtual:
        return store._replace(chunk_ids=store.chunk_ids[inv], bucket_chunk_ptr=ptr,
                              bucket_chunk_list=perm.cpu().numpy()[clist].astype(np.int32))
    return store._replace(
        chunk_data=store.chunk_data[slots], chunk_ids=store.chunk_ids[inv],
        chunk_scales=None if store.chunk_scales is None else store.chunk_scales[slots],
        row_slot=(perm[store.row_slot.long() // store.chunk] * store.chunk
                  + store.row_slot % store.chunk).int(),
        bucket_chunk_ptr=ptr, bucket_chunk_list=perm.cpu().numpy()[clist].astype(np.int32),
    )


def phase_kernel_vs_plain(dev) -> dict:
    """The scan kernel against its plain version at widths 768, 96 and
    100 (rows not 16-byte aligned: a depth tail and narrower copies):
    every mode over every store type it takes (bf16 over f32/bf16/int8,
    int8, f32 over f32/bf16/int8) at k 16/36/64/100/256/300/600, every
    list width from 32 to 1024, with qtile 1/8/100/128 in turn; then f32
    over bf16 and int8 stores of one-hot rows (split_terms_check); then
    every mode over int8 rows of 30 and 102 bytes (no 4-byte granule);
    the row-map mode at d 768 and 100 (row_map_cases) and k past the
    widest list (wide_k_cases).  Every case also checks the launch count
    and that no list names a slot twice.  Returns, per mode, (largest
    |Δd|, largest |Δd| where slots differ)."""
    qtiles = (1, 8, 100, 128)
    combos = [("bf16", "f32"), ("bf16", "bf16"), ("bf16", "int8"), ("int8", "int8"),
              ("f32", "bf16"), ("f32", "int8"), ("f32", "f32")]
    worst = {m: (0.0, 0.0) for m in ("f32", "bf16", "int8")}
    for d in (768, 96, 100, 30, 102):
        stores, queries, order, _, copies, made = kv_stores(dev, d)
        if d in (30, 102):  # unaligned int8 rows: the modes that read an int8 store
            cases = [(mode, k, qtile, "int8") for mode, k, qtile in
                     (("int8", 16, 128), ("int8", 100, 8), ("bf16", 36, 100), ("f32", 16, 1))]
        else:
            cases = [(mode, k, qtiles[(ki + si) % 4], store)
                     for ki, k in enumerate((16, 36, 64, 100, 256, 300, 600))
                     for si, (mode, store) in enumerate(combos)]
        # then, at d 768, the stores mutated (which writes them in place) and
        # their chunk lists out of physical order, at list widths 32 and 64
        for tag in ("", " mutated") if d == 768 else ("",):
            kv, groups, set_cases = stores, copies, cases
            if tag:
                kv, groups = mutate_kv_stores(stores, copies, made)
                set_cases = [(mode, k, qtiles[(ki + si) % 4], store)
                             for ki, k in enumerate((16, 36)) for si, (mode, store) in enumerate(combos)]
            partner = {name: scan_partner(store, groups) for name, store in kv.items()}
            for mode, k, qtile, store_name in set_cases:
                held_to_plain(kv[store_name], queries, order, k, qtile, mode, partner[store_name],
                              f"{mode} store={store_name}{tag} d={d} k={k} qtile={qtile}", worst)
        if d in (768, 100):
            row_map_cases(dev, d, made, stores["f32"], queries, order, copies, worst)
        del stores, kv
        if d in (30, 102):
            continue
        for si, store_name in enumerate(("bf16", "int8")):
            for ki, k in enumerate((16, 100)):
                split_terms_check(dev, d, store_name, k, qtiles[(2 * si + ki + d) % 4])
    wide_k_cases(dev, worst)
    tied_cases(dev, worst)
    split_cases(dev, worst)
    width32_cases(dev, worst)
    for mode, (err, gap) in worst.items():
        log(f"[kernel-vs-plain] {mode}: max|Δd| {err:.3g}; at swapped slots {gap:.3g}")
    return worst


def wgmma_kind(store, mode: str, k: int) -> int:
    """The wgmma body that a launch at ``k`` in ``mode`` over ``store`` takes
    where it takes one: in int8 mode the int8 body (above list width 32 the
    int8 body with wide lists); else above list width 32 the f32-mode body
    with wide lists in f32 mode, else (bf16) the wide-list body over f32
    rows or over int8 rows; over f32 rows the six-term body in f32 mode,
    else the body over f32 rows; over int8 rows the f32-mode body in f32
    mode, else the bf16 body over int8 rows; over a row map (a virtual
    store of an int8 corpus, list width 32) the row-map bodies."""
    f32_rows = store.rows_ref.dtype == torch.float32
    if store.virtual and mode != "int8" and k <= 32:
        return 11 if mode == "f32" else 10
    if mode == "int8":
        return 7 if k > 32 else 6
    if k > 32:
        return 8 if mode == "f32" else 9 if f32_rows else 4
    if f32_rows:
        return 5 if mode == "f32" else 2
    return 3 if mode == "f32" else 1


def held_to_plain(store, queries, order, k: int, qtile: int, mode: str, partner, what: str,
                  worst: dict, launches: int = 1, edit_qidx=None, wgmma=None):
    """One scan case: the kernel (``launches`` launches) against its plain
    version (``compare_candidates``), no slot listed twice, exact ties to
    the earlier copy; folds the error into ``worst``.  ``edit_qidx`` may
    change the plan's query slots first; ``partner`` None skips the
    duplicate-order check; ``wgmma`` (where given) how many of the
    launches must take a wgmma body, and every launch on one must take the
    body ``wgmma_kind`` names.  The line names the body each launch took.
    Returns the query slots, the pairs' buckets and the kernel's slots."""
    plan, args = scan_inputs(store, queries, order, qtile, mode)
    if edit_qidx is not None:
        args = (args[0], edit_qidx(args[1].clone()), *args[2:])
    kw = dict(k=k, qtile=qtile, chunk=store.chunk, mode=mode)
    before, before_w, before_b = scan_kernel.LAUNCHES, scan_kernel.WGMMA_LAUNCHES, body_launches()
    kd, ks = scan_kernel.scan_pairs(*args, **kw)
    torch.cuda.synchronize()
    check(scan_kernel.LAUNCHES - before == launches,
          f"{what}: {scan_kernel.LAUNCHES - before} launches, not {launches}")
    n_w = scan_kernel.WGMMA_LAUNCHES - before_w
    ran = {body: n - before_b[body] for body, n in body_launches().items()}
    kind = wgmma_kind(store, mode, k)
    check(wgmma is None or n_w == wgmma, f"{what}: {n_w} wgmma-body launches, not {wgmma}")
    check(all(n == (n_w if body == kind else 0) for body, n in ran.items()),
          f"{what}: wgmma launches by body {ran}, not {n_w} on the "
          f"{scan_kernel.BODY_NAMES[kind]} body")
    rd, rs = scan_kernel.scan_pairs_reference(*args, **kw)
    err, gap = compare_candidates(kd, ks, rd, rs, mode, what)
    distinct_slots(ks, what)
    n_dup = 0
    if partner is not None:
        n_dup = earlier_duplicate_first(ks, partner, what)
        earlier_duplicate_first(rs, partner, f"{what} (plain)")
    worst[mode] = (max(worst[mode][0], err), max(worst[mode][1], gap))
    wgmma_body = scan_kernel.BODY_NAMES[kind]
    log(f"[kernel-vs-plain] {what:52s} pairs={plan.n_pairs:4d}: agree, max|Δd|={err:.3g}, "
        f"{int((ks != rs).sum().item())} slots swapped at ties (max|Δd| there {gap:.3g}), "
        f"{n_dup} later duplicates after their earlier copy; body: "
        f"{f'{wgmma_body} ×{n_w}' if n_w else ''}"
        f"{' + ' if n_w and n_w < launches else ''}"
        f"{f'mma.sync ×{launches - n_w}' if launches > n_w else ''}")
    return args[1], args[2], ks


def tied_cases(dev, worst: dict) -> None:
    """List widths 64, 256 and 1024 (and k 1100: a round of 1024, then one
    of 76 under its floor) over rows that all tie: each of 3 buckets holds
    one row over and over (~1,300 rows of d 768, chunk 320), 150 deletes
    leave padding slots inside the lists and the chunks move out of
    physical order.  Every mode over every store type it takes, the kernel
    against its plain version, and every live query's list the bucket's
    first live slots in scan order.  Then, at qtile 128, the query slots
    of the plan's first pair moved into one later block (the last m-tile
    where one block holds the pair) and the second pair's slots all
    padding: blocks with no live slot write the fill and leave."""
    rng = np.random.default_rng(13)
    n, nb, chunk, d = 4000, 3, 320, 768
    bucket_ids = rng.integers(0, nb, n)
    base = BlobGenerator(8, d, seed=13, noise=0.45, device=dev).rows(nb)
    data = base[torch.as_tensor(bucket_ids, device=dev)]
    q_int, q_sc = quantize.quantize_rows(data)
    victims = rng.choice(n, 150, replace=False) + 1
    stores = {}
    for name, (rows, sc) in {"f32": (data, None), "bf16": (data.bfloat16(), None),
                             "int8": (q_int, q_sc)}.items():
        st = BucketStore.build_packed_device(rows, bucket_ids, nb, chunk=chunk, row_scales=sc)
        st, n_del = mutation.delete_ids(st, victims)
        check(n_del == 150, f"tied {name} store: 150 deleted")
        stores[name] = shuffled_chunks(st, 13)
    queries = BlobGenerator(8, d, seed=14, noise=0.45, device=dev).rows(200)
    order = torch.as_tensor(np.stack([rng.permutation(nb)[:2] for _ in range(200)]), device=dev)
    order[-20:, 1] = -1
    combos = [("bf16", "f32"), ("bf16", "bf16"), ("bf16", "int8"), ("int8", "int8"),
              ("f32", "bf16"), ("f32", "int8"), ("f32", "f32")]
    for store_name, st in stores.items():
        ptr, clist = st.chunk_list()
        ids = st.chunk_ids.reshape(-1).cpu().numpy()
        in_order = []
        for b in range(nb):
            slots = (clist[ptr[b] : ptr[b + 1], None].astype(np.int64) * chunk
                     + np.arange(chunk)).reshape(-1)
            in_order.append(slots[ids[slots] > 0])
        for i, (mode, k) in enumerate((m, k) for k in (60, 250, 1000, 1100)
                                      for m, sn in combos if sn == store_name):
            qtile = (1, 100, 128)[i % 3]
            case = f"tied {mode} store={store_name} k={k}"
            what = f"{case} qtile={qtile}"
            qidx, pb, ks = held_to_plain(st, queries, order, k, qtile, mode, None, what, worst,
                                         launches=-(-k // scan_kernel.MAX_K))
            in_scan_order(qidx, pb, ks, in_order, what)
            if k > scan_kernel.MAX_K:
                continue
            width = 1 << (k - 1).bit_length()  # the list width; above 128 a block holds
            at = 112 if width <= 128 else 128 * 128 // width  # 128·128/width query slots

            def one_block(qidx, at=at):
                q = qidx.view(-1, 128)
                rows = q[0, :3].clone()
                check(bool((rows >= 0).all()) and q.shape[0] >= 2,
                      "padding-block case: a full pair")
                q[0] = -1
                q[0, at : at + 3] = rows
                q[1] = -1
                return qidx

            what = f"{case} padding blocks, live slots {at}-{at + 2}"
            qidx, pb, ks = held_to_plain(st, queries, order, k, 128, mode, None, what, worst,
                                         edit_qidx=one_block)
            in_scan_order(qidx, pb, ks, in_order, what)
            q, s = qidx.view(-1, 128).cpu().numpy(), ks.cpu().numpy()
            check(bool((s[1] == -1).all()) and bool((s[0][q[0] < 0] == -1).all()),
                  f"{what}: padding slots get only the fill")
    del stores, data


def split_run(store, args, plan, k: int, qtile: int, mode: str, segment):
    """The scan and merge kernels over ``args``'s plan, ``segment`` chunks a
    segment (``None``: the wrapper's choice), in rounds past 1024; checks
    one scan launch a round and one merge a round that split a pair (none
    over whole buckets, ``segment`` 10**6).  Returns the lists, the rounds
    and the merges."""
    launch = scan_kernel._kernel_round(args[0], *args[3:7], args[7], args[8], qtile=qtile,
                                       chunk=store.chunk, mode=mode, segment=segment)
    rounds = []

    def scan_round(q_idx, p_bucket, w, floor):
        rounds.append(w)
        return launch(q_idx, p_bucket, w, floor)

    before = (scan_kernel.LAUNCHES, scan_kernel.MERGE_LAUNCHES, scan_kernel.SPLIT_LAUNCHES)
    if k <= scan_kernel.MAX_K:
        out = scan_round(plan.qidx, plan.pair_bucket, k, None)
    else:
        n_slots = store.n_chunks * store.chunk
        positions = scan_kernel.chunk_positions(args[3], args[4], n_slots // store.chunk)
        out = scan_kernel.scan_in_rounds(scan_round, plan.qidx, plan.pair_bucket, positions,
                                         k=k, qtile=qtile, chunk=store.chunk)
    torch.cuda.synchronize()
    scans, merges, splits = (now - b for now, b in zip(
        (scan_kernel.LAUNCHES, scan_kernel.MERGE_LAUNCHES, scan_kernel.SPLIT_LAUNCHES), before))
    check(scans == len(rounds) and merges == splits and (segment != 10**6 or merges == 0),
          f"split run at segment {segment}: {scans} scan launches for {len(rounds)} rounds, "
          f"{merges} merges for {splits} launches that split")
    return out, len(rounds), merges


def split_cases(dev, worst: dict) -> None:
    """Forced segments of 1 and 2 chunks: the scan kernel over the items
    and the merge kernel give the bits of the kernel over whole buckets
    (a segment longer than any bucket: one item a pair), and stay within
    the bar of the plain version (``compare_candidates``), exact ties to
    the earlier copy across segment boundaries.  Every mode over every
    store type at k 16/100/300/1024 (list widths 32, 128, 512, 1024) over
    the ``kv_stores`` stores (3 chunks a bucket), the same stores
    mutated (chunk lists out of physical order, k 16 and 36), virtual
    stores (the row map, k 16 and 128) and k 1100 in rounds under floors
    over the mutated int8 and f32 stores and a virtual bf16 one."""
    stores, queries, order, _, copies, made = kv_stores(dev, 768, seed=17)
    combos = [("bf16", "f32"), ("bf16", "bf16"), ("bf16", "int8"), ("int8", "int8"),
              ("f32", "bf16"), ("f32", "int8"), ("f32", "f32")]
    qtiles = (1, 8, 100, 128)
    sets = [("", stores, [(m, sn, k, qtiles[(ki + ci) % 4])
                          for ki, k in enumerate((16, 100, 300, 1024))
                          for ci, (m, sn) in enumerate(combos)])]
    virt = virtual_stores(made, stores["f32"])
    sets.append((" row map", virt, [(m, sn, k, qtiles[(ki + ci) % 4])
                                    for ki, k in enumerate((16, 128))
                                    for ci, (m, sn) in enumerate(combos)]))
    mutated, groups = mutate_kv_stores(stores, copies, made, seed=17)
    sets.append((" mutated", mutated, [(m, sn, k, qtiles[(ki + ci) % 4])
                                       for ki, k in enumerate((16, 36, 1100))
                                       for ci, (m, sn) in enumerate(combos)
                                       if k != 1100 or sn != "bf16"]))
    sets.append((" row map", {"bf16": virt["bf16"]}, [("bf16", "bf16", 1100, 128)]))
    n_cases = 0
    for tag, kv, cases in sets:
        partner = {name: scan_partner(st, groups if tag == " mutated" else copies)
                   for name, st in kv.items()}
        for mode, store_name, k, qtile in cases:
            st = kv[store_name]
            what = f"split {mode} store={store_name}{tag} k={k} qtile={qtile}"
            plan, args = scan_inputs(st, queries, order, qtile, mode)
            (wd, ws), n_rounds, _ = split_run(st, args, plan, k, qtile, mode, 10**6)
            rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=st.chunk,
                                                      mode=mode)
            merges = []
            for segment in (1, 2):
                (kd, ks), _, n_merges = split_run(st, args, plan, k, qtile, mode, segment)
                merges.append(n_merges)
                check(torch.equal(kd.view(torch.int32), wd.view(torch.int32))
                      and torch.equal(ks, ws),
                      f"{what} segment={segment}: the split kernel's bits differ from the "
                      f"kernel's over whole buckets")
            err, gap = compare_candidates(kd, ks, rd, rs, mode, what)
            distinct_slots(ks, what)
            n_dup = earlier_duplicate_first(ks, partner[store_name], what)
            worst[mode] = (max(worst[mode][0], err), max(worst[mode][1], gap))
            n_cases += 1
            log(f"[kernel-vs-plain] {what:52s} pairs={plan.n_pairs:4d}: segments of 1 and 2 "
                f"chunks bit-equal to whole buckets ({n_rounds} round(s); merges {merges[0]}, "
                f"{merges[1]}, none over whole buckets); against the plain "
                f"version max|Δd|={err:.3g}, at swapped slots {gap:.3g}; {n_dup} later "
                f"duplicates after their earlier copy")
    log(f"[kernel-vs-plain] split: {n_cases} cases, each at segments of 1, 2 and whole buckets")
    del stores, virt, mutated


def width32_cases(dev, worst: dict) -> None:
    """bf16 and f32 over the int8 and the f32 store, and int8 over the int8
    store, at list width 32, where the wgmma bodies run: k 16 and 32 at
    qtile 1/8/100/128 over the ``kv_stores`` int8 and f32 stores at chunk
    320 (not whole 128-row tiles) and 130 (not whole 64-row tiles) and over
    the same stores mutated (chunk lists out of physical order); forced
    segments of 1 and 2 chunks bit-equal to whole buckets at k 16 and 32; d
    1152 (the widest resident query tile of bf16 over int8 rows) and 1040
    (rounded up to it), d 1664 (the widest of int8 queries) and 1600, d 896
    (the widest over f32 rows, of f32 over int8 rows and of f32 over f32
    rows), 840 and 832 (rounded up to it), 100 (f32 rows of 400 bytes) and
    16; int8 over int8 rows at k 33 and at the widest tiles of the int8
    body with wide lists (d 1408 at k 64, 896 at k 106); f32 over int8
    rows at k 33 and 64 and at d 752 (rounded up to 768, the widest tile of
    the f32-mode body with wide lists) at k 106; bf16 over f32 rows at k 33
    and 64, at d 752 (rounded up to 768, the widest tile of the body over
    f32 rows with wide lists) and d 100 at k 106.  Then the launches that
    keep the mma.sync body at width 32 or just past it: virtual stores of
    an f32 corpus, and of the int8 corpus int8 queries and f32 queries at
    k 64,
    int8 rows of 100 bytes (at k 16 and 64; f32 queries over them at 64),
    int8 queries past the wide-list int8 body's widest tiles (d 1520 at k
    64, 912 at k 106), f32 queries past the f32-mode wide body's (d 784 at
    k 64, 896 at k 106), bf16 queries past the wide body's over f32 rows
    (d 800 at k 64, 772 at k 106) and over f32 rows of 408 bytes at k 64,
    d 900 (past the widest f32 tiles), f32 rows of
    408 bytes (d 102), f32 over int8 rows at d 1040 (past its widest tile),
    f32 over f32 rows at k 33 (list width 64), and
    k 1040 over buckets of ~4,000 rows of either type (a 1024-wide round,
    then a 16-wide one under its floors, which keeps the body of the round
    before it, so that both sum a row the same way).  Over the int8 corpus's
    virtual store (the mutated stores' corpus) bf16 and f32 at k 16 take the
    row-map bodies, and so do d 96 and their widest resident tiles
    (``ROWMAP_MAX_QD``), one step past those and rows of 100 bytes not.
    Each case checks which body its launches took, as the library reports
    each launch; int8 is bit-equal to the plain version throughout."""
    qtiles = (1, 8, 100, 128)
    n_cases = 0
    for chunk in (320, 130):
        stores, queries, order, _, copies, made = kv_stores(dev, 768, seed=19, chunk=chunk)
        kv = {name: stores[name] for name in ("int8", "f32")}
        for tag in ("", " mutated") if chunk == 320 else ("",):
            if tag:  # after the fresh stores' cases: mutation writes the stores in place
                virt = virtual_stores(made, stores["f32"])
                for name, mode, k in (("int8", "bf16", 16), ("f32", "bf16", 16),
                                      ("int8", "f32", 16), ("f32", "f32", 16),
                                      ("int8", "int8", 16), ("int8", "int8", 64),
                                      ("int8", "f32", 64)):
                    held_to_plain(virt[name], queries, order, k, 128, mode,
                                  scan_partner(virt[name], copies),
                                  f"width 32 {mode} virtual {name} corpus k={k} qtile=128", worst,
                                  wgmma=int(name == "int8" and mode != "int8" and k <= 32))
                    n_cases += 1
                del virt
                kv, copies = mutate_kv_stores(kv, copies, made, seed=19)
            for name, st in kv.items():
                partner = scan_partner(st, copies)
                for mode in ("bf16", "f32", "int8") if name == "int8" else ("bf16", "f32"):
                    for k in (16, 32):
                        for qtile in qtiles:
                            held_to_plain(st, queries, order, k, qtile, mode, partner,
                                          f"width 32 {mode} store={name}{tag} chunk={chunk} "
                                          f"k={k} qtile={qtile}", worst, wgmma=1)
                            n_cases += 1
                        if tag:
                            continue
                        plan, args = scan_inputs(st, queries, order, 128, mode)
                        whole, _, _ = split_run(st, args, plan, k, 128, mode, 10**6)
                        for segment in (1, 2):
                            got, _, _ = split_run(st, args, plan, k, 128, mode, segment)
                            check(torch.equal(got[0].view(torch.int32),
                                              whole[0].view(torch.int32))
                                  and torch.equal(got[1], whole[1]),
                                  f"width 32 {mode} {name} chunk={chunk} k={k} "
                                  f"segment={segment}: the split's bits differ from whole buckets")
                        log(f"[kernel-vs-plain] width 32 {mode} store={name} chunk={chunk} "
                            f"k={k} qtile=128: segments of 1 and 2 chunks bit-equal to whole "
                            f"buckets (wgmma body)")
        del stores, kv
    # the widest query tiles the wgmma bodies keep resident (1152 of bf16
    # over int8 rows, 1664 of int8 queries, 896 over f32 rows and of f32
    # over int8 or f32 rows), d that the library rounds up to them (1040,
    # 1600; 840 over f32 rows, 832 of f32 over int8 rows), f32 rows of 400
    # and 64 bytes; then the widths and the list widths that keep the
    # mma.sync body
    for d, name, mode, wgmma, k in (
            (1152, "int8", "bf16", 1, 16), (1040, "int8", "bf16", 1, 16),
            (1664, "int8", "int8", 1, 32), (1600, "int8", "int8", 1, 16),
            (100, "int8", "int8", 0, 16), (768, "int8", "int8", 1, 33),
            (1408, "int8", "int8", 1, 64), (896, "int8", "int8", 1, 106),
            (100, "int8", "int8", 0, 64), (1520, "int8", "int8", 0, 64),
            (912, "int8", "int8", 0, 106),
            (768, "int8", "f32", 1, 33), (768, "int8", "f32", 1, 64), (752, "int8", "f32", 1, 106),
            (100, "int8", "f32", 0, 64), (784, "int8", "f32", 0, 64), (896, "int8", "f32", 0, 106),
            (768, "f32", "bf16", 1, 33), (768, "f32", "bf16", 1, 64), (752, "f32", "bf16", 1, 106),
            (100, "f32", "bf16", 1, 106), (800, "f32", "bf16", 0, 64), (772, "f32", "bf16", 0, 106),
            (102, "f32", "bf16", 0, 64),
            (896, "f32", "bf16", 1, 16), (840, "f32", "bf16", 1, 16), (100, "f32", "bf16", 1, 16),
            (896, "int8", "f32", 1, 16), (832, "int8", "f32", 1, 16), (896, "f32", "f32", 1, 16),
            (840, "f32", "f32", 1, 32), (100, "f32", "f32", 1, 16), (16, "f32", "f32", 1, 32),
            (100, "int8", "bf16", 0, 16), (900, "f32", "bf16", 0, 16), (102, "f32", "bf16", 0, 16),
            (1040, "int8", "f32", 0, 16), (100, "int8", "f32", 0, 16), (900, "f32", "f32", 0, 16),
            (102, "f32", "f32", 0, 16), (768, "f32", "f32", 0, 33)):
        stores, queries, order, _, copies, _ = kv_stores(dev, d, seed=19)
        held_to_plain(stores[name], queries, order, k, 128, mode,
                      scan_partner(stores[name], copies), f"width 32 {mode} store={name} d={d} "
                      f"k={k} qtile=128", worst, wgmma=wgmma)
        n_cases += 1
        del stores
    # the row-map bodies' widest resident tiles over an int8 corpus's virtual
    # store and one 16-value step past each (rounded up past it: the
    # mma.sync body), d 96, and rows of 100 bytes (the mma.sync body)
    for d, mode, wgmma in ((ROWMAP_MAX_QD["bf16"], "bf16", 1),
                           (ROWMAP_MAX_QD["bf16"] + 16, "bf16", 0),
                           (ROWMAP_MAX_QD["f32"], "f32", 1), (ROWMAP_MAX_QD["f32"] + 16, "f32", 0),
                           (96, "bf16", 1), (96, "f32", 1), (100, "bf16", 0), (100, "f32", 0)):
        stores, queries, order, _, copies, made = kv_stores(dev, d, seed=19)
        virt = virtual_stores(made, stores["f32"])["int8"]
        held_to_plain(virt, queries, order, 16, 128, mode, scan_partner(virt, copies),
                      f"width 32 {mode} row map int8 corpus d={d} k=16 qtile=128", worst,
                      wgmma=wgmma)
        n_cases += 1
        del stores, virt
    # floors at width 32: buckets of ~4,000 rows, so the 16-wide round runs
    g = BlobGenerator(16, 768, seed=23, noise=0.45, device=dev)
    data = g.rows(12_000)
    rng = np.random.default_rng(23)
    q_int, q_sc = quantize.quantize_rows(data)
    buckets = rng.integers(0, 3, 12_000)
    floored = {"int8": BucketStore.build_packed_device(q_int, buckets, 3, chunk=320,
                                                       row_scales=q_sc),
               "f32": BucketStore.build_packed_device(data, buckets, 3, chunk=320)}
    order = torch.as_tensor(np.stack([rng.permutation(3)[:2] for _ in range(200)]), device=dev)
    queries = g.rows(200)
    for name, mode in (("int8", "bf16"), ("f32", "bf16"), ("int8", "f32"), ("f32", "f32"),
                       ("int8", "int8")):
        for qtile in (8, 128):
            held_to_plain(floored[name], queries, order, 1040, qtile, mode, None,
                          f"width 32 rounds {mode} store={name} k=1040 qtile={qtile}", worst,
                          launches=2, wgmma=0)
            n_cases += 1
    log(f"[kernel-vs-plain] width 32: {n_cases} cases held to the plain version, "
        f"each naming its body")
    del floored, data


def in_scan_order(qidx, pair_bucket, slots, in_order, what: str) -> None:
    """Each live query's list is its bucket's first live slots in scan
    order (``in_order[bucket]``), then -1."""
    n_pairs, qtile, k = slots.shape
    q = qidx.cpu().numpy().reshape(n_pairs, qtile)
    s = slots.cpu().numpy()
    for p, b in enumerate(pair_bucket.cpu().numpy()):
        want = in_order[b][:k]
        for j in np.nonzero(q[p] >= 0)[0]:
            got = s[p, j]
            check(np.array_equal(got[: len(want)], want) and bool((got[len(want):] == -1).all()),
                  f"{what}: pair {p} slot {j} is not its bucket's first rows in scan order")


def virtual_stores(made, like) -> dict:
    """Virtual stores over the ``kv_stores`` corpus in each type (f32, bf16,
    int8 with its row scales), the layout of ``like``: the row map."""
    _, data, bucket_ids, _ = made
    q_int, q_sc = quantize.quantize_rows(data)
    nb, chunk = like.n_buckets, like.chunk
    return {
        "f32": BucketStore.build_virtual(data, bucket_ids, nb, chunk=chunk),
        "bf16": BucketStore.build_virtual(data.bfloat16(), bucket_ids, nb, chunk=chunk),
        "int8": BucketStore.build_virtual(q_int, bucket_ids, nb, chunk=chunk, row_scales=q_sc),
    }


def row_map_cases(dev, d: int, made, like, queries, order, copies, worst: dict) -> None:
    """The kernel's row-map mode (a virtual store: rows read through the
    id grid) against the plain version: f32, bf16 and int8 + row-scale
    corpora in modes bf16 and f32 (and int8 over the int8 corpus) at k
    16/128/1024 (list widths 32, 128, 1024); at d 768 also with the chunk
    lists out of physical order (k 16 and 128)."""
    qtiles = (1, 8, 100, 128)
    virt = virtual_stores(made, like)
    for name, st in virt.items():
        check(st.virtual and st.nbytes() == st.chunk_ids.numel() * 4, f"virtual {name}: grid only")
    ks = (16, 128, 1024) if d == 768 else (16, 128)
    cases = [(corpus, mode, k) for k in ks for corpus in ("f32", "bf16", "int8")
             for mode in ("bf16", "f32")] + [("int8", "int8", k) for k in ks]
    sets = [("", virt)]
    if d == 768:
        sets.append((" shuffled", {n: shuffled_chunks(st, 3) for n, st in virt.items()}))
    for tag, stores in sets:
        partner = {name: scan_partner(st, copies) for name, st in stores.items()}
        for i, (corpus, mode, k) in enumerate(cases):
            if tag and k == 1024:
                continue
            qtile = qtiles[(i + d) % 4]
            held_to_plain(stores[corpus], queries, order, k, qtile, mode, partner[corpus],
                          f"row map {mode} corpus={corpus}{tag} d={d} k={k} qtile={qtile}", worst)


def wide_k_cases(dev, worst: dict) -> None:
    """k past the widest list (1024), in rounds of at most 1024, one launch
    a round: 1030 and 2100 over an int8 and an f32 store mutated like the
    serving path's (inserts, deletes, chunk lists out of physical order)
    and over a virtual bf16 store with its chunk lists shuffled; 12,000×768
    rows in 3 buckets of ~4,000 (+ 1,000 inserted), so every round runs.
    The kernel equals the plain version's one list, no slot twice."""
    g = BlobGenerator(16, 768, seed=11, noise=0.45, device=dev)
    n, nb, chunk = 12_000, 3, 320
    data = g.rows(n)
    rng = np.random.default_rng(11)
    bucket_ids = rng.integers(0, nb, size=n)
    src = rng.choice(n // 2, size=60, replace=False)
    dst = n // 2 + rng.choice(n // 2, size=60, replace=False)
    data[torch.as_tensor(dst, device=dev)] = data[torch.as_tensor(src, device=dev)]
    bucket_ids[dst] = bucket_ids[src]
    q_int, q_sc = quantize.quantize_rows(data)
    stores = {
        "int8": BucketStore.build_packed_device(q_int, bucket_ids, nb, chunk=chunk, row_scales=q_sc),
        "f32": BucketStore.build_packed_device(data, bucket_ids, nb, chunk=chunk),
    }
    extra, extra_b = g.rows(1000), rng.integers(0, nb, 1000)
    victims = rng.choice(np.setdiff1d(np.arange(1, n + 1), np.r_[src, dst] + 1), 500, replace=False)
    for name in list(stores):
        st = mutation.insert_rows(stores[name], extra, extra_b, np.arange(n + 1, n + 1001))
        st, n_del = mutation.delete_ids(st, victims)
        check(n_del == 500, f"wide {name} store: 500 deleted")
        stores[name] = shuffled_chunks(st, 5)
    stores["virtual"] = shuffled_chunks(
        BucketStore.build_virtual(data.bfloat16(), bucket_ids, nb, chunk=chunk), 6)
    queries = g.rows(200)
    queries[:60] = data[torch.as_tensor(src, device=dev)]
    order = np.stack([rng.permutation(nb)[:2] for _ in range(200)])
    order[:60, 0] = bucket_ids[src]
    order[:60, 1] = (bucket_ids[src] + 1) % nb
    order = torch.as_tensor(order, device=dev)
    order[-20:, 1] = -1
    copies = np.stack([src + 1, dst + 1], axis=1)
    for store_name, mode, k in (("int8", "int8", 1030), ("int8", "bf16", 2100),
                                ("int8", "f32", 1030), ("f32", "f32", 2100),
                                ("f32", "bf16", 1030), ("virtual", "bf16", 2100),
                                ("virtual", "f32", 1030)):
        st = stores[store_name]
        held_to_plain(st, queries, order, k, 8 if k > 2000 else 128, mode,
                      scan_partner(st, copies), f"rounds {mode} store={store_name} k={k}", worst,
                      launches=-(-k // scan_kernel.MAX_K))
    del stores, data


def split_terms_check(dev, d: int, store_name: str, k: int, qtile: int) -> None:
    """f32 mode over a bf16 or int8 store whose rows each hold one
    power of two (±1 to ±64; int8 rows with f32 scales) in 5 buckets,
    150 f32 queries visiting 3: the kernel's distances within
    SPLIT_REL_ERR·(1 + |dot|) of the plain version's at every rank, and
    the queries' hi + mid alone (the plain version) outside it somewhere."""
    rng = np.random.default_rng(d * 31 + k)
    n, nb, chunk = 3000, 5, 320
    rows = torch.arange(n, device=dev)
    cols = torch.as_tensor(rng.integers(0, d, n), device=dev)
    vals = np.ldexp(rng.choice([-1.0, 1.0], n), rng.integers(0, 7, n)).astype(np.float32)
    bucket_ids = rng.integers(0, nb, n)
    dtype = torch.int8 if store_name == "int8" else torch.bfloat16
    x = torch.zeros((n, d), dtype=dtype, device=dev)
    x[rows, cols] = torch.as_tensor(vals, device=dev).to(dtype)
    scales = (torch.as_tensor(rng.uniform(0.01, 0.03, n).astype(np.float32), device=dev)
              if store_name == "int8" else None)
    store = BucketStore.build_packed_device(x, bucket_ids, nb, chunk=chunk, row_scales=scales)
    queries = torch.as_tensor(rng.normal(size=(150, d)).astype(np.float32), device=dev)
    order = torch.as_tensor(np.stack([rng.choice(nb, 3, replace=False) for _ in range(150)]),
                            device=dev)
    plan, args = scan_inputs(store, queries, order, qtile, "f32")
    kw = dict(k=k, qtile=qtile, chunk=chunk, mode="f32")
    kd, _ = scan_kernel.scan_pairs(*args, **kw)
    rd, _ = scan_kernel.scan_pairs_reference(*args, **kw)
    hi, mid, _ = scan_kernel.split_f32(args[0])
    td, _ = scan_kernel.scan_pairs_reference(hi.float() + mid.float(), *args[1:], **kw)
    what = f"f32 store={store_name} one-hot rows d={d} k={k} qtile={qtile}"
    fin = torch.isfinite(rd)
    check(torch.equal(fin, torch.isfinite(kd)) and bool(fin.any()), f"{what}: filled entries differ")
    bar = SPLIT_REL_ERR * (1.0 + (1.0 - rd[fin]).abs())
    share = float(((kd[fin] - rd[fin]).abs() / bar).max())
    share_two = float(((td[fin] - rd[fin]).abs() / bar).max())
    check(share_two > 1.0, f"{what}: hi + mid alone stays within the bar ({share_two:.3g} of it)")
    check(share <= 1.0, f"{what}: the kernel misses the bar ({share:.3g} of it)")
    err = float((kd[fin] - rd[fin]).abs().max())
    log(f"[kernel-vs-plain] {what:44s} pairs={plan.n_pairs:4d}: max|Δd|={err:.3g} = "
        f"{share:.3g} of the bar; hi + mid alone {share_two:.3g} of it")


@full_f32()
def make_corpus(dev, n: int, nq: int, nb: int, d: int = 768, seed: int = 2023) -> dict:
    """The seeded corpus of both paths: ``n`` × ``d`` int8 rows + f32 row
    scales on the device (256 latent clusters, noise 0.45/√d), ``nq``
    queries from the same mixture, their exact f32 top-10 ids (1-based)
    and ``nb`` corpus rows as f32 centroids."""
    gen = BlobGenerator(256, d, seed=seed, noise=0.45, device=dev)
    queries = gen.rows(nq)
    cent_rows = torch.randperm(n, generator=torch.Generator().manual_seed(seed))[:nb]
    centroids = torch.empty(nb, d, device=dev)

    # corpus, generated and quantized in blocks (the f32 corpus is never
    # resident), with the exact f32 top-10 of every query merged per block
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    corpus = torch.empty(n, d, dtype=torch.int8, device=dev)
    row_scales = torch.empty(n, device=dev)
    gt_d = torch.full((nq, 10), -torch.inf, device=dev)
    gt_i = torch.zeros((nq, 10), dtype=torch.int64, device=dev)
    block = 500_000
    for s0 in range(0, n, block):
        x = gen.rows(min(block, n - s0))
        corpus[s0 : s0 + len(x)], row_scales[s0 : s0 + len(x)] = quantize.quantize_rows(x)
        hit = (cent_rows >= s0) & (cent_rows < s0 + len(x))
        if hit.any():
            centroids[hit.nonzero()[:, 0].to(dev)] = x[(cent_rows[hit] - s0).to(dev)]
        for q0 in range(0, nq, 2500):
            sims = queries[q0 : q0 + 2500] @ x.T
            v, i = torch.topk(sims, 10, dim=1)
            cat_v = torch.cat([gt_d[q0 : q0 + 2500], v], 1)
            cat_i = torch.cat([gt_i[q0 : q0 + 2500], i + s0], 1)
            v, j = torch.topk(cat_v, 10, dim=1)
            gt_d[q0 : q0 + 2500], gt_i[q0 : q0 + 2500] = v, torch.gather(cat_i, 1, j)
        del x
    torch.cuda.synchronize()
    log(f"[corpus] {n}x{d} int8 + f32 row scales on device, 256 latent clusters, "
        f"noise 0.45/sqrt(d), seed {seed}: {time.perf_counter() - t0:.1f} s "
        f"(with the exact f32 top-10 of {nq} queries)")
    return {"corpus": corpus, "row_scales": row_scales, "queries": queries,
            "gt_ids": (gt_i + 1).cpu().numpy(), "centroids": centroids}


def flagship_index(dev, data: dict, smi: str):
    """The flagship's hand-set index over ``data`` (``make_corpus``): an
    MLP-4 that encodes the nearest-centroid partition exactly, saved and
    reloaded through .npz, the corpus's buckets by the loaded index's
    navigation, and the packed int8 store.  Returns (index,
    data_prediction, store, made: the store's seconds, bytes and peak
    device memory while it was made)."""
    corpus, row_scales, centroids = data["corpus"], data["row_scales"], data["centroids"]
    (n, d), nb, chunk = corpus.shape, centroids.shape[0], 2048
    block = 500_000

    # MLP-4 (768 → 512 → 120) that encodes nearest-centroid exactly:
    # hidden j and 120+j are relu(±c_j·x), W2 takes their difference to
    # logit j, b2 = −|c_j|²/2, so argmax = the nearest c_j in L2
    w1 = np.zeros((1, d, 512), np.float32)
    w2 = np.zeros((1, 512, nb), np.float32)
    c = centroids.cpu().numpy()
    w1[0, :, :nb], w1[0, :, nb : 2 * nb] = c.T, -c.T
    w2[0, np.arange(nb), np.arange(nb)] = 1.0
    w2[0, nb + np.arange(nb), np.arange(nb)] = -1.0
    b2 = (-0.5 * (c * c).sum(1))[None, :].astype(np.float32)
    params = [{"w": w1, "b": np.zeros((1, 512), np.float32)}, {"w": w2, "b": b2}]
    cfg = lmi.BuildConfiguration("kmeans", 4, "MLP-4", 0.01, [nb], chunk_size=chunk)
    built = index_from_arrays(cfg, [params], [np.ones((1, nb), bool)], ["MLP-4"],
                              np.ones(nb, bool), dev)
    WORK_DIR.mkdir(parents=True, exist_ok=True)
    path = WORK_DIR / "index.npz"
    lmi.save_index(built, str(path))
    index, saved_pred = lmi.LearnedIndex.load(str(path), dev)
    check(saved_pred is None, "no data_prediction was saved")
    for a, b in zip(built.levels[0].mlp.parameters(), index.levels[0].mlp.parameters()):
        check(torch.equal(a, b), "weights survive the .npz round trip")
    log(f"[index] 1-level, {nb} buckets, MLP-4 768->512->{nb}; saved and reloaded "
        f"{path.relative_to(ROOT)} ({path.stat().st_size} bytes)")

    # buckets: argmax of the loaded index's navigation forward
    t0 = time.perf_counter()
    pred = torch.empty(n, dtype=torch.int64, device=dev)
    with torch.no_grad():
        for s0 in range(0, n, block):
            x = quantize.dequantize_rows(corpus[s0 : s0 + block], row_scales[s0 : s0 + block])
            pred[s0 : s0 + block] = index.levels[0].mlp(x)[0].argmax(1)
    data_prediction = pred.cpu().numpy()[:, None]
    sizes = np.bincount(data_prediction[:, 0], minlength=nb)
    log(f"[buckets] navigation argmax over the corpus: {time.perf_counter() - t0:.1f} s; "
        f"bucket sizes min {sizes.min()} median {int(np.median(sizes))} max {sizes.max()}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    store = index.prepare_packed_store((corpus, row_scales), data_prediction)
    torch.cuda.synchronize()
    made = {"s": time.perf_counter() - t0, "bytes": store.nbytes(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "peak_added_gb": (torch.cuda.max_memory_allocated() - before) / 1e9}
    log(f"[store] packed int8 store on device: {store.n_chunks} chunks of {chunk}, "
        f"{store.nbytes() / 1e9:.2f} GB, {made['s']:.1f} s; device memory while it was made: "
        f"peak {made['peak_gb']:.2f} GB, {made['peak_added_gb']:.2f} GB above the corpus  [{smi}]")
    del pred
    torch.cuda.empty_cache()
    return index, data_prediction, store, made


def phase_main(dev, data: dict, smi: str):
    queries, gt_ids = data["queries"], data["gt_ids"]
    nb, nq = data["centroids"].shape[0], queries.shape[0]
    t_all = time.perf_counter()
    index, data_prediction, store, made = flagship_index(dev, data, smi)

    def search(q, n_buckets=4, precision="default", k=10):
        return index.search(None, q, None, q, data_prediction, n_buckets=n_buckets,
                            k=k, store=store, precision=precision)

    # ---- the main path: every launch from here to the read counts ----
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    search(queries)  # warmup
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        dists, ids, measured = search(queries)
        times.append(time.perf_counter() - t0)
    res = {"default": (dists, ids)}
    for prec in ("highest", "int8"):
        t0 = time.perf_counter()
        res[prec] = search(queries, precision=prec)[:2]
        log(f"[search] precision={prec}: {time.perf_counter() - t0:.4f} s per {nq} queries")
    one = search(queries[:1])
    hundred = search(queries[:100])
    # search(k=100), the ann-benchmarks k: k_scan 106 (the rerank margin 6),
    # list width 128, the wide-list wgmma body
    search(queries, k=100)  # warmup
    times100 = []
    for _ in range(3):
        t0 = time.perf_counter()
        d100, i100, measured100 = search(queries, k=100)
        times100.append(time.perf_counter() - t0)
    # the int8 search(k=100): k_scan 106, the int8 wgmma body with wide lists
    int8_100 = search(queries, precision="int8", k=100)[:2]
    # the highest search(k=100): k_scan 106, the f32-mode wgmma body with wide lists
    t0 = time.perf_counter()
    high_100 = search(queries, precision="highest", k=100)[:2]
    high_100_s = time.perf_counter() - t0
    launches = read_counts()
    wgmma_launches = scan_kernel.WGMMA_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    # ------------------------------------------------------------------
    check(launches["scan_pairs"] > 0 and launches["scan_merge"] == launches["scan_split"],
          f"the main path: {launches['scan_merge']} merges for {launches['scan_split']} scan "
          f"launches that split a pair (one merge each, none where no pair splits)")
    # six default searches (bf16 over the int8 store, k_scan 16: the wgmma
    # body), one highest (f32 over the int8 store: the f32-mode wgmma body),
    # one int8 (the int8 wgmma body), four at k=100 (the wide-list body), one
    # int8 at k=100 (the int8 body with wide lists) and one highest at k=100
    # (the f32-mode body with wide lists): none on the mma.sync body
    check(launches["scan_pairs"] == 14 and launches[WGMMA_INT8] == 6
          and launches[WGMMA_F32MODE] == 1 and launches[WGMMA_S8] == 1
          and launches[WGMMA_WIDE] == 4 and launches[WGMMA_S8_WIDE] == 1
          and launches[WGMMA_F32MODE_WIDE] == 1 and wgmma_launches == 14,
          f"the main path: {launches}, not 14 scans, 6 on the wgmma body, 1 on the f32-mode "
          f"wgmma body, 1 on the int8 wgmma body, 4 on the wide-list wgmma body, 1 on the int8 "
          f"wgmma body with wide lists, 1 on the f32-mode wgmma body with wide lists")
    check(set(measured) == {"inference", "search", "search_within_buckets", "seq_search", "sort"},
          "measured keys")
    check(one[0].shape == (1, 10) and hundred[0].shape == (100, 10), "small requests' shapes")
    same_neighbors(one[0], one[1], dists[:1], ids[:1], "1-query request vs the batch")
    same_neighbors(hundred[0], hundred[1], dists[:100], ids[:100], "100-query request vs the batch")
    for prec, (dd, ii) in res.items():
        check(dd.shape == (nq, 10) and dd.dtype == np.float32 and ii.dtype == np.uint32,
              f"{prec}: result shapes and types")
        check(bool(np.isfinite(dd).all()) and bool((ii > 0).all()), f"{prec}: finite, filled")
    mean_s = float(np.mean(times))
    log(f"[search] precision=default, n_buckets=4, k=10: reps {[round(t, 4) for t in times]} s; "
        f"mean {mean_s:.4f} s per {nq} queries = {nq / mean_s:.0f} QPS; "
        f"inference {measured['inference']:.4f} s, scan {measured['seq_search']:.4f} s; "
        f"peak device memory {peak / 1e9:.2f} GB (corpus resident); kernel launches "
        f"{launches}, of the scan's {wgmma_launches} on a wgmma body (one a default "
        f"search, one the highest search, one the int8 search, one a k=100 search, one the "
        f"int8 k=100 search, one the highest k=100 search; a merge where a pair split)  [{smi}]")
    for what, (dd, ii) in (("k=100", (d100, i100)), ("int8 k=100", int8_100),
                           ("highest k=100", high_100)):
        check(dd.shape == (nq, 100) and bool(np.isfinite(dd).all()) and bool((ii > 0).all()),
              f"{what}: finite, filled (nq, 100) results")
    mean100 = float(np.mean(times100))
    log(f"[search k=100] precision=default, n_buckets=4, k=100 (k_scan 106, the wide-list wgmma "
        f"body): reps {[round(t, 4) for t in times100]} s; mean {mean100:.4f} s per {nq} queries "
        f"= {nq / mean100:.0f} QPS; inference {measured100['inference']:.4f} s, scan "
        f"{measured100['seq_search']:.4f} s  [{smi}]")

    # ---- checks against exact kNN over each query's visited buckets ----
    nc = 256
    qc = queries[:nc]
    order, _ = index.compute_bucket_order(qc, 4, keep_on_device=True)
    ref_d, ref_i = restricted_knn(store, qc, order, 10)
    ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy()
    n_tied = same_neighbors(res["highest"][0][:nc], res["highest"][1][:nc], ref_d, ref_i,
                            "highest vs visited-bucket exact kNN")
    for prec in ("default", "int8"):
        r = recall(res[prec][1][:nc], ref_i, 10)
        check(r >= 0.999, f"{prec}: recall {r} vs visited-bucket exact")
        log(f"[check] precision={prec}: recall@10 vs visited-bucket exact kNN = {r:.4f} ({nc} queries)")
    # the highest and int8 searches through the scan's plain version in the
    # kernel's place
    kernel = bucket_store_module.scan_pairs
    bucket_store_module.scan_pairs = scan_kernel.scan_pairs_reference
    try:
        plain = {prec: search(qc, precision=prec) for prec in ("highest", "int8")}
    finally:
        bucket_store_module.scan_pairs = kernel
    plain_i = plain["highest"][1]
    r_high, r_plain = recall(res["highest"][1][:nc], ref_i, 10), recall(plain_i, ref_i, 10)
    check(r_high == r_plain, f"highest: recall {r_high} vs visited-bucket exact, the same "
          f"search through the plain version {r_plain}")
    log(f"[check] precision=highest: equals visited-bucket exact kNN ({nc} queries, "
        f"{n_tied} ids differ at ties); recall@10 {r_high:.4f}, the same search through the "
        f"scan's plain version {r_plain:.4f}")
    phase_int8_search(queries, res["int8"], plain["int8"], ref_i, search, smi)
    phase_k100(queries, index, store, d100, i100, int8_100, search, times100, smi,
               high_100=(*high_100, high_100_s))
    full_order = torch.arange(nb, device=dev).repeat(nc, 1)
    fd, fi = restricted_knn(store, qc, full_order, 10)
    fd, fi = fd.cpu().numpy(), fi.cpu().numpy()
    ad, ai, _ = search(qc, n_buckets=nb, precision="highest")
    same_neighbors(ad, ai, fd, fi, f"n_buckets={nb} vs whole-store exact kNN")
    r_all = recall(ai, fi, 10)
    log(f"[check] n_buckets={nb}: recall@10 vs whole-store exact kNN = {r_all:.4f} ({nc} queries)")
    log(f"[recall] whole-corpus recall@10 of the {nq} queries at n_buckets=4 (default precision) "
        f"vs exact f32 kNN over the generated corpus: {recall(res['default'][1], gt_ids, 10):.4f}")

    # ---- the kernel, its plain version and the library call at the flagship shape ----
    order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
    timing = {mode: flagship_scan(store, queries, order, 16, mode, smi, "[flagship]")
              for mode in ("bf16", "f32", "int8")}
    check(timing["int8"]["body"] == 6, "the flagship's int8 scan at k_scan 16 did not take the "
          "int8 wgmma body")
    # search(k=100), the ann-benchmarks k: k_scan 106 with the rerank margin, list width 128
    for mode in ("bf16", "f32", "int8"):
        timing[f"k106 {mode}"] = flagship_scan(store, queries, order, 106, mode, smi,
                                               "[flagship k=100]")
    # ... and the int8 and f32 scans at list width 64 (k_scan 64)
    for mode in ("int8", "f32"):
        timing[f"k64 {mode}"] = flagship_scan(store, queries, order, 64, mode, smi,
                                              "[flagship k=64]")
    check(timing["k106 int8"]["body"] == 7 and timing["k64 int8"]["body"] == 7,
          "the flagship's int8 scan at k_scan 106 and 64 did not take the int8 wgmma body with "
          "wide lists")
    check(timing["k106 f32"]["body"] == 8 and timing["k64 f32"]["body"] == 8,
          "the flagship's f32 scan at k_scan 106 and 64 did not take the f32-mode wgmma body "
          "with wide lists")
    merge = merge_vs_plain(store, queries, order, smi)
    scan_s = timing["bf16"]["ms"] / 1e3
    log(f"[split] search at default precision {mean_s:.4f} s per {nq}: navigation "
        f"{measured['inference']:.4f} s, scan kernel {scan_s:.4f} s (CUDA events, same plan), "
        f"plan + merge + rerank + copy {measured['seq_search'] - scan_s:.4f} s (seq_search "
        f"{measured['seq_search']:.4f} s of the last rep)")
    f32_timing, f32_launches, merge["B"] = f32_store_scan(store, queries, order, smi, index,
                                                          data_prediction)
    timing.update(f32_timing)
    launches = {name: n + f32_launches[name] for name, n in launches.items()}
    log(f"[main] total {time.perf_counter() - t_all:.1f} s")
    torch.cuda.empty_cache()
    return launches, timing, {"index": index, "data_prediction": data_prediction,
                              "store": store, "made": made, "merge": merge}


def phase_int8_search(queries, main_int8, plain, ref_i, search, smi: str, k: int = 10) -> None:
    """The main path's ``precision="int8"`` search at ``k`` (``main_int8``:
    its distances and ids over all the queries; at k=10 the int8 wgmma
    body's scan, at k=100 the int8 body's with wide lists) against exact
    kNN over the visited buckets (``ref_i``, of the first ``nc`` queries):
    its recall@k equal to the same search's with the scan's plain version
    in the kernel's place (``plain``, over those ``nc``), and a kernel
    search of them bit-equal to that one (the int8 scan's lists are
    exact); then three more int8 searches of all the queries timed (host
    clock; outside the main path's launch counts)."""
    t_phase = time.perf_counter()
    nc, nq = ref_i.shape[0], queries.shape[0]
    r_int8, r_plain = recall(main_int8[1][:nc], ref_i, k), recall(plain[1], ref_i, k)
    check(r_int8 == r_plain, f"int8 k={k}: recall {r_int8} vs visited-bucket exact, the same "
          f"search through the plain version {r_plain}")
    kd, ki, _ = search(queries[:nc], precision="int8", k=k)
    same = (np.array_equal(kd.view(np.uint32), plain[0].view(np.uint32))
            and np.array_equal(ki, plain[1]))
    check(same, f"int8 k={k}: the search through the kernel differs from the one through the "
          f"plain version")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        search(queries, precision="int8", k=k)
        times.append(time.perf_counter() - t0)
    log(f"[check{'' if k == 10 else f' k={k}'}] precision=int8: recall@{k} vs visited-bucket "
        f"exact kNN {r_int8:.4f} ({nc} queries), the same search through the scan's plain "
        f"version {r_plain:.4f}, its results bit-equal to the kernel's; search precision=int8, "
        f"n_buckets=4, k={k}: reps {[round(t, 4) for t in times]} s, mean "
        f"{float(np.mean(times)):.4f} s per {nq} queries; these checks took "
        f"{time.perf_counter() - t_phase:.1f} s  [{smi}]")


def phase_k100(queries, index, store, d100, i100, int8_100, search, times100, smi: str,
               nc: int = 1024, high_100=None) -> None:
    """The main path's ``search(k=100)`` (``d100``, ``i100``, host times
    ``times100``) held to exact kNN over each query's visited buckets:
    recall@100 of its first ``nc`` queries at least 0.999 and within 0.001
    of the same search's with the scan's plain version in the kernel's
    place, which is timed over all the queries beside it (host clock,
    mean of 3); then its ``precision="int8"`` search (``int8_100``: its
    distances and ids) through ``phase_int8_search`` against the same
    exact kNN and the int8 search of the first ``nc`` queries through the
    scan's plain version; then its ``precision="highest"`` search
    (``high_100``: its distances, ids and host seconds) through
    ``phase_highest_k100``."""
    t_phase = time.perf_counter()
    nq = queries.shape[0]
    qc = queries[:nc]
    order, _ = index.compute_bucket_order(qc, 4, keep_on_device=True)
    ref_d, ref_i = restricted_knn(store, qc, order, 100)
    ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy()
    kernel = bucket_store_module.scan_pairs
    bucket_store_module.scan_pairs = scan_kernel.scan_pairs_reference
    try:
        plain_times = []
        for _ in range(3):
            t0 = time.perf_counter()
            plain_d, plain_i, _ = search(queries, k=100)
            plain_times.append(time.perf_counter() - t0)
        plain_int8 = search(qc, precision="int8", k=100)
        plain_high = search(qc, precision="highest", k=100)
    finally:
        bucket_store_module.scan_pairs = kernel
    r_kernel, r_plain = recall(i100[:nc], ref_i, 100), recall(plain_i[:nc], ref_i, 100)
    r_whole = recall(i100, plain_i, 100)
    check(r_kernel >= 0.999 and abs(r_kernel - r_plain) <= 0.001,
          f"k=100: recall@100 {r_kernel} vs visited-bucket exact, the same search through the "
          f"plain version {r_plain}")
    np.testing.assert_allclose(d100, plain_d, atol=BF16_ATOL, err_msg="k=100: distances "
                               "against the search through the plain version")
    log(f"[check k=100] precision=default: recall@100 vs visited-bucket exact kNN {r_kernel:.4f} "
        f"({qc.shape[0]} queries), the same search through the scan's plain version "
        f"{r_plain:.4f}; the two searches' ids agree at {r_whole:.4f} over all {nq} queries; the "
        f"search through the plain version reps {[round(t, 4) for t in plain_times]} s, mean "
        f"{float(np.mean(plain_times)):.4f} s per {nq} (the kernel's search "
        f"{float(np.mean(times100)):.4f}); these checks took {time.perf_counter() - t_phase:.1f} "
        f"s  [{smi}]")
    phase_int8_search(queries, int8_100, plain_int8, ref_i, search, smi, k=100)
    if high_100 is not None:
        phase_highest_k100(queries, high_100, plain_high, ref_d, ref_i, search, smi)


def phase_highest_k100(queries, high_100, plain, ref_d, ref_i, search, smi: str) -> None:
    """The main path's ``precision="highest"`` ``search(k=100)``
    (``high_100``: its distances, ids and host seconds over all the
    queries; the f32-mode wgmma body with wide lists at ``k_scan`` 106)
    against exact kNN over the visited buckets (``ref_d``, ``ref_i``, of the
    first ``nc`` queries): equal to it (ids differing only at f32 ties),
    and its recall@100 equal to the same search's with the scan's plain
    version in the kernel's place (``plain``, over those ``nc``); then
    three more such searches of all the queries timed (host clock; outside
    the main path's launch counts)."""
    t_phase = time.perf_counter()
    nc, nq = ref_i.shape[0], queries.shape[0]
    dd, ii, main_s = high_100
    n_tied = same_neighbors(dd[:nc], ii[:nc], ref_d, ref_i,
                            "highest k=100 vs visited-bucket exact kNN")
    r_high, r_plain = recall(ii[:nc], ref_i, 100), recall(plain[1], ref_i, 100)
    check(r_high == r_plain, f"highest k=100: recall {r_high} vs visited-bucket exact, the "
          f"same search through the plain version {r_plain}")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        search(queries, precision="highest", k=100)
        times.append(time.perf_counter() - t0)
    log(f"[check k=100] precision=highest: equals visited-bucket exact kNN ({nc} queries, "
        f"{n_tied} ids differ at ties); recall@100 {r_high:.4f}, the same search through the "
        f"scan's plain version {r_plain:.4f}; search precision=highest, n_buckets=4, k=100 "
        f"(k_scan 106, the f32-mode wgmma body with wide lists): the main path's "
        f"{main_s:.4f} s, reps {[round(t, 4) for t in times]} s, mean "
        f"{float(np.mean(times)):.4f} s per {nq} queries; these checks took "
        f"{time.perf_counter() - t_phase:.1f} s  [{smi}]")


def flagship_scan(store, queries, order, k: int, mode: str, smi: str, tag: str) -> dict:
    """The scan kernel at the flagship plan (qtile 128) and ``k``: its time,
    its plain version's and the library call's (``library_scan``: a matmul
    and ``torch.topk(k)`` a bucket) by CUDA events, the bound
    (``scan_work``), and its candidates held to the plain version's; in
    f32 at ``k_scan`` 16, and at every ``k_scan`` over an int8 store, also
    both against float64 (the kernel may not be less exact)."""
    chunk, d = store.chunk, queries.shape[1]
    plan, sargs = scan_inputs(store, queries, order, 128, mode)
    kw = dict(k=k, qtile=128, chunk=chunk, mode=mode)
    mac, ops, peak, nbytes = scan_work(store, plan, order, d, k, mode)
    bound = {"operations": ops / peak * 1e3, "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    k_ms = cuda_ms(lambda: scan_kernel.scan_pairs(*sargs, **kw), 3)
    p_ms = cuda_ms(lambda: scan_kernel.scan_pairs_reference(*sargs, **kw), 1)
    lib_ms = cuda_ms(library_scan(store, plan, sargs, k, mode), 1)
    torch.cuda.empty_cache()  # the library's slab copies
    kd, ks = scan_kernel.scan_pairs(*sargs, **kw)
    rd, rs = scan_kernel.scan_pairs_reference(*sargs, **kw)
    err, gap = compare_candidates(kd, ks, rd, rs, mode, f"{tag} {mode} k={k}")
    if mode == "f32" and (k == 16 or store.rows_ref.dtype == torch.int8):
        # no less exact than cuBLAS's f32: both against float64
        k_err = float64_error(store, sargs[0], plan, kd, ks)
        p_err = float64_error(store, sargs[0], plan, rd, rs)
        log(f"{tag} scan_pairs f32{'' if k == 16 else f' k_scan {k}'} against float64 "
            f"distances, the candidates of the first 16 pairs: kernel max|err| {k_err:.3g}, "
            f"plain {p_err:.3g}")
        check(k_err <= p_err, f"flagship f32 k={k}: the kernel's error against float64 "
              f"{k_err:.3g} exceeds the plain version's {p_err:.3g}")
    fma = ""
    if mode == "f32" and store.rows_ref.dtype == torch.float32:
        fma = (f"; the CUDA cores' FMA route {2 * mac / PEAK_OPS['f32'] * 1e3:.3f} ms "
               f"({2 * mac:.4g} operations at {PEAK_OPS['f32'] / 1e12:g} T/s)")
    split = split_plan(sargs, k, mode)
    reads = reread_text(store, plan, split, d)
    log(f"{tag} scan_pairs {mode}{'' if k == 16 else f' k_scan {k}'}: kernel {k_ms:.3f} ms, "
        f"plain {p_ms:.2f} ms, library {lib_ms:.2f} ms = {lib_ms / k_ms:.3f}x the kernel; bound "
        f"{bound[bound_by]:.3f} ms by {bound_by} ({mac:.4g} MAC, {ops:.4g} operations at "
        f"{peak / 1e12:g} T/s = {bound['operations']:.3f} ms, {nbytes / 1e9:.3f} GB = "
        f"{bound['bytes']:.3f} ms) = {bound[bound_by] / k_ms:.1%} of it{fma}; {plan.n_pairs} "
        f"pairs, {mac / k_ms / 1e9:.1f} TMAC/s; {reads}; agree, max|Δd|={err:.3g} (at swapped "
        f"slots {gap:.3g}); {split_text(split)}  [{smi}]")
    del sargs, kd, ks, rd, rs
    torch.cuda.empty_cache()
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "err": err,
            "bound_ms": bound[bound_by], "bound_by": bound_by, "body": split["body"]}


def split_plan(sargs, k: int, mode: str, segment=None) -> dict:
    """How the scan wrapper splits the plan of ``sargs`` at ``k``: the
    slots on the card, the segment length (``segment``: forced to this
    many chunks), the pairs, the items and the most items of a pair."""
    _, qidx, pb, ptr, _, st, _, _, row_ids = sargs
    lib = cuda_build.load(scan_kernel.SOURCE, scan_kernel._bind)
    ptr_h, pb_h, live = scan_kernel.host_plan(ptr, pb, qidx, 128)
    body = scan_kernel.scan_body(lib, st, mode, k, row_ids)  # one round, no floor
    seg = segment or scan_kernel.segment_length(
        ptr_h, pb_h, live, width=scan_kernel.list_width(k), slots=body.slots,
        wgmma_block=body.block_queries if body.wgmma else 0)
    work = scan_kernel.split_pairs(ptr_h, pb_h, seg)
    chunks = np.diff(ptr_h)[pb_h]
    return {"slots": body.slots, "segment": seg, "pairs": len(pb_h),
            "items": len(work.item_pair), "largest": int(chunks.max(initial=0)), "work": work,
            "max_items": int(np.diff(work.pair_items).max(initial=0)),
            "wgmma": body.wgmma, "body": body.kind, "qd": body.qd if body.wgmma else 0,
            "block": body.block_queries}


def split_text(split: dict) -> str:
    return (f"{scan_kernel.BODY_NAMES[split['body']]} body; split: {split['slots']} slots, "
            f"segments of {split['segment']} chunks, {split['pairs']} pairs -> {split['items']} "
            f"items (largest bucket {split['largest']} chunks, at most {split['max_items']} "
            f"items a pair)")


MERGE_SHAPES = {  # the shapes the merge is timed at ((A) in phase_dynamic, (B) in f32_store_scan)
    "A": "(A) the serving dispatch's plan: 1,024 queries over the built index after the dynamic "
         "path's mutations, bf16, k_scan 16",
    "a": "(a) the hand-set index's first 1,024 queries, bf16, k_scan 16 (the merge A/B tool's "
         "stand-in for (A))",
    "B": "(B) the f32 store's f32 plan, k_scan 106",
    "C": "(C) the flagship plan, bf16, k_scan 16, segments forced to 20 chunks",
    "D": "(D) the flagship plan, bf16, k_scan 16",
    "E": "(E) the hand-set index's first 1,024 queries, bf16, k_scan 106 (a 1,024-query "
         "search(k=100))",
}


def merge_items(store, sargs, split: dict, k: int, mode: str) -> tuple:
    """The item lists that one scan launch of the split path leaves over
    the plan of ``sargs`` cut as ``split`` (``split_plan``): ``(dists,
    slots, pair_items)``."""
    q, qidx, _, _, chunk_of, st, sc, qs, row_ids = sargs
    inputs = scan_kernel.split_inputs(split["work"], qidx, None, qtile=128, chunk=store.chunk)
    lib = cuda_build.load(scan_kernel.SOURCE, scan_kernel._bind)
    item_d, item_s = scan_kernel._launch_items(
        lib, scan_kernel.operand_queries(q, mode, st.dtype, split["qd"]), qs, inputs.qidx,
        inputs.pair_bucket, inputs.ptr, chunk_of, st, sc, row_ids, None, k=k, qtile=128,
        chunk=store.chunk, mode=mode, terms=3 if mode == "f32" else 1, body=split["body"])
    return item_d, item_s, inputs.pair_items


def merge_plan_text(k: int, max_items: int) -> str:
    """The merge kernel's plan at ``k`` (query tile 128) for pairs of at
    most ``max_items`` items, in words."""
    plan = scan_kernel.merge_plan(k, 128, max_items)
    if k <= scan_kernel.MERGE_WARP_MAX_K:
        how = "merged in a warp's lanes"
    elif plan.cap:
        how = f"pairs of up to {plan.cap} items staged in {plan.smem} B"
    else:
        how = "pairs streamed from device memory, a warp a slot"
    return f"plan: {plan.group} query slots a block, {how}"


def merge_bytes(item_d, pair_items) -> int:
    """What a merge must move: each item list read once (distances and
    slots), ``pair_items``, each pair's list written once."""
    n_pairs = pair_items.numel() - 1
    return item_d.numel() * 8 + pair_items.numel() * 4 + n_pairs * item_d[0].numel() * 8


def merge_case(store, queries, order, k: int, mode: str, shape: str, smi: str,
               segment=None) -> dict:
    """The merge kernel at one shape of ``MERGE_SHAPES``: the item lists that
    the split path's scan leaves at ``k`` over the plan of ``queries``
    visiting ``order`` (qtile 128; the wrapper's own segments, or
    ``segment`` chunks), merged by the kernel (its device time with the
    launches queued behind a spin, and back to back through the wrapper,
    both by CUDA events), by its plain version and by ``smallest_k`` over
    the lists side by side (the library yardstick; the lists laid side by
    side outside what is timed), beside the scan at that shape; the
    kernel's lists bit-equal to the plain version's.  Bound by bytes: the
    item lists read once, the pairs' lists written once.  Where no pair
    splits, the scan at that shape must launch no merge, and nothing is
    timed."""
    what, t0 = MERGE_SHAPES[shape], time.perf_counter()
    _, sargs = scan_inputs(store, queries, order, 128, mode)
    split = split_plan(sargs, k, mode, segment)
    kw = dict(k=k, qtile=128, chunk=store.chunk, mode=mode)
    if split["items"] == split["pairs"]:
        before = scan_kernel.LAUNCHES, scan_kernel.MERGE_LAUNCHES, scan_kernel.SPLIT_LAUNCHES
        scan_kernel.scan_pairs(*sargs, **kw)
        torch.cuda.synchronize()
        ran = tuple(now - b for now, b in zip(
            (scan_kernel.LAUNCHES, scan_kernel.MERGE_LAUNCHES, scan_kernel.SPLIT_LAUNCHES), before))
        check(ran == (1, 0, 0), f"merge {what}: no pair splits, yet the scan launch made "
              f"{ran[1]} merges ({ran[2]} launches that split)")
        log(f"[merge] {what}: no pair splits, the scan launch merges nothing: 0 merge launches "
            f"(one scan launch); {split_text(split)}; {time.perf_counter() - t0:.1f} s  [{smi}]")
        return {"launches": 0, "pairs": split["pairs"], "items": split["items"]}
    item_d, item_s, pair_items = merge_items(store, sargs, split, k, mode)
    args = (item_d, item_s, pair_items, split["max_items"])
    scan_ms = cuda_ms(lambda: scan_kernel.scan_pairs(*sargs, **kw), 3)
    q_ms = queued_ms(lambda: scan_kernel.merge_split_lists(*args), 50)
    k_ms = cuda_ms(lambda: scan_kernel.merge_split_lists(*args), 50)
    p_ms = cuda_ms(lambda: scan_kernel.merge_split_lists_reference(*args), 3)
    flat_d, _ = scan_kernel.lists_side_by_side(*args[:3])
    lib_ms = cuda_ms(lambda: smallest_k(flat_d, k), 5)
    kd, ks = scan_kernel.merge_split_lists(*args)
    rd, rs = scan_kernel.merge_split_lists_reference(*args)
    check(torch.equal(kd.view(torch.int32), rd.view(torch.int32)) and torch.equal(ks, rs),
          f"merge {what}: the kernel's lists differ from its plain version's")
    nbytes = merge_bytes(item_d, pair_items)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[merge] {what}: kernel {q_ms:.4f} ms (launches queued; back to back through the "
        f"wrapper {k_ms:.4f} ms), plain {p_ms:.3f} ms, smallest_k over the lists side by side "
        f"{lib_ms:.3f} ms; bound {bound_ms:.4f} ms by bytes ({nbytes / 1e6:.1f} MB) = "
        f"{bound_ms / q_ms:.1%} of it; {q_ms / scan_ms:.2%} of the scan's {scan_ms:.3f} ms at "
        f"this shape; bit-equal to the plain version; {merge_plan_text(k, split['max_items'])}; "
        f"{split_text(split)}; {time.perf_counter() - t0:.1f} s with the scan  [{smi}]")
    del args, item_d, item_s, flat_d, kd, ks, rd, rs
    torch.cuda.empty_cache()
    return {"ms": q_ms, "back_to_back_ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "err": 0.0,
            "bound_ms": bound_ms, "bound_by": "bytes", "scan_ms": scan_ms, "launches": 1,
            "pairs": split["pairs"], "items": split["items"]}


def merge_vs_plain(store, queries, order, smi: str) -> dict:
    """The merge kernel (``merge_case``) at shapes (a), (C), (D) and (E)
    of ``MERGE_SHAPES`` over the flagship's index; (a), (C) and (E) must
    split a pair ((E) in shared memory), (D) is the flagship's own plan, where
    no pair split in any run so far.  Then the split's host work a launch
    at the flagship plan: the plan read back, the cut, the work list
    uploaded, the items' query slots gathered."""
    shapes = {"a": merge_case(store, queries[:1024], order[:1024], 16, "bf16", "a", smi),
              "C": merge_case(store, queries, order, 16, "bf16", "C", smi, segment=20),
              "D": merge_case(store, queries, order, 16, "bf16", "D", smi),
              "E": merge_case(store, queries[:1024], order[:1024], 106, "bf16", "E", smi)}
    check(all(shapes[s]["launches"] == 1 for s in "aCE"),
          "one of the merge's shapes (a), (C) and (E) split no pair")
    _, sargs = scan_inputs(store, queries, order, 128, "bf16")
    qidx, segment = sargs[1], split_plan(sargs, 16, "bf16")["segment"]

    def host_split():
        ptr_h, pb_h, _ = scan_kernel.host_plan(sargs[3], sargs[2], qidx, 128)
        work = scan_kernel.split_pairs(ptr_h, pb_h, segment)
        return scan_kernel.split_inputs(work, qidx, None, qtile=128, chunk=store.chunk)

    host_split()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        host_split()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / HOST_CALLS * 1e3
    log(f"[flagship] the split's host work a launch (the plan read back, the cut, the work list "
        f"uploaded, the items' query slots gathered; host clock, device idle, mean of "
        f"{HOST_CALLS}) {host_ms:.4f} ms  [{smi}]")
    shapes["D"]["host_ms"] = host_ms
    return shapes


def f32_store_scan(store, queries, order, smi: str, index, data_prediction):
    """The flagship over an f32 store (the store
    ``BuildConfiguration(dtype="float32")`` builds, the CLI's default): the
    int8 store's rows dequantized slab by slab into f32 on its chunk
    layout, scales 1.0 on live slots and 0 on padding.  The scan in f32
    (``precision="highest"``) at ``k_scan`` 16 (the six-term wgmma body)
    and 106 (the six-term mma.sync body) and in bf16 (the default
    precision) at 106 and 64 (the wgmma body over f32 rows with wide
    lists, each scan one launch on it) and at 16 (the wgmma body over f32
    rows) (``flagship_scan``: the kernel, its plain version, whose
    candidates it must agree with, the library call, the bound, the body
    the launch took; in f32 at 16 the float64 gate), then whole searches
    of the 10k queries over that store at visit 4: k 10 at ``highest``
    and at the default precision, and k 100 at the default precision (the
    default ``search(k=100)``, k_scan 106), their launches counted (each
    ``highest`` search one launch of the six-term wgmma body, each default
    search one of the wgmma body over f32 rows, at k 100 with wide
    lists): seconds per 10k; ``highest`` equal to exact kNN over the
    visited buckets for 256 queries (ids differing only at ties, recall
    >= 0.999), each default search within the bf16 bar of the same search
    through the scan's plain version (256 queries at k 10, 1,024 at k
    100), both recalls against exact kNN over the visited buckets printed.
    Between them the merge at shape (B) (``merge_case``).  Returns the
    timings, the searches' launch counts and the merge's (B)."""
    f32 = dequantized_store(store)
    tag = f"[flagship f32 store, {f32.chunk_data.numel() * 4 / 1e9:.2f} GB]"
    timing = {"f32 store": flagship_scan(f32, queries, order, 16, "f32", smi, tag),
              "f32 store k106": flagship_scan(f32, queries, order, 106, "f32", smi, tag)}
    merge_b = merge_case(f32, queries, order, 106, "f32", "B", smi)
    check(timing["f32 store"]["body"] == 5 and timing["f32 store k106"]["body"] == 0,
          f"f32 over the f32 store: the six-term wgmma body at k_scan 16 and the mma.sync body "
          f"at 106, not bodies {timing['f32 store']['body']} and "
          f"{timing['f32 store k106']['body']}")
    torch.cuda.reset_peak_memory_stats()
    # the default search(k=100)'s scan (k_scan 106, list width 128) and list
    # width 64: every launch one of the wgmma body over f32 rows with wide lists
    for k in (106, 64):
        before = scan_kernel.LAUNCHES, scan_kernel.WGMMA_F32_WIDE_LAUNCHES
        timing[f"f32 store bf16 k{k}"] = t = flagship_scan(f32, queries, order, k, "bf16", smi, tag)
        ran = scan_kernel.LAUNCHES - before[0], scan_kernel.WGMMA_F32_WIDE_LAUNCHES - before[1]
        check(t["body"] == 9 and ran[0] > 0 and ran[0] == ran[1],
              f"the bf16 scan over the f32 store at k_scan {k}: body {t['body']}, {ran[0]} "
              f"launches, {ran[1]} of them on the wgmma body over f32 rows with wide lists")
    before = scan_kernel.WGMMA_F32_LAUNCHES
    timing["f32 store bf16"] = flagship_scan(f32, queries, order, 16, "bf16", smi, tag)
    check(scan_kernel.WGMMA_F32_LAUNCHES > before,
          "the bf16 scan over the f32 store ran the wgmma body over f32 rows")
    log(f"{tag} peak device memory while the bf16 scans at k_scan 106, 64 and 16, their plain "
        f"version and the library call (its bf16 copy of the visited slabs) ran beside the int8 "
        f"and f32 stores: {torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{smi}]")

    def search(q, precision, k):
        return index.search(None, q, None, q, data_prediction, n_buckets=4, k=k, store=f32,
                            precision=precision)

    def plain_search(q, precision, k):  # the search with the scan's plain version in the kernel's place
        kernel = bucket_store_module.scan_pairs
        bucket_store_module.scan_pairs = scan_kernel.scan_pairs_reference
        try:
            return search(q, precision, k)[:2]
        finally:
            bucket_store_module.scan_pairs = kernel

    nq = queries.shape[0]
    refs = {}
    for k, nc in ((10, 256), (100, 1024)):
        # slabs of 2**28 / nc rows: the distances and sort keys of a slab stay
        # within a few GB beside the int8 and f32 stores
        ref_d, ref_i = restricted_knn(f32, queries[:nc], order[:nc], k, slab_rows=2**28 // nc)
        refs[k] = nc, ref_d.cpu().numpy(), ref_i.cpu().numpy()
    reset_counts()
    for precision, k in (("highest", 10), ("default", 10), ("default", 100)):
        nc, ref_d, ref_i = refs[k]
        before = read_counts()
        search(queries, precision, k)  # warmup
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            dd, ii, _ = search(queries, precision, k)
            times.append(time.perf_counter() - t0)
        ran = {name: v - before[name] for name, v in read_counts().items()}
        body = (WGMMA_F32X if precision == "highest" else WGMMA_F32 if k == 10
                else WGMMA_F32_WIDE)
        check(ran["scan_pairs"] == 4 and ran[body] == 4 and ran["scan_merge"] == 0
              and ran["scan_split"] == 0
              and all(ran[b] == 0 for b in (WGMMA_INT8, WGMMA_F32, WGMMA_F32MODE, WGMMA_WIDE,
                                            WGMMA_F32X, WGMMA_S8, WGMMA_S8_WIDE,
                                            WGMMA_F32MODE_WIDE, WGMMA_F32_WIDE,
                                            WGMMA_INT8_ROWMAP, WGMMA_F32MODE_ROWMAP)
                             if b != body),
              f"f32-store {precision} search k={k}: {ran} launches, not 4 scans, each one "
              f"launch of the {body}, and no merge (10k queries at visit 4 split no pair)")
        check(dd.shape == (nq, k) and bool(np.isfinite(dd).all()) and bool((ii > 0).all()),
              f"f32-store {precision} search k={k}: finite, filled (nq, {k})")
        r = recall(ii[:nc], ref_i, k)
        if precision == "highest":
            n_tied = same_neighbors(dd[:nc], ii[:nc], ref_d, ref_i,
                                    "f32-store highest vs visited-bucket exact")
            r_plain = recall(plain_search(queries[:nc], precision, k)[1], ref_i, k)
            check(r >= 0.999 and r == r_plain, f"f32-store {precision}: recall {r} vs "
                  f"visited-bucket exact, the same search through the plain version {r_plain}")
            held = (f"{n_tied} ids differ at ties; the same search through the scan's plain "
                    f"version: recall {r_plain:.4f}")
        else:
            # bf16 rounds the f32 rows as well as the queries (int8 rows are
            # exact in bf16), so at a near-tie a true neighbour can fall past
            # the k + 6 shortlist: the search is held to the same search
            # through the scan's plain version, at the bf16 bar
            pd, pi = plain_search(queries[:nc], precision, k)
            err = float(np.abs(dd[:nc] - pd).max())
            same = float((np.sort(ii[:nc], 1) == np.sort(pi, 1)).mean())
            check(err <= BF16_ATOL and same >= BF16_SAME_IDS,
                  f"f32-store default search k={k} against the plain version's: max|Δd| "
                  f"{err:.3g}, {same:.4f} of the sorted ids equal")
            held = (f"the same search through the scan's plain version: recall "
                    f"{recall(pi, ref_i, k):.4f}, {same:.4f} of the sorted ids equal, max|Δd| "
                    f"{err:.3g}")
        mean_s = float(np.mean(times))
        k_scan = 16 if k == 10 else 106
        scan = timing["f32 store" if precision == "highest" else
                      "f32 store bf16" if k == 10 else "f32 store bf16 k106"]["ms"]
        log(f"[flagship f32 store] search precision={precision}, n_buckets=4, k={k}: reps "
            f"{[round(t, 4) for t in times]} s; mean {mean_s:.4f} s per {nq} queries "
            f"= {nq / mean_s:.0f} QPS; each search one launch of the {body}; scan kernel at "
            f"k_scan {k_scan} {scan:.3f} ms; recall@{k} vs visited-bucket exact kNN {r:.4f} "
            f"({nc} queries; {held}); launches {ran}  [{smi}]")
    launches = read_counts()
    del f32
    torch.cuda.empty_cache()
    return timing, launches, merge_b


def dequantized_store(store):
    """The packed int8 ``store`` as an f32 store on its chunk layout: its
    rows dequantized slab by slab, scales 1.0 on live slots and 0 on
    padding (``scales_flat``)."""
    chunk, (n_slots, d) = store.chunk, store.chunk_data.shape
    rows = torch.empty((n_slots, d), dtype=torch.float32, device=store.device)
    step = 128 * chunk
    for s0 in range(0, n_slots, step):
        rows[s0 : s0 + step] = quantize.dequantize_rows(
            store.chunk_data[s0 : s0 + step], store.chunk_scales[s0 : s0 + step])
    return store._replace(chunk_data=rows, chunk_scales=None)


def reread_text(store, plan, split: dict, d: int) -> str:
    """What the launch reads if nothing it reads twice hits in L2: each
    pair reading its bucket once (pairs × bucket bytes), and each block
    reading it once (the wgmma bodies' blocks of 64 query slots that hold
    a query; the mma.sync body at list width 32 one block a pair), beside
    the bound's bytes (each visited bucket once)."""
    sizes = torch.as_tensor(store.bucket_sizes, device=plan.pair_bucket.device).long()
    row_bytes = d * store.rows_ref.element_size() + 4
    per_pair = sizes[plan.pair_bucket.long()].double() * row_bytes
    blocks = torch.ones_like(per_pair)
    if split["wgmma"]:
        live = plan.qidx.view(plan.n_pairs, -1, split["block"]) >= 0
        blocks = live.any(dim=2).sum(dim=1).double()
    pair_gb, block_gb = float(per_pair.sum()) / 1e9, float((per_pair * blocks).sum()) / 1e9
    return (f"read once a pair {pair_gb:.3f} GB = {pair_gb * 1e12 / HBM_BYTES_PER_S:.3f} ms, "
            f"once a block {block_gb:.3f} GB = {block_gb * 1e12 / HBM_BYTES_PER_S:.3f} ms")


def scan_work(store, plan, order, d: int, k: int, mode: str) -> tuple:
    """What the scan of this visit set needs: (multiply-adds, operations,
    the peak rate they run at, bytes).  Multiply-adds: each visiting
    query with each true row of the bucket it visits (no tile or chunk
    padding).  Operations: 2 per multiply-add in the mode's type; for f32
    queries, whose exact product is bf16 passes on the tensor cores, 6
    (three passes) over an int8 or bf16 store and 12 (six passes) over an
    f32 store.  Bytes: each visited bucket's rows and row scales read
    once, the queries read once in the mode's type, the (n_pairs, qtile,
    k) distances and slots written once."""
    sizes = torch.as_tensor(store.bucket_sizes, device=order.device).long()
    visits = order[order >= 0].long()
    rows = float(sizes[visits].sum())
    visited = torch.unique(visits)
    # a row's values and its scale; a virtual store's row also its id
    row_bytes = d * store.rows_ref.element_size() + 4 + (4 if store.virtual else 0)
    q_bytes = {"f32": 4, "bf16": 2, "int8": 1}[mode] * d
    out_bytes = plan.n_pairs * 128 * k * 8
    nbytes = float(sizes[visited].sum()) * row_bytes + order.shape[0] * q_bytes + out_bytes
    if mode != "f32":
        return rows * d, 2.0 * rows * d, PEAK_OPS[mode], nbytes
    passes = 6 if store.rows_ref.dtype == torch.float32 else 3
    return rows * d, 2.0 * passes * rows * d, PEAK_OPS["bf16"], nbytes


def float64_error(store, queries, plan, dists, slots, n_pairs: int = 16) -> float:
    """Largest |distance − the same distance in float64| over the listed
    candidates of the plan's first ``n_pairs`` pairs (qtile 128)."""
    qidx = plan.qidx[: n_pairs * 128].reshape(n_pairs, 128).long()
    s = slots[:n_pairs].long()
    ok = (s >= 0) & (qidx >= 0)[:, :, None]
    q = queries[qidx.clamp_min(0)].double()
    x = store.chunk_data[s.clamp_min(0)].double()
    exact = 1.0 - torch.einsum("pqd,pqkd->pqk", q, x) * store.scales_flat()[s.clamp_min(0)].double()
    return float((dists[:n_pairs].double() - exact).abs()[ok].max())


def library_scan(store, plan, sargs, k: int, mode: str):
    """The yardstick: per visited bucket one matmul of its padded query
    tiles against its slab in the mode's type (``torch._int_mm`` for
    int8; f32 with TF32 off), then ``torch.topk``.  The int8 slabs are
    cast to bf16 or f32 once, here, outside what is timed.  Over a
    virtual store (modes bf16 and f32) the slab is gathered from the
    corpus through the id grid inside what is timed (``index_select``,
    then the cast): that gather is part of the function.  The port never
    calls it."""
    queries, qidx = sargs[0], plan.qidx
    ptr = store.bucket_chunk_start
    chunk = store.chunk
    buckets, runs = torch.unique_consecutive(plan.pair_bucket.cpu(), return_counts=True)
    flat_ids = store.chunk_ids.reshape(-1)
    work = []
    q0 = 0
    for b, npairs in zip(buckets.tolist(), runs.tolist()):
        rows = qidx[q0 * 128 : (q0 + npairs) * 128].long().clamp_min(0)
        q0 += npairs
        if ptr[b + 1] == ptr[b]:
            continue
        q = queries[rows]
        if mode == "bf16":
            q = q.bfloat16()
        lo, hi = int(ptr[b]) * chunk, int(ptr[b + 1]) * chunk
        if store.virtual:
            work.append((q, (flat_ids[lo:hi].long() - 1).clamp_min(0)))
            continue
        x = store.chunk_data[lo:hi]
        work.append((q, x if mode == "int8" else x.to(q.dtype)))

    @full_f32()
    def run():
        for q, x in work:
            if store.virtual:
                x = store.data_ref.index_select(0, x).to(q.dtype)
            if mode == "int8":
                sims = torch._int_mm(q, x.T)
            else:
                sims = q @ x.T
            torch.topk(sims, k, dim=1)

    return run


def row_map_scan(store, packed, queries, order, mode: str, smi: str) -> dict:
    """The row-map scan at ``k_scan`` 16 in ``mode`` (bf16: body 10, f32:
    body 11) beside the packed store's (body 1, body 3) on the same
    queries and visits: CUDA events in turns, its plain version, the
    library call (the slabs gathered through the grid inside the timing)
    and the bound; one launch on each body; the row map's lists bit-equal
    to the packed store's (the packed store holds the corpus's own bytes
    and scales, ``BucketStore.build_packed_device``) and within the bar of
    the plain version; in f32 both kernels' and the plain version's
    distances against float64 (the kernel may not be less exact)."""
    d = queries.shape[1]
    plan, vargs = scan_inputs(store, queries, order, 128, mode)
    _, pargs = scan_inputs(packed, queries, order, 128, mode)
    kw = dict(k=16, qtile=128, chunk=store.chunk, mode=mode)
    body, packed_body = (WGMMA_F32MODE_ROWMAP, WGMMA_F32MODE) if mode == "f32" else (
        WGMMA_INT8_ROWMAP, WGMMA_INT8)
    runs = {"packed": [], "virtual": []}
    for _ in range(2):  # in turns
        for name, a in (("packed", pargs), ("virtual", vargs)):
            runs[name].append(cuda_ms(lambda: scan_kernel.scan_pairs(*a, **kw), 3))
    v_ms, p_ms = float(np.mean(runs["virtual"])), float(np.mean(runs["packed"]))
    plain_ms = cuda_ms(lambda: scan_kernel.scan_pairs_reference(*vargs, **kw), 1)
    lib_ms = cuda_ms(library_scan(store, plan, vargs, 16, mode), 1)
    torch.cuda.empty_cache()
    mac, ops, peak_ops, nbytes = scan_work(store, plan, order, d, 16, mode)
    bound = {"operations": ops / peak_ops * 1e3, "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    bound_by = max(bound, key=bound.get)
    before = read_counts()
    kd, ks = scan_kernel.scan_pairs(*vargs, **kw)
    mid = read_counts()
    pd_, ps_ = scan_kernel.scan_pairs(*pargs, **kw)
    after = read_counts()
    ran_v = {n: mid[n] - before[n] for n in before}
    ran_p = {n: after[n] - mid[n] for n in before}
    check(ran_v["scan_pairs"] == 1 and ran_v[body] == 1 and ran_p["scan_pairs"] == 1
          and ran_p[packed_body] == 1,
          f"{mode} at k_scan 16: the row map takes one launch of the {body}, the packed store "
          f"one of the {packed_body}: {ran_v}, {ran_p}")
    rd, rs = scan_kernel.scan_pairs_reference(*vargs, **kw)
    err, gap = compare_candidates(kd, ks, rd, rs, mode, f"flagship row map {mode}")
    same = ((kd.view(torch.int32) == pd_.view(torch.int32)) & (ks == ps_)).all(2)
    n_lists, n_same = same.numel(), int(same.sum())
    check(n_same == n_lists, f"{mode} at k_scan 16: {n_same} of {n_lists} row-map lists "
          f"bit-equal to the packed store's")
    f64 = ""
    if mode == "f32":  # the slots are the packed store's, so its rows give the float64 sums
        k_err = float64_error(packed, vargs[0], plan, kd, ks)
        p_err = float64_error(packed, vargs[0], plan, rd, rs)
        check(k_err <= p_err, f"row map f32: the kernel's error against float64 {k_err:.3g} "
              f"exceeds the plain version's {p_err:.3g}")
        f64 = (f"; against float64 (the first 16 pairs' candidates) kernel {k_err:.3g}, plain "
               f"{p_err:.3g}")
    log(f"[virtual] scan_pairs {mode} k_scan 16, row map (virtual store, {body}): kernel "
        f"{v_ms:.3f} ms ({', '.join(f'{t:.3f}' for t in runs['virtual'])}) against the packed "
        f"store's {packed_body} {p_ms:.3f} ms ({', '.join(f'{t:.3f}' for t in runs['packed'])}) "
        f"= {v_ms / p_ms:.3f}x; plain {plain_ms:.2f} ms; library (gather through the grid + "
        f"matmul + topk) {lib_ms:.2f} ms = {lib_ms / v_ms:.2f}x the kernel; bound "
        f"{bound[bound_by]:.3f} ms by {bound_by} ({ops:.4g} operations at {peak_ops / 1e12:g} "
        f"T/s = {bound['operations']:.3f} ms, {nbytes / 1e9:.3f} GB = {bound['bytes']:.3f} ms) = "
        f"{bound[bound_by] / v_ms:.1%} of it; {plan.n_pairs} pairs; agree, max|Δd|={err:.3g} "
        f"(at swapped slots {gap:.3g}); {n_same} of {n_lists} lists bit-equal to the packed "
        f"store's{f64}  [{smi}]")
    del vargs, pargs, kd, ks, rd, rs, pd_, ps_
    torch.cuda.empty_cache()
    return {"ms": v_ms, "packed_ms": p_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound[bound_by], "bound_by": bound_by, "err": err,
            "same_lists": n_same, "lists": n_lists}


def phase_virtual(dev, data: dict, ctx: dict, smi: str):
    """The main path over a virtual store: ``get_bucket_store`` of the
    device corpus (int8 + row scales) under the main path's index must be
    the id grid over the corpus itself.  Searches at visit 4, k 10, 10k
    queries, default and ``highest``, equal the packed store's, each one
    scan launch on the row-map wgmma body (bf16: body 10, f32: body 11);
    a ``k=1100`` search of 256 queries (``highest``; k_scan 1106: two
    rounds) equals exact kNN over the visited buckets, its rounds on the
    mma.sync body.  Then the row-map scan alone at ``k_scan`` 16 over the
    10k queries in bf16 and in f32 beside the packed scan
    (``row_map_scan``: bit-equal lists), and the ``k=1100`` search's scan
    alone; the phase's peak device memory."""
    corpus, row_scales, queries = data["corpus"], data["row_scales"], data["queries"]
    index, pred, packed = ctx["index"], ctx["data_prediction"], ctx["store"]
    nq, d = queries.shape[0], corpus.shape[1]
    t_all = time.perf_counter()

    def search(st, q, **kw):
        return index.search(None, q, None, q, pred, n_buckets=4, store=st, **kw)

    # ---- the path: every launch from here to the read counts ----
    reset_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    store = index.get_bucket_store((corpus, row_scales), pred)
    torch.cuda.synchronize()
    made_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    check(store.virtual and store.data_ref is corpus and store.row_scales is row_scales,
          "get_bucket_store of the device corpus is virtual over the corpus itself")
    check(store.nbytes() == store.chunk_ids.numel() * 4, "a virtual store's bytes are its id grid")
    pm = ctx["made"]
    log(f"[virtual] store over the device corpus: id grid {store.nbytes() / 1e6:.1f} MB against "
        f"the packed store's {pm['bytes'] / 1e9:.2f} GB ({pm['bytes'] / store.nbytes():.0f}x), "
        f"made in {made_s:.2f} s (packed {pm['s']:.2f} s); device memory while it was made: peak "
        f"{peak / 1e9:.2f} GB, {(peak - before) / 1e9:.3f} GB above what was resident (packed: "
        f"peak {pm['peak_gb']:.2f} GB, {pm['peak_added_gb']:.2f} GB above the corpus)  [{smi}]")
    for prec, body in (("default", WGMMA_INT8_ROWMAP), ("highest", WGMMA_F32MODE_ROWMAP)):
        search(store, queries, k=10, precision=prec)  # warm
        c0 = read_counts()
        t0 = time.perf_counter()
        vd, vi, _ = search(store, queries, k=10, precision=prec)
        tv = time.perf_counter() - t0
        ran = {n: v - c0[n] for n, v in read_counts().items()}
        check(ran["scan_pairs"] == 1 and ran[body] == 1,
              f"virtual {prec} search: one scan launch, on the {body}: {ran}")
        t0 = time.perf_counter()
        pd, pi, _ = search(packed, queries, k=10, precision=prec)
        tp = time.perf_counter() - t0
        check(vd.shape == (nq, 10) and bool(np.isfinite(vd).all()) and bool((vi > 0).all()),
              f"virtual {prec}: finite, filled")
        n_tied = same_neighbors(vd, vi, pd, pi, f"virtual vs packed, precision={prec}")
        log(f"[virtual] search precision={prec}, n_buckets=4, k=10: {tv:.4f} s per {nq} queries "
            f"(packed {tp:.4f} s), its scan one launch of the {body}; equals the packed "
            f"store's search ({n_tied} ids differ at ties)")
    nc = 256
    qc = queries[:nc]
    c0 = read_counts()
    t0 = time.perf_counter()
    wd, wi, _ = search(store, qc, k=1100, precision="highest")
    tw = time.perf_counter() - t0
    ran = {n: v - c0[n] for n, v in read_counts().items()}
    rounds = ran["scan_pairs"]
    check(all(v == 0 for n, v in ran.items() if n.startswith("scan_pairs wgmma")),
          f"k=1100 over the virtual store: its rounds on the mma.sync body: {ran}")
    launches = read_counts()
    path_peak = torch.cuda.max_memory_allocated()
    # ------------------------------------------------------------------
    order_c, _ = index.compute_bucket_order(qc, 4, keep_on_device=True)
    # a second round runs where a visited bucket fills a 1024-wide list
    visited = np.unique(order_c[order_c >= 0].cpu().numpy())
    want = 1 + int((store.bucket_sizes[visited] >= scan_kernel.MAX_K).any())
    check(rounds == want, f"k=1100 (k_scan 1106) scanned in {rounds} launches, not {want} rounds")
    ref_d, ref_i = restricted_knn(store, qc, order_c, 1100)
    check(wd.shape == (nc, 1100), "k=1100: result shape")
    n_tied = same_neighbors(wd, wi, ref_d.cpu().numpy(), ref_i.cpu().numpy(),
                            "k=1100 over the virtual store vs visited-bucket exact kNN")
    log(f"[virtual] k=1100, precision=highest, {nc} queries at n_buckets=4: {tw:.4f} s, {rounds} scan "
        f"launch(es) (rounds, mma.sync body); equals exact kNN over the visited buckets ({n_tied} "
        f"ids differ at ties); the path's peak device memory {path_peak / 1e9:.2f} GB  [{smi}]")
    del ref_d, ref_i, wd, wi

    # ---- the row-map scans alone, beside the packed scans ----
    order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
    scans = {mode: row_map_scan(store, packed, queries, order, mode, smi)
             for mode in ("bf16", "f32")}
    # the k=1100 search's scan alone (k_scan 1106 in f32 over its 256
    # queries): the first round (1024 wide) and both rounds, beside k 16
    wplan, wargs = scan_inputs(store, qc, order_c, 128, "f32")
    wide = {kk: cuda_ms(lambda: scan_kernel.scan_pairs(*wargs, k=kk, qtile=128,
                                                       chunk=store.chunk, mode="f32"), 1)
            for kk in (16, 1024, 1106)}
    wide_plain = cuda_ms(lambda: scan_kernel.scan_pairs_reference(
        *wargs, k=1106, qtile=128, chunk=store.chunk, mode="f32"), 1)
    # the library call on the same inputs: per visited bucket, the rows gathered
    # through the grid, one f32 matmul (TF32 off) and torch.topk(k=1106)
    wide_lib = cuda_ms(library_scan(store, wplan, wargs, 1106, "f32"), 1)
    _, w_ops, w_peak, w_bytes = scan_work(store, wplan, order_c, d, 1106, "f32")
    w_bound = {"operations": w_ops / w_peak * 1e3, "bytes": w_bytes / HBM_BYTES_PER_S * 1e3}
    w_by = max(w_bound, key=w_bound.get)
    log(f"[virtual] scan_pairs f32, row map, the k=1100 search's {nc} queries: k_scan 16 "
        f"{wide[16]:.2f} ms, the 1024-wide first round {wide[1024]:.2f} ms, k_scan 1106 in two "
        f"rounds {wide[1106]:.2f} ms; plain at 1106 {wide_plain:.2f} ms; library (gather through "
        f"the grid + f32 matmul + topk(1106) a bucket) {wide_lib:.2f} ms = "
        f"{wide_lib / wide[1106]:.2f}x the kernel; bound at 1106 {w_bound[w_by]:.3f} ms by {w_by} "
        f"({w_ops:.4g} operations at {w_peak / 1e12:g} T/s = {w_bound['operations']:.3f} ms, "
        f"{w_bytes / 1e9:.3f} GB = {w_bound['bytes']:.3f} ms) = {w_bound[w_by] / wide[1106]:.1%} "
        f"of it; {wplan.n_pairs} pairs  [{smi}]")
    log(f"[virtual] total {time.perf_counter() - t_all:.1f} s; peak device memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB  [{smi}]")
    del store, wargs, wplan
    torch.cuda.empty_cache()
    out = dict(scans["bf16"])
    out.update({"err": max(t["err"] for t in scans.values()), "f32": scans["f32"],
                "wide_ms": wide, "wide_plain_ms": wide_plain, "wide_library_ms": wide_lib,
                "wide_bound_ms": w_bound[w_by], "wide_bound_by": w_by})
    return launches, out


def phase_sharded(dev, data: dict, ctx: dict, packed_scan_ms: float, smi: str):
    """The main path over a store sharded by bucket over ``[dev] * 4`` (the
    card has one GPU, so the four shards take turns on it): from the
    device corpus (``get_sharded_store``, chunk 256, the JAX package's
    default off the TPU) and from the packed store
    (``shard_packed_store``).  A visit-4 default search with rerank of
    the 10k queries equals the single store's and launches the scan once
    a shard; then each shard's rows, pairs and scan time (CUDA events)
    beside the single store's scan."""
    corpus, row_scales, queries = data["corpus"], data["row_scales"], data["queries"]
    index, pred, packed = ctx["index"], ctx["data_prediction"], ctx["store"]
    nq, n = queries.shape[0], corpus.shape[0]
    devices = [dev] * 4
    t_all = time.perf_counter()

    def search(st):
        return index.search(None, queries, None, queries, pred, n_buckets=4, k=10, store=st)

    ref_d, ref_i, _ = search(packed)
    single = []
    for _ in range(3):
        t0 = time.perf_counter()
        search(packed)
        single.append(time.perf_counter() - t0)

    # ---- the path: every launch from here to the read counts ----
    reset_counts()
    stores = {}
    for kind in ("corpus", "packed"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        if kind == "corpus":
            sharded = index.get_sharded_store((corpus, row_scales), pred, devices)
        else:
            sharded = lmi.shard_packed_store(packed, devices)
        torch.cuda.synchronize()
        made_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        rows = [int(sh.bucket_sizes.sum()) for sh in sharded.shards]
        check(isinstance(sharded, lmi.ShardedStore) and len(sharded.shards) == 4
              and all(sh.device == dev for sh in sharded.shards), f"sharded ({kind}): 4 shards")
        check(sum(rows) == n, f"sharded ({kind}): every row in one shard")
        search(sharded)  # warm
        b0 = scan_kernel.LAUNCHES
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            sd, si, _ = search(sharded)
            times.append(time.perf_counter() - t0)
        per_search = (scan_kernel.LAUNCHES - b0) / 3
        check(per_search == 4, f"sharded ({kind}): {per_search} scan launches a search, not 4")
        n_tied = same_neighbors(sd, si, ref_d, ref_i, f"sharded ({kind}) vs the single store")
        stores[kind] = sharded
        log(f"[sharded] from the {kind}: 4 shards on {dev}, chunk {sharded.chunk}, rows "
            f"{rows}, {sharded.nbytes() / 1e9:.2f} GB in {made_s:.2f} s (device memory peak "
            f"{peak / 1e9:.2f} GB, {(peak - before) / 1e9:.2f} GB above what was resident); "
            f"search default, n_buckets=4, k=10: reps {[round(t, 4) for t in times]} s, mean "
            f"{np.mean(times):.4f} s per {nq} queries against the single store's "
            f"{np.mean(single):.4f} s = {np.mean(times) / np.mean(single):.3f}x; 4 scan launches "
            f"a search; equals the single store's search ({n_tied} ids differ at ties)  [{smi}]")
    launches = read_counts()
    # ------------------------------------------------------------------

    order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
    valid = order >= 0
    at = order.clamp_min(0).long()
    timing = {}
    for kind, sharded in stores.items():
        owner = torch.as_tensor(sharded.bucket_device, device=dev)[at]
        local = torch.as_tensor(sharded.bucket_local, device=dev)[at]
        per = []
        for i, shard in enumerate(sharded.shards):
            plan, sargs = scan_inputs(shard, queries, torch.where(valid & (owner == i), local, -1),
                                      128, "bf16")
            ms = cuda_ms(lambda: scan_kernel.scan_pairs(*sargs, k=16, qtile=128,
                                                        chunk=shard.chunk, mode="bf16"), 3)
            per.append((int(shard.bucket_sizes.sum()), plan.n_pairs, ms))
        total = sum(t for _, _, t in per)
        timing[kind] = total
        log(f"[sharded] from the {kind}: scan bf16 a shard (rows, pairs, ms): "
            f"{[(r, p, round(t, 3)) for r, p, t in per]}; sum {total:.3f} ms against the single "
            f"store's scan {packed_scan_ms:.3f} ms = {total / packed_scan_ms:.3f}x  [{smi}]")
    log(f"[sharded] total {time.perf_counter() - t_all:.1f} s")
    del stores, sharded
    torch.cuda.empty_cache()
    return launches, timing


def gather_vs_plain(table, idx, what: str, smi: str) -> dict:
    """The row gather kernel against its plain version on one (table,
    idx): bit-equal, then the kernel, the plain version and the library
    call (one ``index_select`` on indices clamped beforehand) timed with
    CUDA events, back to back (``cuda_ms``) and queued behind a spin
    (``queued_ms``, the device's time alone).  The bound is the bytes
    moved (rows read and written once, the indices read once) over
    3.35 TB/s."""
    got = gather_kernel.gather_rows(table, idx)
    torch.cuda.synchronize()
    ref = gather_kernel.gather_rows_reference(table, idx)
    check(got.dtype == ref.dtype and got.shape == ref.shape, f"gather {what}: shape and type")
    check(torch.equal(got.view(torch.uint8), ref.view(torch.uint8)), f"gather {what}: bit-equal")
    wide = torch.float64 if got.dtype.is_floating_point else torch.int64
    err = float((got.to(wide) - ref.to(wide)).abs().max()) if got.numel() else 0.0
    clamped = idx.long().clamp(0, table.shape[0] - 1)
    fns = {"kernel": lambda: gather_kernel.gather_rows(table, idx),
           "plain": lambda: gather_kernel.gather_rows_reference(table, idx),
           "index_select": lambda: torch.index_select(table, 0, clamped)}
    ms = {name: cuda_ms(fn, 10) for name, fn in fns.items()}
    queued = {name: queued_ms(fn, 10) for name, fn in fns.items()}
    k_ms, p_ms, lib_ms = ms["kernel"], ms["plain"], ms["index_select"]
    row_bytes = table.shape[1] * table.element_size()
    moved = 2 * idx.shape[0] * row_bytes + idx.shape[0] * idx.element_size()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"[gather-vs-plain] {what}: table {tuple(table.shape)} {table.dtype}, {idx.shape[0]} "
        f"indices: bit-equal; kernel {k_ms:.4f} ms ({moved / k_ms / 1e6:.1f} GB/s, "
        f"{moved / k_ms / 1e-3 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s), plain {p_ms:.4f} ms, "
        f"index_select {lib_ms:.4f} ms; queued (device time alone): "
        + ", ".join(f"{n} {v:.4f} ms" for n, v in queued.items())
        + f"; bound {bound_ms:.4f} ms  [{smi}]")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "err": err,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def pairs_vs_plain(cand_d, cand_s, rows, V: int, smi: str) -> dict:
    """The merge gather kernel against its plain version (torch indexing
    and two ``torch.where``, what auto mode runs) on the merge's inputs:
    bit-equal, then both timed with CUDA events, back to back
    (``cuda_ms``: at this size the host's rate of launching) and queued
    behind a spin (``queued_ms``: the device's time alone, which the
    kernels line reports), beside the bound (both tables' rows read and
    written once, the row indices read once, over 3.35 TB/s) and the
    library's part of the work: one ``index_select`` per table on rows
    clamped beforehand, without the mask.  No single PyTorch call
    computes the masked gather of both tables, so the kernels line gives
    ``library_ms`` null for it."""
    gd, gs = gather_kernel.gather_pairs(cand_d, cand_s, rows, V)
    torch.cuda.synchronize()
    rd, rs = gather_kernel.gather_pairs_reference(cand_d, cand_s, rows, V)
    check(gd.shape == rd.shape and gs.dtype == rs.dtype, "gather_pairs: shapes and types")
    check(torch.equal(gd.view(torch.int32), rd.view(torch.int32)) and torch.equal(gs, rs),
          "gather_pairs: bit-equal to its plain version")
    clamped = rows.clamp(0, cand_d.shape[0] - 1)

    def two_index_selects():
        torch.index_select(cand_d, 0, clamped)
        torch.index_select(cand_s, 0, clamped)

    fns = {"kernel": lambda: gather_kernel.gather_pairs(cand_d, cand_s, rows, V),
           "plain": lambda: gather_kernel.gather_pairs_reference(cand_d, cand_s, rows, V),
           "library": two_index_selects}
    ms = {name: cuda_ms(fn, 50) for name, fn in fns.items()}
    queued = {name: queued_ms(fn, 50) for name, fn in fns.items()}
    k_ms, p_ms, lib_ms = ms["kernel"], ms["plain"], ms["library"]
    moved = 2 * rows.shape[0] * cand_d.shape[1] * 8 + rows.shape[0] * rows.element_size()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"[gather-vs-plain] merge gather_pairs: tables {tuple(cand_d.shape)} f32 + int32, "
        f"{rows.shape[0]} rows: bit-equal; kernel {k_ms:.4f} ms ({moved / k_ms / 1e6:.1f} GB/s), "
        f"plain (indexing + 2 where) {p_ms:.4f} ms, 2 x index_select (no mask) {lib_ms:.4f} ms; "
        f"with the calls queued behind a spin (device time alone): kernel {queued['kernel']:.4f} "
        f"ms ({moved / queued['kernel'] / 1e6:.1f} GB/s), plain {queued['plain']:.4f} ms, "
        f"2 x index_select {queued['library']:.4f} ms; bound {bound_ms:.4f} ms by bytes "
        f"({moved / 1e6:.2f} MB)  [{smi}]")
    return {"ms": queued["kernel"], "plain_ms": queued["plain"], "library_ms": None, "err": 0.0,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """Host microseconds a call of ``fn``: ``calls`` calls enqueued back
    to back without a sync (after one warm call and a sync)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def host_us_rounds(fns: dict) -> dict:
    """``host_us`` of each of ``fns`` in HOST_ROUNDS rounds, the order
    reversed every other round: ``(median, min, max)`` microseconds."""
    seen = {name: [] for name in fns}
    for r in range(HOST_ROUNDS):
        for name in list(fns) if r % 2 == 0 else list(fns)[::-1]:
            seen[name].append(host_us(fns[name]))
    return {name: (float(np.median(v)), min(v), max(v)) for name, v in seen.items()}


def gather_rows_as_before(table, idx):
    """The host path of ``gather_rows`` before the merge gather kernel:
    the same checks and the same launch, but the device context entered
    on every call, the stream fetched inside it and the indices passed
    through ``.contiguous()`` (for the host-time comparison only; it does
    not count launches)."""
    gather_kernel._check(table, idx)
    if not table.is_contiguous():
        raise ValueError("gather_rows: the table must be contiguous")
    idx = idx.contiguous()
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    lib = cuda_build.load(gather_kernel.SOURCE, gather_kernel._bind)
    with torch.cuda.device(table.device):
        err = lib.lmi_gather_rows(
            table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), out.data_ptr(),
            idx.shape[0], table.shape[0], table.shape[1] * table.element_size(),
            torch.cuda.current_stream().cuda_stream,
        )
    check(err == 0, f"gather_rows launch failed: cudaError {err}")
    return out


def gather_split(store, queries, plan, sargs, cand_d, cand_s, smi: str) -> None:
    """Where the gather-kernel mode's time went before the scan read the
    work queries through ``qidx`` (the prediction is in PERF.md): on the
    built index's plan, by CUDA events, the scan on the work-query rows
    gathered as the JAX package does (padding rows zeroed, read through
    the identity index) against the scan reading the Q query rows through
    ``qidx`` (same bits), ``operand_queries`` on each, that gather
    itself, and the merge's gathers (two ``gather_rows`` and two
    ``torch.where`` before, one ``gather_pairs`` now, torch indexing in
    auto mode); then the host time of one call of each gather."""
    dev = queries.device
    qidx, rows = plan.qidx, plan.pair_rows
    valid = qidx >= 0
    ident = torch.where(valid, torch.arange(qidx.shape[0], dtype=torch.int32, device=dev), -1)

    def work_rows():  # the work-query gather of the JAX package's kernel mode
        return (torch.where(valid[:, None], gather_kernel.gather_rows(queries, qidx), 0.0),
                ident.to(torch.int32))

    mq, mqidx = work_rows()
    margs = (mq, mqidx, *sargs[2:])
    kw = dict(k=16, qtile=128, chunk=store.chunk, mode="bf16")
    md, ms = scan_kernel.scan_pairs(*margs, **kw)
    check(torch.equal(md.reshape(cand_d.shape).view(torch.int32), cand_d.view(torch.int32))
          and torch.equal(ms.reshape(cand_s.shape), cand_s),
          "gather split: the scan gives the same bits on gathered rows and through qidx")
    scan_q = cuda_ms(lambda: scan_kernel.scan_pairs(*sargs, **kw), 5)
    scan_rows = cuda_ms(lambda: scan_kernel.scan_pairs(*margs, **kw), 5)
    dtype = store.chunk_data.dtype
    body = scan_kernel.scan_body(cuda_build.load(scan_kernel.SOURCE, scan_kernel._bind),
                                 store.chunk_data, "bf16", 16)
    qd = body.qd if body.wgmma else 0
    op_q = cuda_ms(lambda: scan_kernel.operand_queries(queries, "bf16", dtype, qd), 20)
    op_rows = cuda_ms(lambda: scan_kernel.operand_queries(mq, "bf16", dtype, qd), 20)
    gather_ms = cuda_ms(work_rows, 20)
    ok = (rows >= 0)[:, None]

    def merge_before():  # kernel mode's merge gather before: two launches, two masks
        torch.where(ok, gather_kernel.gather_rows(cand_d, rows), torch.inf)
        torch.where(ok, gather_kernel.gather_rows(cand_s, rows), -1)

    NOW, AUTO, BEFORE = ("gather_pairs (kernel mode now)", "indexing + 2 where (auto mode)",
                         "2 gather_rows + 2 where (kernel mode before)")
    merge = {NOW: lambda: gather_kernel.gather_pairs(cand_d, cand_s, rows, 4),
             AUTO: lambda: gather_kernel.gather_pairs_reference(cand_d, cand_s, rows, 4),
             BEFORE: merge_before}
    merge_ms = {name: cuda_ms(fn, 50) for name, fn in merge.items()}
    merge_queued = {name: queued_ms(fn, 50) for name, fn in merge.items()}
    merge_us = host_us_rounds(merge)
    clamped = rows.clamp(0, cand_d.shape[0] - 1)
    one_call = {"gather_rows": lambda: gather_kernel.gather_rows(cand_d, rows),
                "gather_rows, host path before": lambda: gather_rows_as_before(cand_d, rows),
                "index_select": lambda: torch.index_select(cand_d, 0, clamped),
                "gather_pairs": lambda: gather_kernel.gather_pairs(cand_d, cand_s, rows, 4)}
    call_us = host_us_rounds(one_call)
    auto = merge_ms[AUTO]
    log(f"[gather-split] scan (bf16, k_scan 16) through qidx on {queries.shape[0]} query rows "
        f"{scan_q:.3f} ms; on {mq.shape[0]} gathered work-query rows {scan_rows:.3f} ms "
        f"({scan_rows - scan_q:+.3f} ms); operand_queries inside it: {op_q:.4f} ms on "
        f"{queries.shape[0]} rows, {op_rows:.4f} ms on {mq.shape[0]} ({op_rows - op_q:+.4f} ms); "
        f"the work-query gather (gather_rows + where) {gather_ms:.4f} ms  [{smi}]")
    log(f"[gather-split] merge gather, CUDA events: "
        + ", ".join(f"{n} {v:.4f} ms" for n, v in merge_ms.items())
        + "; queued behind a spin (device time alone): "
        + ", ".join(f"{n} {v:.4f} ms" for n, v in merge_queued.items())
        + f"; host time a call, median (min-max) of {HOST_ROUNDS} rounds in turns: "
        + ", ".join(f"{n} {v[0]:.1f} ({v[1]:.1f}-{v[2]:.1f}) us" for n, v in merge_us.items()))
    log(f"[gather-split] host time of one call ({HOST_CALLS} calls without a sync, table "
        f"{tuple(cand_d.shape)}), median (min-max) of {HOST_ROUNDS} rounds in turns: "
        + ", ".join(f"{n} {v[0]:.1f} ({v[1]:.1f}-{v[2]:.1f}) us" for n, v in call_us.items()))
    before = scan_rows - scan_q + gather_ms + merge_ms[BEFORE] - auto
    log(f"[gather-split] device time kernel mode spends beyond auto mode a search, by CUDA "
        f"events: before {before:.3f} ms (scan on rows {scan_rows - scan_q:+.3f}, work-query "
        f"gather {gather_ms:.3f}, merge {merge_ms[BEFORE] - auto:+.4f}); now "
        f"{merge_ms[NOW] - auto:+.4f} ms (the merge only)")


def visited_recall(index, store, queries, n_buckets, ids, policy, nc=256) -> float:
    """Recall@10 of ``ids`` against exact kNN over the buckets each of the
    first ``nc`` queries visits."""
    order, _ = index.compute_bucket_order(queries[:nc], n_buckets, policy=policy,
                                          keep_on_device=True)
    _, ref_i = restricted_knn(store, queries[:nc], order, 10)
    return recall(ids[:nc], ref_i.cpu().numpy(), 10)


def phase_build_path(dev, data: dict, smi: str):
    """The build path at full width: LearnedIndexBuilder → save → load →
    packed store → search in both gather modes; then the 2-level index.
    Returns the launches, the gather timings and the 1-level index with
    its store, which the dynamic path takes over."""
    corpus, row_scales, queries, gt_ids = (data[k] for k in ("corpus", "row_scales", "queries",
                                                               "gt_ids"))
    nq, chunk = queries.shape[0], 2048
    t_all = time.perf_counter()

    def build(cats):
        cfg = lmi.BuildConfiguration(
            ["kmeans"], [4], ["MLP-4"], [0.01], cats, seed=2023, batch_size=1024,
            chunk_size=chunk, dtype="bfloat16", class_weights="balanced", update_rule="minibatch",
        )
        torch.cuda.synchronize()
        builder = lmi.LearnedIndexBuilder((corpus, row_scales), cfg, device=dev)
        index, pred, n_buckets, build_t, cluster_t = builder.build()
        torch.cuda.synchronize()
        sizes = np.bincount(index.bucket_ids_from_prediction(pred), minlength=index.layout.n_leaves)
        check(n_buckets == index.layout.n_leaves and (sizes > 0).all(), f"{cats}: no empty bucket")
        check(pred.shape == (corpus.shape[0], len(cats)) and (pred >= 0).all(), "data_prediction")
        log(f"[build] {cats}: {n_buckets} buckets in {build_t:.1f} s (cluster {cluster_t:.1f} s, "
            f"train {build_t - cluster_t:.1f} s), coverage rounds per level {builder.rounds}; "
            f"bucket sizes min {sizes.min()} median {int(np.median(sizes))} max {sizes.max()}  "
            f"[{smi}]")
        return index, pred

    def search(index, store, pred, n_buckets, policy="best_first"):
        return index.search(None, queries, None, queries, pred, n_buckets=n_buckets, k=10,
                            store=store, policy=policy)

    # ---- 1 level, 120 buckets, through save and load ----
    index, pred = build([120])
    path = WORK_DIR / "built_index.npz"
    lmi.save_index(index, str(path), pred)
    index, saved_pred = lmi.LearnedIndex.load(str(path), dev)
    check(np.array_equal(saved_pred, pred), "data_prediction survives the .npz round trip")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    store = index.prepare_packed_store((corpus, row_scales), saved_pred)
    torch.cuda.synchronize()
    log(f"[build] saved, reloaded, packed store {store.nbytes() / 1e9:.2f} GB in "
        f"{time.perf_counter() - t0:.1f} s")

    # ---- both gather modes: each one's first call, then warm rounds in turns ----
    cold = gather_kernel.SOURCE not in cuda_build._loaded  # the gather library not yet loaded
    reset_counts()
    results, first, rounds = {}, {}, {"auto": [], "kernel": []}
    per_mode = {m: dict.fromkeys(read_counts(), 0) for m in rounds}
    for r in range(1 + MODE_ROUNDS):
        for mode in ("auto", "kernel") if r % 2 == 0 else ("kernel", "auto"):
            os.environ["LMI_GATHER_MODE"] = mode
            before = read_counts()
            t0 = time.perf_counter()
            dists, ids, _ = search(index, store, saved_pred, 4)  # ends in a copy to the host
            seconds = time.perf_counter() - t0
            for key, n in read_counts().items():
                per_mode[mode][key] += n - before[key]
            if r == 0:
                first[mode], results[mode] = seconds, (dists, ids)
            else:
                rounds[mode].append(seconds)
                same = np.array_equal(dists.view(np.uint32), results[mode][0].view(np.uint32))
                check(same and np.array_equal(ids, results[mode][1]),
                      f"{mode}: the same bits each round")
    counts = read_counts()
    os.environ["LMI_GATHER_MODE"] = "auto"
    n_search = 1 + MODE_ROUNDS
    # 10k queries at visit 4 over the built index: no pair splits, so no merge
    check(per_mode["auto"] == {"scan_pairs": n_search, "scan_merge": 0, "scan_split": 0,
                               "gather_pairs": 0, "gather_rows": 0, WGMMA_INT8: n_search,
                               WGMMA_F32: 0, WGMMA_F32MODE: 0, WGMMA_WIDE: 0, WGMMA_F32X: 0,
                               WGMMA_S8: 0, WGMMA_S8_WIDE: 0, WGMMA_F32MODE_WIDE: 0,
                               WGMMA_F32_WIDE: 0, WGMMA_INT8_ROWMAP: 0, WGMMA_F32MODE_ROWMAP: 0},
          f"auto mode launches one scan, no merge and no gather a search: {per_mode['auto']}")
    check(per_mode["kernel"] == {"scan_pairs": n_search, "scan_merge": 0, "scan_split": 0,
                                 "gather_pairs": n_search, "gather_rows": 0, WGMMA_INT8: n_search,
                                 WGMMA_F32: 0, WGMMA_F32MODE: 0, WGMMA_WIDE: 0,
                                 WGMMA_F32X: 0, WGMMA_S8: 0, WGMMA_S8_WIDE: 0,
                                 WGMMA_F32MODE_WIDE: 0, WGMMA_F32_WIDE: 0,
                                 WGMMA_INT8_ROWMAP: 0, WGMMA_F32MODE_ROWMAP: 0},
          f"kernel mode launches one scan and one merge gather a search: {per_mode['kernel']}")
    for mode in ("auto", "kernel"):
        t = np.asarray(rounds[mode])
        log(f"[search] built index, LMI_GATHER_MODE={mode}: first call {first[mode]:.4f} s"
            f"{' (loads the gather library)' if mode == 'kernel' and cold else ''}; "
            f"{MODE_ROUNDS} warm rounds in turns {[round(float(x), 5) for x in t]} s per {nq} "
            f"queries, "
            f"mean {t.mean():.5f}, median {np.median(t):.5f}, min {t.min():.5f}, max {t.max():.5f} "
            f"s; launches a search {({k: v // n_search for k, v in per_mode[mode].items()})}  "
            f"[{smi}]")
    auto_t, kern_t = np.asarray(rounds["auto"]), np.asarray(rounds["kernel"])
    log(f"[search] built index, kernel - auto: mean {kern_t.mean() - auto_t.mean():+.5f} s, "
        f"median {np.median(kern_t) - np.median(auto_t):+.5f} s; auto's spread (max - min) "
        f"{auto_t.max() - auto_t.min():.5f} s, kernel's {kern_t.max() - kern_t.min():.5f} s; "
        f"first calls: kernel - auto {first['kernel'] - first['auto']:+.4f} s")
    (da, ia), (dk, ik) = results["auto"], results["kernel"]
    check(np.array_equal(da.view(np.uint32), dk.view(np.uint32)) and np.array_equal(ia, ik),
          "gather modes auto and kernel give bit-identical results")
    check(bool(np.isfinite(dk).all()) and bool((ik > 0).all()), "built index: finite, filled")
    r_vis = visited_recall(index, store, queries, 4, ik, "best_first")
    check(r_vis >= 0.999, f"built index: recall {r_vis} vs visited-bucket exact")
    log(f"[check] built index: auto and kernel bit-identical; recall@10 vs visited-bucket exact "
        f"kNN = {r_vis:.4f} (256 queries)")
    log(f"[recall] built index: whole-corpus recall@10 of the {nq} queries at n_buckets=4 vs "
        f"exact f32 kNN: {recall(ik, gt_ids, 10):.4f}")

    # ---- the gather split, then both gather kernels against their plain versions ----
    order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
    plan, sargs = scan_inputs(store, queries, order, 128, "bf16")
    cand_d, cand_s = scan_kernel.scan_pairs(*sargs, k=16, qtile=128, chunk=chunk, mode="bf16")
    cand_d, cand_s, rows = cand_d.reshape(-1, 16), cand_s.reshape(-1, 16), plan.pair_rows
    gather_split(store, queries, plan, sargs, cand_d, cand_s, smi)
    timing = {"merge": pairs_vs_plain(cand_d, cand_s, rows, 4, smi),
              "work queries": gather_vs_plain(queries, plan.qidx, "work queries", smi)}
    timing["merge dists"] = gather_vs_plain(cand_d, rows, "merge dists", smi)
    timing["merge slots"] = gather_vs_plain(cand_s, rows, "merge slots", smi)
    g = torch.Generator(device=dev).manual_seed(5)
    slots = torch.randint(0, store.chunk_data.shape[0], (nq * 16,), generator=g, device=dev)
    timing["store rows"] = gather_vs_plain(store.chunk_data, slots, "store rows", smi)
    n_slots = store.chunk_data.shape[0]
    wild = torch.tensor([-7, -1, 0, 5, n_slots - 1, n_slots, n_slots + 9, 2**31 - 1],
                        dtype=torch.int32, device=dev)
    timing["out of range"] = gather_vs_plain(store.chunk_data, wild, "out-of-range indices", smi)
    del cand_d, cand_s, plan, sargs
    torch.cuda.empty_cache()

    # ---- 2 levels [10, 10], best-first in gather-kernel mode ----
    index2, pred2 = build([10, 10])
    store2 = index2.prepare_packed_store((corpus, row_scales), pred2)
    os.environ["LMI_GATHER_MODE"] = "kernel"
    reset_counts()
    two = {}
    for visit in (1, 2, 4, 8):
        t0 = time.perf_counter()
        d2, i2, _ = search(index2, store2, pred2, visit)
        two[visit] = (time.perf_counter() - t0, d2, i2)
    dj, ij, _ = search(index2, store2, pred2, 4, policy="joint")
    counts2 = read_counts()
    os.environ["LMI_GATHER_MODE"] = "auto"
    check(counts2["gather_pairs"] > 0 and counts2["scan_pairs"] > 0
          and counts2["gather_rows"] == 0,
          f"2-level searches launch the scan and the merge gather, no row gather: {counts2}")
    for visit, (seconds, d2, i2) in two.items():
        check(d2.shape == (nq, 10) and bool(np.isfinite(d2).all()) and bool((i2 > 0).all()),
              f"2-level best_first visit {visit}: finite, filled")
        log(f"[search] 2-level best_first, visit {visit}: {seconds:.4f} s per {nq} queries; "
            f"whole-corpus recall@10 {recall(i2, gt_ids, 10):.4f}")
    check(dj.shape == (nq, 10) and bool(np.isfinite(dj).all()), "2-level joint: finite")
    log(f"[search] 2-level joint, visit 4: whole-corpus recall@10 {recall(ij, gt_ids, 10):.4f}")
    r2 = visited_recall(index2, store2, queries, 4, two[4][2], "best_first")
    check(r2 >= 0.999, f"2-level best_first: recall {r2} vs visited-bucket exact")
    log(f"[check] 2-level best_first visit 4: recall@10 vs visited-bucket exact kNN = {r2:.4f} "
        f"(256 queries); launches {counts2}")
    del store2
    torch.cuda.empty_cache()
    launches = {k: counts[k] + counts2[k] for k in counts2}
    log(f"[build-path] total {time.perf_counter() - t_all:.1f} s")
    return launches, timing, (index, store)


def synced(fn):
    """``(fn(), seconds)`` with the device synchronized around it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_under_load(server, host_q: np.ndarray, pool: np.ndarray, serve_s: float):
    """16 client threads send 64-query requests of ``host_q`` to
    ``server`` for ``serve_s`` seconds while a thread inserts 64-row
    batches of ``pool``, checks that a search submitted after each insert
    finds it, and deletes half of each batch.  Fails on any error.
    Returns (sorted request latencies in ms, seconds elapsed, the
    mutator's counts, the server's stats before and after)."""
    nq = host_q.shape[0]
    stop = threading.Event()
    lat, errors, mutated = [], [], {"inserts": 0, "deletes": 0}

    def client(seed):
        r = np.random.default_rng(seed)
        try:
            while not stop.is_set():
                s0 = int(r.integers(0, nq - 64))
                t0 = time.perf_counter()
                dd, _ = server.search(host_q[s0 : s0 + 64])
                lat.append(time.perf_counter() - t0)
                check(dd.shape == (64, 10), "served answer shape")
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def mutator():
        try:
            for b in range(len(pool) // 64):
                if stop.is_set():
                    break
                rows = pool[b * 64 : (b + 1) * 64]
                ids = server.insert(rows)
                mutated["inserts"] += 64
                _, got = server.search(rows[:4], k=1)  # submitted after the insert returned
                check(np.array_equal(got[:, 0], ids[:4]), "a search after an insert sees it")
                mutated["deletes"] += server.delete(ids[::2])
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(16)]
    threads.append(threading.Thread(target=mutator))
    st0 = server.stats()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    time.sleep(serve_s)
    stop.set()
    for t in threads:
        t.join(120)
    elapsed = time.perf_counter() - t0
    check(not errors, f"serving: {errors[:3]}")
    return np.sort(np.asarray(lat)) * 1e3, elapsed, mutated, st0, server.stats()


def phase_dynamic(dev, index, store, data: dict, smi: str, n_insert: int = 500_000,
                  n_delete: int = 250_000, serve_s: float = 10.0):
    """Mutation and serving on the flagship index the build path built (1
    level, 120 buckets, MLP-4, the 10M×768 int8 store, taken over by
    ``DynamicIndex(index, store)`` without a copy): insert 500,000 rows of
    the corpus's mixture in one batch (pool chunks, growth), then 64
    batches of 64 rows, delete 250,000 ids (half inserted, half original);
    search 10k queries at visit 4, k=10, at the default precision and at
    ``highest`` (gather modes in turns) against exact kNN over the visited
    buckets of the mutated store, no deleted id returned, inserted rows
    finding themselves; the scan kernel against its plain version on the
    mutated plan (a chunk list out of the identity); compaction with
    bit-identical search output; then ``SearchServer`` with 16 client
    threads for ~10 s while a thread inserts and deletes, and one call to
    each HTTP endpoint.  No kernel may be built anew in the phase.
    Returns the phase's launches (the kernel-vs-plain comparison's not
    counted), its numbers and the mutated ``DynamicIndex``, which
    ``phase_multi_mutation`` promotes to a sharded store."""
    from learnedmetricindex_tpu_torch.serve import SearchServer, make_http_server

    queries, nq, d = data["queries"], data["queries"].shape[0], store.chunk_data.shape[1]
    t_all = time.perf_counter()
    builds = cuda_build.BUILDS
    dyn = lmi.DynamicIndex(index, store)
    check(dyn.store.chunk_data is store.chunk_data, "DynamicIndex(index, store) makes no copy")
    del store
    n_orig, chunks0 = dyn.n_rows, dyn.store.n_chunks
    gen = BlobGenerator(256, d, seed=2023, noise=0.45, device=dev)  # the corpus's mixture
    gen.generator.manual_seed(2024)  # drawn anew
    new_rows = gen.rows(n_insert)
    small = [gen.rows(64) for _ in range(64)]
    growth = []
    grow = mutation._grow

    def timed_grow(st, extra):
        out, seconds = synced(lambda: grow(st, extra))
        growth.append((extra, seconds))
        return out

    out = {}
    reset_counts()
    excluded = read_counts()  # launches made only to compare with the plain version
    torch.cuda.reset_peak_memory_stats()
    mutation._grow = timed_grow
    try:
        ids_big, t_big = synced(lambda: dyn.insert(new_rows))
        t_small = [synced(lambda: dyn.insert(rows))[1] for rows in small]
    finally:
        mutation._grow = grow
    ptr, clist = dyn.store.chunk_list()
    check(dyn.store.n_chunks > chunks0 and len(growth) >= 1, "the large insert grew the store")
    check(not np.array_equal(clist, np.arange(len(clist))), "buckets took chunks from the pool")
    rng = np.random.default_rng(11)
    victims = np.concatenate([rng.choice(ids_big, n_delete // 2, replace=False),
                              rng.choice(np.arange(1, n_orig + 1), n_delete // 2, replace=False)])
    n_del, t_del = synced(lambda: dyn.delete(victims))
    check(n_del == n_delete and dyn.n_rows == n_orig + n_insert + 64 * 64 - n_delete,
          f"{n_delete} deleted ({n_del}), live rows counted")
    peak_mut = torch.cuda.max_memory_allocated()
    out["insert_us_big"] = t_big / n_insert * 1e6
    out["insert_us_64"] = float(np.median(t_small)) / 64 * 1e6
    log(f"[dynamic] insert {n_insert} rows in one batch: {t_big:.3f} s = {out['insert_us_big']:.3f} "
        f"us a row; 64 batches of 64: median {np.median(t_small) * 1e3:.3f} ms (min "
        f"{min(t_small) * 1e3:.3f}, max {max(t_small) * 1e3:.3f}) = {out['insert_us_64']:.2f} us a "
        f"row; growth {[(n, round(t, 4)) for n, t in growth]} (chunks, s); delete {n_delete} ids "
        f"(half inserted, half original) {t_del:.3f} s = {t_del / n_delete * 1e6:.3f} us an id; "
        f"chunks {chunks0} -> "
        f"{dyn.store.n_chunks} ({len(clist)} listed), live rows {dyn.n_rows}; peak device memory "
        f"{peak_mut / 1e9:.2f} GB  [{smi}]")

    # ---- search the mutated store, gather modes in turns ----
    results = {}
    for prec, mode in (("default", "auto"), ("default", "kernel"), ("highest", "kernel"),
                       ("highest", "auto")):
        os.environ["LMI_GATHER_MODE"] = mode
        t0 = time.perf_counter()
        dd, ii, _ = dyn.search(queries, n_buckets=4, k=10, precision=prec)
        seconds = time.perf_counter() - t0
        check(dd.shape == (nq, 10) and bool(np.isfinite(dd).all()) and bool((ii > 0).all()),
              f"mutated {prec}: finite, filled")
        check(not np.isin(ii, victims).any(), f"mutated {prec}: no deleted id returned")
        if prec in results:
            check(np.array_equal(dd.view(np.uint32), results[prec][0].view(np.uint32))
                  and np.array_equal(ii, results[prec][1]), f"mutated {prec}: modes bit-identical")
        else:
            results[prec] = (dd, ii)
        log(f"[dynamic] search the mutated store, precision={prec}, LMI_GATHER_MODE={mode}: "
            f"{seconds:.4f} s per {nq} queries")
    os.environ["LMI_GATHER_MODE"] = "auto"
    nc = 256
    order, _ = index.compute_bucket_order(queries[:nc], 4, keep_on_device=True)
    ref_d, ref_i = (t.cpu().numpy() for t in restricted_knn(dyn.store, queries[:nc], order, 10))
    n_tied = same_neighbors(results["highest"][0][:nc], results["highest"][1][:nc], ref_d, ref_i,
                            "mutated highest vs visited-bucket exact kNN")
    r_def = recall(results["default"][1][:nc], ref_i, 10)
    check(r_def >= 0.999, f"mutated default: recall {r_def} vs visited-bucket exact")
    live_pos = np.nonzero(~np.isin(ids_big, victims))[0][:256]
    _, self_ids, _ = dyn.search(new_rows[torch.as_tensor(live_pos, device=dev)], n_buckets=4, k=1)
    check(np.array_equal(self_ids[:, 0], ids_big[live_pos]), "inserted rows find themselves first")
    log(f"[check] mutated store: highest equals visited-bucket exact kNN ({nc} queries, {n_tied} "
        f"ids differ at ties); default recall@10 {r_def:.4f}; no deleted id among "
        f"{2 * nq} answers; 256 inserted rows find their own id first")
    del new_rows

    # ---- the scan kernel against its plain version on the mutated plan ----
    before = read_counts()
    order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
    plan, sargs = scan_inputs(dyn.store, queries, order, 128, "bf16")
    kw = dict(k=16, qtile=128, chunk=dyn.store.chunk, mode="bf16")
    kd, ks = scan_kernel.scan_pairs(*sargs, **kw)
    torch.cuda.synchronize()
    rd, rs = scan_kernel.scan_pairs_reference(*sargs, **kw)
    err, gap = compare_candidates(kd, ks, rd, rs, "bf16", "mutated flagship bf16")
    excluded = {k: excluded[k] + v - before[k] for k, v in read_counts().items()}
    log(f"[kernel-vs-plain] mutated flagship plan, bf16, k_scan 16, {plan.n_pairs} pairs over "
        f"{len(clist)} listed chunks (not the identity): agree, max|Δd|={err:.3g} (at swapped "
        f"slots {gap:.3g})")
    del plan, sargs, kd, ks, rd, rs

    # ---- compaction: the same bits before and after ----
    chunks_before = dyn.store.n_chunks
    torch.cuda.reset_peak_memory_stats()
    _, t_compact = synced(dyn.compact)
    peak_compact = torch.cuda.max_memory_allocated()
    for prec, (dd, ii) in results.items():
        ad, ai, _ = dyn.search(queries, n_buckets=4, k=10, precision=prec)
        check(np.array_equal(ad.view(np.uint32), dd.view(np.uint32)) and np.array_equal(ai, ii),
              f"compaction: {prec} search output bit-identical")
    check(cuda_build.BUILDS == builds, "no kernel built anew across growth and compaction")
    out["compact_s"] = t_compact
    log(f"[dynamic] compact: chunks {chunks_before} -> {dyn.store.n_chunks} in {t_compact:.3f} s, "
        f"peak device memory {peak_compact / 1e9:.2f} GB; search output bit-identical at both "
        f"precisions; nvcc builds in the phase: {cuda_build.BUILDS - builds}  [{smi}]")

    # ---- what one serving dispatch costs alone: a 1,024-query search ----
    before = read_counts()
    q1k = queries[:1024]
    t1k = sorted(synced(lambda: dyn.search(q1k, n_buckets=4, k=10))[1] for _ in range(3))[1]
    order, _ = index.compute_bucket_order(q1k, 4, keep_on_device=True)
    plan, sargs = scan_inputs(dyn.store, q1k, order, 128, "bf16")
    scan1k = cuda_ms(lambda: scan_kernel.scan_pairs(*sargs, k=16, qtile=128,
                                                    chunk=dyn.store.chunk, mode="bf16"), 3)
    split = split_plan(sargs, 16, "bf16")
    out["merge"] = merge_case(dyn.store, q1k, order, 16, "bf16", "A", smi)
    check(out["merge"]["launches"] == 1, "the serving dispatch's plan split no pair")
    excluded = {k: excluded[k] + v - before[k] for k, v in read_counts().items()}
    log(f"[serve] one dispatch's worth alone: a {q1k.shape[0]}-query search {t1k * 1e3:.2f} ms (median of "
        f"3, synced), its scan {scan1k:.3f} ms (CUDA events: the split, the scan kernel over the "
        f"items and the merge); {split_text(split)}  [{smi}]")
    del plan, sargs

    # ---- serving: 16 clients for ~10 s while one thread mutates ----
    server = SearchServer(dyn, k=10, n_buckets=4, max_batch=4096, max_wait_ms=2.0)
    pool = gen.rows(64 * 400).cpu().numpy()
    lat_ms, elapsed, mutated, st0, st = serve_under_load(server, queries.cpu().numpy(), pool,
                                                         serve_s)
    check(st["errors"] == 0 and st["engine"] == "cuda", f"serving stats {st['errors']}, {st['engine']}")
    n_req, n_batch = st["requests"] - st0["requests"], st["batches"] - st0["batches"]
    out.update(p50_ms=float(np.percentile(lat_ms, 50)), p95_ms=float(np.percentile(lat_ms, 95)),
               qps=len(lat_ms) * 64 / elapsed)
    log(f"[serve] SearchServer(DynamicIndex), max_batch 4096, max_wait_ms 2: 16 clients x 64 "
        f"queries for {elapsed:.1f} s while a thread inserted {mutated['inserts']} rows in 64s and "
        f"deleted {mutated['deletes']}: {len(lat_ms)} requests, request latency p50 "
        f"{out['p50_ms']:.2f} ms, p95 {out['p95_ms']:.2f} ms, max {lat_ms[-1]:.2f} ms; "
        f"{out['qps']:.0f} QPS; {n_batch} batches for {n_req} requests (median batch "
        f"{st['batch_queries']['p50']:.0f} queries); each insert seen by the search after it; "
        f"engine {st['engine']}, {st['scan_launches']} scan launches  [{smi}]")

    # ---- the HTTP front end: one call to each endpoint ----
    httpd = make_http_server(server, "127.0.0.1", 0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def call(path, body=None):
        req = urllib.request.Request(base + path, data=None if body is None else
                                     json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            check(r.status == 200, f"{path}: HTTP {r.status}")
            return json.loads(r.read())

    try:
        os.environ["LMI_GATHER_MODE"] = "kernel"
        check(call("/healthz") == {"status": "ok"}, "/healthz")
        rows = pool[-2:]
        new = call("/insert", {"vectors": rows.tolist()})["ids"]
        found = call("/search", {"queries": rows.tolist(), "k": 10})
        check([r[0] for r in found["ids"]] == new, "/search finds the rows /insert added")
        check(call("/delete", {"ids": new}) == {"deleted": 2}, "/delete")
        rep = call("/compact", {})
        check(rep["chunks_after"] <= rep["chunks_before"], "/compact")
        stats = call("/stats")
        check(stats["mutable"] and stats["engine"] == "cuda", "/stats")
    finally:
        os.environ["LMI_GATHER_MODE"] = "auto"
        httpd.shutdown()
        httpd.server_close()
        server.close()
    log(f"[serve] HTTP on an ephemeral port: /healthz, /insert, /search, /delete, /compact "
        f"(chunks {rep['chunks_before']} -> {rep['chunks_after']}), /stats all answered")
    launches = {k: v - excluded[k] for k, v in read_counts().items()}
    check(launches["scan_pairs"] > 0 and launches["gather_pairs"] > 0,
          f"the dynamic path launched the scan and the merge gather: {launches}")
    log(f"[dynamic] total {time.perf_counter() - t_all:.1f} s; launches {launches}")
    del server
    torch.cuda.empty_cache()
    return launches, out, dyn


@full_f32()
def visited_exact(sharded, queries, order, k: int = 10, q_step: int = 2048):
    """Exact f32 kNN of each query over only the buckets it visits, over a
    ``ShardedStore``'s live slots, bucket by bucket on the bucket's
    shard: ``(dists (Q, k), ids (Q, k) uint32)`` as numpy.  Ties between
    buckets go to the earlier visit."""
    home = queries.device
    order = order.to(home).long()
    Q, V = order.shape
    cand_d = torch.full((Q, V, k), torch.inf, device=home)
    cand_i = torch.zeros((Q, V, k), dtype=torch.int64, device=home)
    for b in torch.unique(order[order >= 0]).tolist():
        shard = sharded.shards[int(sharded.bucket_device[b])]
        lb, dev = int(sharded.bucket_local[b]), shard.device
        ptr, clist = shard.chunk_list()
        chunks = torch.as_tensor(clist[ptr[lb]:ptr[lb + 1]].astype(np.int64), device=dev)
        slots = (chunks[:, None] * shard.chunk + torch.arange(shard.chunk, device=dev)).reshape(-1)
        ids = shard.chunk_ids.reshape(-1)[slots]
        slots, ids = slots[ids > 0], ids[ids > 0].long()
        x = shard.chunk_data[slots].float() * shard.scales_flat()[slots][:, None]
        qi, vi = torch.nonzero(order == b, as_tuple=True)
        kk = min(k, x.shape[0])
        for s0 in range(0, qi.shape[0], q_step):
            q_b, v_b = qi[s0 : s0 + q_step], vi[s0 : s0 + q_step]
            vals, pos = smallest_k(1.0 - queries[q_b].to(dev) @ x.T, kk)
            cand_d[q_b, v_b, :kk] = vals.to(home)
            cand_i[q_b, v_b, :kk] = ids[pos].to(home)
        del x
    vals, pos = smallest_k(cand_d.reshape(Q, V * k), k)
    out_i = torch.where(torch.isinf(vals), 0, torch.gather(cand_i.reshape(Q, V * k), 1, pos))
    return vals.cpu().numpy(), out_i.cpu().numpy().astype(np.uint32)


def shards_held_to_plain(sharded, queries, order, what: str) -> float:
    """Every shard's scan at the sharded search's shapes (bf16, k_scan
    16, query tiles of 128, the shard's share of ``order``) held to its
    plain version by ``held_to_plain``; returns the largest error."""
    valid, at = order >= 0, order.clamp_min(0).long()
    owner = torch.as_tensor(sharded.bucket_device, device=order.device)[at]
    local = torch.as_tensor(sharded.bucket_local, device=order.device)[at]
    worst = {"bf16": (0.0, 0.0)}
    owners = range(len(sharded.shards)) if sharded.world is None else [sharded.world.rank]
    for i, shard in zip(owners, sharded.shards):
        no_copies = np.full(shard.n_chunks * shard.chunk, -1, np.int64)
        held_to_plain(shard, queries.to(shard.device),
                      torch.where(valid & (owner == i), local, -1).to(shard.device), 16, 128,
                      "bf16", no_copies, f"{what}, shard {i}", worst)
    return worst["bf16"][0]


def phase_multi_mutation(dev, index, dyn, data: dict, smi: str, single: dict,
                         n_insert: int = 500_000, n_delete: int = 250_000, serve_s: float = 5.0):
    """Part (b) of the multi-device phase: the dynamic path's mutated
    10M×768 int8 store promoted to four shards on ``[dev] * 4``
    (``shard_packed_store``, then ``ShardedDynamicIndex`` with the
    ``DynamicIndex``'s ``next_id``); 500,000 inserted rows in one batch,
    64 inserts of 64 rows, 250,000 deletes (half inserted, half
    original), a compaction, each followed by a visit-4 default search of
    the 10k queries held to exact kNN over the visited buckets (recall
    ≥ 0.999), no deleted id returned and one scan launch a shard; after
    the growth every shard's scan is held to its plain version; the
    compaction leaves the output bit-identical and no kernel is built
    anew; then ``SearchServer`` over the ``ShardedDynamicIndex`` with 16
    clients of 64 queries for ``serve_s`` seconds and a mutator
    alongside.  ``single``: the dynamic path's numbers, printed beside."""
    from learnedmetricindex_tpu_torch.parallel import ShardedDynamicIndex
    from learnedmetricindex_tpu_torch.serve import SearchServer

    queries, nq, d = data["queries"], data["queries"].shape[0], dyn.store.chunk_data.shape[1]
    devices = [dev] * 4
    t_all = time.perf_counter()
    builds = cuda_build.BUILDS
    dead = []

    # ---- the path: every launch from here to the read counts ----
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    sharded, t_promote = synced(lambda: lmi.shard_packed_store(dyn.store, devices))
    sdyn = ShardedDynamicIndex(index, sharded, next_id=dyn.next_id)
    check(sdyn.n_rows == dyn.n_rows and sdyn.next_id == dyn.next_id,
          "the promoted store holds the dynamic store's rows and allocator mark")
    n_orig, next0 = sdyn.n_rows, sdyn.next_id
    del sharded
    gen = BlobGenerator(256, d, seed=2023, noise=0.45, device=dev)  # the corpus's mixture
    gen.generator.manual_seed(2025)  # drawn anew
    new_rows = gen.rows(n_insert)
    small = [gen.rows(64) for _ in range(64)]
    out = {}

    def checked(step):
        b0 = scan_kernel.LAUNCHES
        (dd, ii, _), seconds = synced(lambda: sdyn.search(queries, n_buckets=4, k=10))
        per = scan_kernel.LAUNCHES - b0
        check(per == 4, f"sharded dynamic after {step}: {per} scan launches, not one a shard")
        check(dd.shape == (nq, 10) and bool(np.isfinite(dd).all()) and bool((ii > 0).all()),
              f"sharded dynamic after {step}: finite, filled")
        check(not dead or not np.isin(ii, np.concatenate(dead)).any(),
              f"sharded dynamic after {step}: no deleted id returned")
        order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
        _, ref_i = visited_exact(sdyn.store, queries, order, 10)
        r = recall(ii, ref_i, 10)
        check(r >= 0.999, f"sharded dynamic after {step}: recall {r} vs visited-bucket exact")
        log(f"[sharded-dynamic] after {step}: live rows {sdyn.n_rows}, chunks a shard "
            f"{[s.n_chunks for s in sdyn.store.shards]}; search default, visit 4, k 10: "
            f"{seconds:.4f} s per {nq} queries, 4 scan launches; recall@10 vs exact kNN over the "
            f"visited buckets {r:.4f} ({nq} queries)")
        return dd, ii

    chunks0 = [s.n_chunks for s in sdyn.store.shards]
    ids_big, t_big = synced(lambda: sdyn.insert(new_rows))
    check(ids_big[0] == next0 and len(ids_big) == n_insert, "ids continue the allocator mark")
    checked(f"{n_insert} inserts")
    t_small = [synced(lambda: sdyn.insert(rows))[1] for rows in small]
    checked("64 inserts of 64 rows")
    grown = [s.n_chunks for s in sdyn.store.shards]
    before = read_counts()  # launches made only to compare with the plain version
    order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
    out["err"] = shards_held_to_plain(sdyn.store, queries, order, "sharded dynamic, grown")
    excluded = {k: v - before[k] for k, v in read_counts().items()}
    del order
    rng = np.random.default_rng(12)
    live_orig = np.nonzero(sdyn._id_shard[: next0 - 1] >= 0)[0] + 1
    victims = np.concatenate([rng.choice(ids_big, n_delete // 2, replace=False),
                              rng.choice(live_orig, n_delete // 2, replace=False)])
    n_del, t_del = synced(lambda: sdyn.delete(victims))
    check(n_del == n_delete and sdyn.n_rows == n_orig + n_insert + 64 * 64 - n_delete,
          f"{n_delete} deleted ({n_del}), live rows counted")
    dead.append(victims)
    d3, i3 = checked(f"{n_delete} deletes")
    stats, t_compact = synced(sdyn.compact)
    d4, i4 = checked("compaction")
    check(np.array_equal(d3.view(np.uint32), d4.view(np.uint32)) and np.array_equal(i3, i4),
          "compaction: search output bit-identical")
    check(cuda_build.BUILDS == builds, "no kernel built anew across growth and compaction")
    peak_mut = torch.cuda.max_memory_allocated()
    out.update(insert_us_big=t_big / n_insert * 1e6,
               insert_us_64=float(np.median(t_small)) / 64 * 1e6, delete_s=t_del,
               compact_s=t_compact)
    log(f"[sharded-dynamic] promoted the dynamic store ({n_orig} live rows, next id {next0}) to 4 "
        f"shards on {dev} in {t_promote:.3f} s; insert {n_insert} rows in one batch {t_big:.3f} s "
        f"= {out['insert_us_big']:.3f} us a row (single store {single['insert_us_big']:.3f}); 64 "
        f"batches of 64: median {np.median(t_small) * 1e3:.3f} ms = {out['insert_us_64']:.2f} us "
        f"a row (single store {single['insert_us_64']:.2f}); chunks a shard {chunks0} -> "
        f"{grown}; delete {n_delete} ids {t_del:.3f} s; compact {t_compact:.3f} s (single store "
        f"{single['compact_s']:.3f} s), widest shard {stats['chunks_before']} -> "
        f"{stats['chunks_after']} chunks, output bit-identical; peak device memory "
        f"{peak_mut / 1e9:.2f} GB; nvcc builds in the phase {cuda_build.BUILDS - builds}  [{smi}]")
    del new_rows

    # ---- serving: 16 clients for serve_s seconds while one thread mutates ----
    server = SearchServer(sdyn, k=10, n_buckets=4, max_batch=4096, max_wait_ms=2.0)
    pool = gen.rows(64 * 400).cpu().numpy()
    lat_ms, elapsed, mutated, st0, st = serve_under_load(server, queries.cpu().numpy(), pool,
                                                         serve_s)
    server.close()
    check(st["errors"] == 0 and st["engine"] == "cuda" and st["mutable"],
          f"sharded serving stats {st['errors']}, {st['engine']}")
    n_req, n_batch = st["requests"] - st0["requests"], st["batches"] - st0["batches"]
    out.update(p50_ms=float(np.percentile(lat_ms, 50)), p95_ms=float(np.percentile(lat_ms, 95)),
               qps=len(lat_ms) * 64 / elapsed)
    launches = {k: v - excluded[k] for k, v in read_counts().items()}
    # ------------------------------------------------------------------
    check(launches["scan_pairs"] > 0, f"the sharded dynamic path launched the scan: {launches}")
    log(f"[sharded-dynamic] SearchServer(ShardedDynamicIndex), 4 shards, max_batch 4096, "
        f"max_wait_ms 2: 16 clients x 64 queries for {elapsed:.1f} s while a thread inserted "
        f"{mutated['inserts']} rows in 64s and deleted {mutated['deletes']}: {len(lat_ms)} requests, "
        f"p50 {out['p50_ms']:.2f} ms, p95 {out['p95_ms']:.2f} ms (single store p50 "
        f"{single['p50_ms']:.2f}, p95 {single['p95_ms']:.2f}); {out['qps']:.0f} QPS (single store "
        f"{single['qps']:.0f}); {n_batch} batches for {n_req} requests; engine {st['engine']}  "
        f"[{smi}]")
    log(f"[sharded-dynamic] total {time.perf_counter() - t_all:.1f} s; launches {launches}")
    del sdyn, server
    torch.cuda.empty_cache()
    return launches, out


# the experiment driver's run (phase_cli): the reference's flagship query
# configuration on a 1M×768 corpus the CLI draws itself (10,000 queries),
# at the CLI's default f32 store, float32 dtype and best-first policy
CLI_ARGV = ["--synthetic", "1000000", "--synthetic-dim", "768", "--n-categories", "120",
            "--epochs", "4", "--model-type", "MLP-4", "--batch-size", "1024", "--lr", "0.01",
            "--chunk-size", "2048", "-b", "1", "2", "4", "8", "120", "--device", "cuda"]
CLI_TRACE_VISIT = 4


class StepCount:
    """Counts the training steps ``StackedNodeTrainer.run`` is asked for
    while the block runs (``n``)."""

    def __enter__(self):
        from learnedmetricindex_tpu_torch.models.train import StackedNodeTrainer

        self.n, self.run = 0, StackedNodeTrainer.run

        def run(trainer, grouped, steps, active):
            self.n += steps
            return self.run(trainer, grouped, steps, active)

        StackedNodeTrainer.run = run
        return self

    def __exit__(self, *exc):
        from learnedmetricindex_tpu_torch.models.train import StackedNodeTrainer

        StackedNodeTrainer.run = self.run


class RecordedArgs(logging.Handler):
    """Keeps the arguments of the log records whose message is ``msg``."""

    def __init__(self, msg: str):
        super().__init__()
        self.msg, self.args = msg, []

    def emit(self, record):
        if record.msg == self.msg:
            self.args.append(record.args)


def trace_split(path: str, window: str, top: int = 8):
    """From a Chrome trace of ``device_trace``: the CPU span of the
    annotation ``window``, the device's busy share of it (the union of
    kernel, copy and set intervals inside it), and the ``top`` device
    operations by total time inside it, as ``(name, ms, count)``."""
    from learnedmetricindex_tpu_torch.utils.profiling import device_events

    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation" and e.get("name") == window]
    check(len(spans) == 1, f"trace: one {window!r} span, found {len(spans)}")
    w0, w1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    per_name, intervals = {}, []
    for e in device_events(path):
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        intervals.append((a, b))
        ms, n = per_name.get(e["name"], (0.0, 0))
        per_name[e["name"]] = (ms + (b - a) / 1e3, n + 1)
    busy, end = 0.0, w0
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1][0])[:top]
    return (w1 - w0) / 1e3, busy / (w1 - w0), [(n, ms, c) for n, (ms, c) in ranked]


def phase_cli(dev, smi: str, argv=CLI_ARGV):
    """The experiment driver, ``learnedmetricindex_tpu_torch.cli``, at
    ``argv`` in ``build/chip_smoke/cli``: ``cli.sweep`` (data, build, one
    search a visit count; the result files too where h5py imports), then
    ``--index-type baseline`` at the same flags, the ground truth.  Each
    visit count's ids equal exact kNN over its visited buckets (256
    queries), recall against the baseline does not fall as visits rise
    and is ≥ 0.999 visiting every bucket; one search at visit 4 under
    ``utils/profiling.device_trace``; then that scan alone, the kernel
    against its plain version, the library call and the bound.  Returns
    the path's launches, the scan's numbers and what the multi-device
    build compares with (the host data the sweep drew, its build times,
    recalls and the baseline's ids)."""
    import importlib.util

    from learnedmetricindex_tpu_torch import cli
    from learnedmetricindex_tpu_torch import eval as lmi_eval
    from learnedmetricindex_tpu_torch.utils.profiling import device_trace, span

    work = WORK_DIR / "cli"
    work.mkdir(parents=True, exist_ok=True)
    home = os.getcwd()
    os.chdir(work)  # the CLI writes models/ and its --out-dir relative to here
    try:
        t_all = time.perf_counter()
        args = cli.parse_args(argv)
        kw = cli.sweep_arguments(args)
        log(f"[cli] python -m learnedmetricindex_tpu_torch.cli {' '.join(argv)}  (default "
            f"--dtype {args.dtype}, --policy {args.policy}, --k {args.k}, --chunk-size "
            f"{args.chunk_size})")
        torch.cuda.reset_peak_memory_stats()
        drawn = []  # the sweep's host data, kept for phase_multi_build
        load = cli.load_data
        cli.load_data = lambda *a, **k: drawn.append((a, k, load(*a, **k))) or drawn[-1][2]
        try:
            reset_counts()
            with StepCount() as steps:
                result = cli.sweep(**kw)
            torch.cuda.synchronize()
            counts = read_counts()
        finally:
            cli.load_data = load
        index, store = result.index, result.store
        n_rows = int(result.data_prediction.shape[0])
        nq = result.queries.shape[0]
        check(counts["scan_pairs"] >= len(result.searches) and counts["gather_pairs"] == 0
              and counts["gather_rows"] == 0,
              f"the sweep launched the scan once a visit count and no gather: {counts}")
        check(store.chunk_data.dtype == torch.float32 and store.chunk_data.device == dev,
              f"the CLI's default store is f32 on the card: {store.chunk_data.dtype}")
        check(counts[WGMMA_F32] == counts["scan_pairs"],
              f"every scan of the sweep ran the wgmma body over f32 rows: {counts}")
        log(f"[cli] host data: {n_rows}x{store.chunk_data.shape[1]} + {nq} queries drawn "
            f"(synthetic_blobs, float64 draws) in {result.data_t:.1f} s; build "
            f"{result.build_t:.1f} s (cluster {result.cluster_t:.1f} s, train "
            f"{result.build_t - result.cluster_t:.1f} s), {index.n_buckets} buckets; f32 store "
            f"{store.nbytes() / 1e9:.2f} GB  [{smi}]")
        if importlib.util.find_spec("h5py") is None:
            paths = None
            log("[cli] h5py is absent here: cli.sweep ran without the result files "
                "(cli.write_results needs h5py); no result file was written")
        else:
            paths = cli.write_results(result, args.size, args.out_dir)
            log(f"[cli] wrote {len(paths)} SISAP result files under {work / args.out_dir}")

        # ---- the ground truth: --index-type baseline at the same flags ----
        recorded = RecordedArgs("Search time: %s")
        cli.LOG.addHandler(recorded)
        cli.LOG.setLevel(logging.INFO)
        try:
            t0 = time.perf_counter()
            gt_d, gt_i = cli.run(index_type="baseline", out_dir=args.out_dir, **kw)
            base_s = time.perf_counter() - t0
        finally:
            cli.LOG.removeHandler(recorded)
        check(len(recorded.args) == 1, "the baseline logged its search time once")
        check(gt_i.shape == (nq, args.k) and bool(np.isfinite(gt_d).all()), "baseline shape")
        log(f"[cli] baseline (exact cosine kNN of {nq} queries over {n_rows} rows, full f32 on "
            f"the card): search {recorded.args[0][0]:.3f} s (host normalize, upload, tiled "
            f"matmul + top-k), whole --index-type baseline run {base_s:.1f} s  [{smi}]")

        # ---- each visit count: exact over its buckets; recall against the baseline ----
        q_dev = torch.as_tensor(result.queries, device=dev)
        recalls = []
        for i, (n_buckets, dists, nns, measured, _) in enumerate(result.searches):
            check(nns.shape == (nq, args.k) and bool(np.isfinite(dists).all())
                  and bool((nns > 0).all()), f"visit {n_buckets}: finite, filled")
            r_vis = visited_recall(index, store, q_dev, n_buckets, nns, args.policy)
            check(r_vis >= 0.999, f"visit {n_buckets}: recall {r_vis} vs visited-bucket exact")
            recalls.append(recall(nns, gt_i, args.k))
            first = (" (includes packing the f32 store on the host and its upload: the first "
                     "search of the sweep)") if i == 0 else ""
            log(f"[cli] visit {n_buckets:3d}: search {measured['search']:.4f} s, inference "
                f"{measured['inference']:.4f} s{first}; recall@{args.k} vs the baseline "
                f"{recalls[-1]:.4f}, vs visited-bucket exact {r_vis:.4f} (256 queries)  [{smi}]")
        check(all(b >= a for a, b in zip(recalls, recalls[1:])),
              f"recall does not fall as visits rise: {recalls}")
        check(recalls[-1] >= 0.999 and result.searches[-1][0] >= index.n_buckets,
              f"every bucket visited: recall {recalls[-1]} vs the baseline")
        if paths is not None:
            rows = lmi_eval.evaluate_to_csv(paths, gt_i, "res.csv", k=args.k)
            check([r["recall"] for r in rows] == recalls, "the result files evaluate the same")

        # ---- warm searches: the store is packed; visit 1 again, then the traced search ----
        def search(n_buckets):
            return index.search(None, result.queries, None, result.queries,
                                result.data_prediction, n_buckets=n_buckets, k=args.k,
                                policy=args.policy, store=store)

        warm = {b: synced(lambda: search(b))[1] for b in (1, CLI_TRACE_VISIT)}
        log(f"[cli] warm searches of the packed store, synced: visit 1 {warm[1]:.4f} s, visit "
            f"{CLI_TRACE_VISIT} {warm[CLI_TRACE_VISIT]:.4f} s per {nq} queries  [{smi}]")
        before = read_counts()
        with device_trace(str(work / "trace"), device=dev) as prof:
            with span("lmi.search"):
                search(CLI_TRACE_VISIT)
        traced = {k: v - before[k] for k, v in read_counts().items()}
        window_ms, busy, top = trace_split(prof.trace_path, "lmi.search")
        check(any("scan_wgmma_f32" in name for name, _, _ in top),
              f"the trace names the scan kernel's body over f32 rows: {[n for n, _, _ in top]}")
        log(f"[cli-trace] one search at visit {CLI_TRACE_VISIT} under device_trace "
            f"({os.path.relpath(prof.trace_path, ROOT)}): window {window_ms:.2f} ms, device "
            f"busy {100 * busy:.1f}% of it; launches {traced}  [{smi}]")
        for name, ms, n in top:
            log(f"[cli-trace]   {ms:8.3f} ms  x{n:<3d} {name[:110]}")
        scan_ms = sum(ms for name, ms, _ in top if "scan_wgmma_f32" in name)
        log(f"[cli-trace] the scan (the wgmma body over the f32 store) {scan_ms:.3f} ms of the "
            f"{window_ms:.2f} ms window; peak device memory in the phase "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; phase total "
            f"{time.perf_counter() - t_all:.1f} s")
        launches = {k: counts[k] + traced[k] for k in counts}

        # ---- that scan alone: kernel, plain version, library call, bound ----
        sizes = np.asarray(store.bucket_sizes)
        order, _ = index.compute_bucket_order(q_dev, CLI_TRACE_VISIT, keep_on_device=True)
        plan, sargs = scan_inputs(store, q_dev, order, 128, "bf16")
        split, d = split_plan(sargs, 16, "bf16"), store.chunk_data.shape[1]
        kw_scan = dict(k=16, qtile=128, chunk=store.chunk, mode="bf16")
        mac, ops, peak, nbytes = scan_work(store, plan, order, store.chunk_data.shape[1], 16,
                                           "bf16")
        bound = {"operations": ops / peak * 1e3, "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        bound_by = max(bound, key=bound.get)
        before = scan_kernel.WGMMA_F32_LAUNCHES
        k_ms = cuda_ms(lambda: scan_kernel.scan_pairs(*sargs, **kw_scan), 3)
        check(scan_kernel.WGMMA_F32_LAUNCHES > before, "the CLI's scan ran the wgmma body over "
              "f32 rows")
        p_ms = cuda_ms(lambda: scan_kernel.scan_pairs_reference(*sargs, **kw_scan), 1)
        lib_ms = cuda_ms(library_scan(store, plan, sargs, 16, "bf16"), 1)
        kd, ks = scan_kernel.scan_pairs(*sargs, **kw_scan)
        rd, rs = scan_kernel.scan_pairs_reference(*sargs, **kw_scan)
        err, gap = compare_candidates(kd, ks, rd, rs, "bf16", "CLI bf16 over the f32 store")
        log(f"[cli] scan_pairs bf16 over the f32 store at visit {CLI_TRACE_VISIT}: kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.2f} ms, library {lib_ms:.2f} ms; bound "
            f"{bound[bound_by]:.3f} ms by {bound_by} ({mac:.4g} MAC, {nbytes / 1e9:.3f} GB) = "
            f"{bound[bound_by] / k_ms:.1%} of it; {plan.n_pairs} pairs, "
            f"{mac / k_ms / 1e9:.1f} TMAC/s; {reread_text(store, plan, split, d)}; bucket "
            f"sizes min {sizes.min()} median {int(np.median(sizes))} max {sizes.max()} rows; "
            f"agree, max|Δd|={err:.3g} (at swapped slots {gap:.3g}); {split_text(split)}  [{smi}]")
        timing = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "err": err,
                  "bound_ms": bound[bound_by], "bound_by": bound_by}
        single = {"drawn": drawn[0], "build_t": result.build_t, "cluster_t": result.cluster_t,
                  "train_steps": steps.n,
                  "visits": [b for b, *_ in result.searches], "recalls": recalls, "gt_i": gt_i,
                  "search_s": {b: m["search"] for b, _, _, m, _ in result.searches},
                  "warm_s": warm, "scan_ms": k_ms, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del plan, sargs, kd, ks, rd, rs
    finally:
        os.chdir(home)
    del result, index, store
    torch.cuda.empty_cache()
    return launches, timing, single


def phase_multi_build(dev, smi: str, single: dict, argv=CLI_ARGV):
    """Part (a) of the multi-device phase: the experiment driver's build
    and sweep over ``[dev] * 4`` (``cli.sweep(..., devices=)``) at
    ``phase_cli``'s argv, reusing its host data: once at ``--n-categories
    120`` (the root trains data parallel; it is clustered as on one device)
    and once at ``12 10`` (120 leaves; level 1's 12 models train expert
    parallel and cluster by ``kmeans_nodes(devices=)``).  Each sweep
    searches one store sharded over the four devices: one scan launch a
    shard a search; recall against the baseline ≥ 0.999 visiting every
    bucket and never falling as visits rise; at 120 buckets, visits 1, 2,
    4 and 8 within 0.03 of ``phase_cli``'s single-device sweep; each
    visit count's ids equal exact kNN over its visited buckets (recall ≥
    0.999, all queries); every shard's scan at visit 4 held to its plain
    version.  Prints the build's times beside ``phase_cli``'s, the peak
    device memory and each shard's scan at visit 4."""
    from learnedmetricindex_tpu_torch import cli

    work = WORK_DIR / "cli"
    work.mkdir(parents=True, exist_ok=True)
    home = os.getcwd()
    os.chdir(work)
    devices = [dev] * 4
    drawn_args, drawn_kw, drawn = single["drawn"]
    load = cli.load_data

    def reuse(*a, **k):
        check((a, k) == (drawn_args, drawn_kw), "the multi-device sweep draws what phase_cli drew")
        return drawn

    launches = {k: 0 for k in read_counts()}
    out = {}
    cli.load_data = reuse
    try:
        t_all = time.perf_counter()
        i = argv.index("--n-categories")
        for cats in (["120"], ["12", "10"]):
            args = cli.parse_args(argv[: i + 1] + cats + argv[i + 2 :])
            name = "x".join(cats)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # ---- the path: every launch from here to the read counts ----
            reset_counts()
            result = cli.sweep(**cli.sweep_arguments(args), devices=devices)
            torch.cuda.synchronize()
            counts = read_counts()
            # --------------------------------------------------------------
            peak = torch.cuda.max_memory_allocated()
            launches = {k: launches[k] + counts[k] for k in counts}
            index, store = result.index, result.store
            nq, kq = result.queries.shape[0], args.k
            sizes = np.bincount(index.bucket_ids_from_prediction(result.data_prediction),
                                minlength=index.layout.n_leaves)[index.leaf_valid]
            log(f"[multi] {name}: build over 4 devices on {dev} {result.build_t:.1f} s (cluster "
                f"{result.cluster_t:.1f} s, train {result.build_t - result.cluster_t:.1f} s), "
                f"{index.n_buckets} buckets; one device (phase_cli, 120): build "
                f"{single['build_t']:.1f} s (cluster {single['cluster_t']:.1f} s, train "
                f"{single['build_t'] - single['cluster_t']:.1f} s); peak device memory "
                f"{peak / 1e9:.2f} GB (one device {single['peak_gb']:.2f} GB); bucket sizes min "
                f"{sizes.min()} median {int(np.median(sizes))} max {sizes.max()}; sharded store "
                f"chunk {store.chunk}, rows a shard "
                f"{[int(sh.bucket_sizes.sum()) for sh in store.shards]}; launches {counts}  [{smi}]")
            check(isinstance(store, lmi.ShardedStore) and len(store.shards) == 4
                  and all(sh.device == dev for sh in store.shards), f"{name}: 4 shards on {dev}")
            check(counts["scan_pairs"] == 4 * len(result.searches)
                  and counts["scan_merge"] == counts["scan_split"]
                  and counts[WGMMA_F32] == counts["scan_pairs"],
                  f"{name}: {counts} launches for {len(result.searches)} searches of 4 shards "
                  f"(each scan on the wgmma body over f32 rows)")
            q_dev = torch.as_tensor(result.queries, device=dev)
            recalls = []
            for b, dists, nns, measured, _ in result.searches:
                check(nns.shape == (nq, kq) and bool(np.isfinite(dists).all())
                      and bool((nns > 0).all()), f"{name} visit {b}: finite, filled")
                order, _ = index.compute_bucket_order(q_dev, b, policy=args.policy,
                                                      keep_on_device=True)
                _, ref_i = visited_exact(store, q_dev, order, kq)
                r_vis = recall(nns, ref_i, kq)
                recalls.append(recall(nns, single["gt_i"], kq))
                r1 = None
                line = ""
                if name == "120" and b in single["visits"]:
                    r1 = single["recalls"][single["visits"].index(b)]
                    line = (f"; one device {r1:.4f}, search {single['search_s'][b]:.4f} s")
                log(f"[multi] {name}, 4 shards, visit {b:3d}: search {measured['search']:.4f} s; "
                    f"recall@{kq} vs the baseline {recalls[-1]:.4f}{line}; vs visited-bucket "
                    f"exact {r_vis:.4f} ({nq} queries)  [{smi}]")
                check(r_vis >= 0.999, f"{name} visit {b}: recall {r_vis} vs visited-bucket exact")
                if r1 is not None and b <= 8:
                    check(abs(recalls[-1] - r1) <= 0.03,
                          f"visit {b}: recall {recalls[-1]} vs one device's {r1}")
            check(all(b2 >= b1 for b1, b2 in zip(recalls, recalls[1:])),
                  f"{name}: recall does not fall as visits rise: {recalls}")
            check(recalls[-1] >= 0.999 and result.searches[-1][0] >= index.n_buckets,
                  f"{name}: every bucket visited: recall {recalls[-1]} vs the baseline")

            # ---- each shard's scan at visit 4, CUDA events ----
            order, _ = index.compute_bucket_order(q_dev, CLI_TRACE_VISIT, policy=args.policy,
                                                  keep_on_device=True)
            valid, at = order >= 0, order.clamp_min(0).long()
            owner = torch.as_tensor(store.bucket_device, device=dev)[at]
            local = torch.as_tensor(store.bucket_local, device=dev)[at]
            per = []
            for j, shard in enumerate(store.shards):
                plan, sargs = scan_inputs(shard, q_dev, torch.where(valid & (owner == j), local, -1),
                                          128, "bf16")
                ms = cuda_ms(lambda: scan_kernel.scan_pairs(*sargs, k=16, qtile=128,
                                                            chunk=shard.chunk, mode="bf16"), 3)
                per.append((int(shard.bucket_sizes.sum()), plan.n_pairs, ms))
            total = sum(t for _, _, t in per)
            out["err"] = max(out.get("err", 0.0),
                             shards_held_to_plain(store, q_dev, order, f"multi-device sweep {name}"))
            warm = synced(lambda: index.search(None, result.queries, None, result.queries,
                                               result.data_prediction, n_buckets=CLI_TRACE_VISIT,
                                               k=kq, policy=args.policy, store=store))[1]
            log(f"[multi] {name}: scan bf16 a shard at visit {CLI_TRACE_VISIT} (rows, pairs, ms): "
                f"{[(r, p, round(t, 3)) for r, p, t in per]}; sum {total:.3f} ms (one device's "
                f"scan {single['scan_ms']:.3f} ms); warm visit-{CLI_TRACE_VISIT} search "
                f"{warm:.4f} s (one device {single['warm_s'][CLI_TRACE_VISIT]:.4f} s)  [{smi}]")
            out[name] = {"build_t": result.build_t, "cluster_t": result.cluster_t,
                         "recalls": recalls, "shard_ms": [t for _, _, t in per], "warm_s": warm}
            del result, index, store, plan, sargs, q_dev
            torch.cuda.empty_cache()
        log(f"[multi] build path total {time.perf_counter() - t_all:.1f} s")
    finally:
        cli.load_data = load
        os.chdir(home)
    return launches, out


# the multi-process phase: the rank's working directory, its result line's
# tag, and the seconds the rank may take before the script kills it
MULTI_PROCESS_DIR = WORK_DIR / "multi_process"
RANK_RESULT = "[multi-process-result] "
RANK_TIMEOUT_S = 900


class CollectiveTimer:
    """CUDA events around every collective of the port while installed:
    ``multiprocess.all_gather`` and ``all_to_all``, which every
    collective of the port goes through.  :meth:`read` gives
    ``{name: (calls, device ms)}`` since the last read."""

    NAMES = ("all_gather", "all_to_all")

    def __init__(self, mp):
        self.mp, self.orig, self.events = mp, {n: getattr(mp, n) for n in self.NAMES}, []
        for name, fn in self.orig.items():
            setattr(mp, name, self._timed(name, fn))

    def _timed(self, name, fn):
        def timed(*a, **k):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **k)
            end.record()
            self.events.append((name, start, end))
            return out

        return timed

    def read(self) -> dict:
        torch.cuda.synchronize()
        out = {n: (0, 0.0) for n in self.NAMES}
        for name, start, end in self.events:
            calls, ms = out[name]
            out[name] = (calls + 1, ms + start.elapsed_time(end))
        self.events = []
        return out

    def close(self) -> None:
        for name, fn in self.orig.items():
            setattr(self.mp, name, fn)


def collectives_text(timed: dict) -> str:
    return ", ".join(f"{n} x{c} {ms:.2f} ms" for n, (c, ms) in timed.items())


def phase_multi_process(smi: str, single: dict, argv=CLI_ARGV):
    """The multi-process runtime (``parallel/multiprocess.py``) as a world
    of one rank over NCCL, in a child process of this script (``--rank-dir``)
    so the process group touches no other phase: ``MASTER_ADDR``
    127.0.0.1, a free port, ``RANK`` 0, ``WORLD_SIZE`` 1.  The rank reads
    ``phase_cli``'s host data from ``.npy`` files (nothing is drawn
    twice) and runs :func:`rank_main`.  The child's lines are echoed; its
    last, tagged line carries its launch counts and its worst
    kernel-vs-plain error.  A non-zero exit of the child fails the
    script."""
    import socket

    work = MULTI_PROCESS_DIR
    work.mkdir(parents=True, exist_ok=True)
    _, _, (_, data, queries) = single["drawn"]
    t0 = time.perf_counter()
    np.save(work / "data.npy", np.asarray(data, np.float32))
    np.save(work / "queries.npy", np.asarray(queries, np.float32))
    np.save(work / "gt_i.npy", single["gt_i"])
    keep = ("build_t", "cluster_t", "train_steps", "visits", "recalls", "scan_ms", "peak_gb")
    (work / "meta.json").write_text(json.dumps({
        "argv": argv, "smi": smi, "single": {k: single[k] for k in keep},
        "warm_s": single["warm_s"][CLI_TRACE_VISIT]}))
    log(f"[multi-process] phase_cli's host data written to {work.relative_to(ROOT)} in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK="0",
               WORLD_SIZE="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--rank-dir",
                             str(work)], cwd=ROOT, env=env, stdout=subprocess.PIPE, text=True)
    watchdog = threading.Timer(RANK_TIMEOUT_S, proc.kill)
    watchdog.start()
    result = None
    try:
        for line in proc.stdout:
            if line.startswith(RANK_RESULT):
                result = json.loads(line[len(RANK_RESULT):])
            log(line.rstrip("\n"))
        rc = proc.wait()
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0, f"the multi-process rank exited with {rc}")
    check(result is not None, "the multi-process rank printed its result line")
    log(f"[multi-process] the rank's process ran {time.perf_counter() - t0:.1f} s")
    for name in ("data.npy", "queries.npy", "gt_i.npy"):
        (work / name).unlink()
    return result["launches"], result


def rank_main(work: Path) -> None:
    """The rank of :func:`phase_multi_process`: ``multiprocess.initialize``
    on cuda:0 from torchrun's variables (the backend must be NCCL), the
    corpus as ``from_process_local`` rows, then at ``--n-categories 120``
    and ``12 10`` the rank-local build (``devices=global_mesh()``),
    ``get_sharded_store`` over the world and a search at each visit
    count.  Gates, as ``phase_multi_build``'s: one scan launch a search;
    each visit count exact over its visited buckets (recall ≥ 0.999, all
    queries); recall against the baseline never falling as visits rise,
    ≥ 0.999 visiting every bucket, and at 120 buckets visits 1-8 within
    0.03 of ``phase_cli``'s; the rank's scan at visit 4 held to its plain
    version; the routed fill's peak no more than its shard and four
    bounded exchanges above what was resident.  Prints the build's, a
    training step's and a warm search's seconds beside ``phase_cli``'s,
    the device time in collectives (CUDA events), the fill's peak and
    the peak device memory; the last line is the tagged JSON result."""
    from learnedmetricindex_tpu_torch import cli
    from learnedmetricindex_tpu_torch.parallel import multiprocess as mp
    from learnedmetricindex_tpu_torch.parallel import sharded_index

    meta = json.loads((work / "meta.json").read_text())
    argv, smi, single = meta["argv"], meta["smi"], meta["single"]
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    mp.initialize(device=dev)  # MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE
    world = mp.global_mesh()
    backend = torch.distributed.get_backend()
    check(backend == "nccl" and (world.rank, world.size, world.device) == (0, 1, dev),
          f"a world of one rank on {dev} over NCCL: {world}, {backend}")
    log(f"[multi-process] rank {world.rank} of {world.size} on {world.device}, backend "
        f"{backend}, joined in {time.perf_counter() - t0:.2f} s  [{smi}]")
    timer = CollectiveTimer(mp)
    queries = np.load(work / "queries.npy")
    gt_i = np.load(work / "gt_i.npy")
    t0 = time.perf_counter()
    gdata = mp.from_process_local(np.load(work / "data.npy"), world)
    torch.cuda.synchronize()
    log(f"[multi-process] from_process_local: {gdata.shape[0]}x{gdata.shape[1]} f32 rows on "
        f"{dev} in {time.perf_counter() - t0:.1f} s (read from .npy and uploaded); "
        f"{collectives_text(timer.read())}")
    q_dev = torch.as_tensor(queries, device=dev)
    launches = {k: 0 for k in read_counts()}
    out = {"err": 0.0}
    i = argv.index("--n-categories")
    for cats in (["120"], ["12", "10"]):
        args = cli.parse_args(argv[: i + 1] + cats + argv[i + 2 :])
        name = "x".join(cats)
        cfg = lmi.BuildConfiguration(args.clustering_algorithm, args.epochs, args.model_type,
                                     args.lr, args.n_categories, seed=args.seed,
                                     batch_size=args.batch_size, chunk_size=args.chunk_size,
                                     dtype=args.dtype)
        visits = sorted(set(b for b in args.n_buckets if b > 0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        timer.read()
        # ---- the path: every launch from here to the read counts ----
        reset_counts()
        with StepCount() as steps:
            index, pred, nb, build_t, cluster_t = lmi.LearnedIndexBuilder(
                gdata, cfg, device=dev, devices=world).build()
        build_coll = timer.read()
        build_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        store, store_s = synced(lambda: index.get_sharded_store(gdata, pred, world))
        fill_added = torch.cuda.max_memory_allocated() - resident
        store_coll = timer.read()
        searches = [(b, *index.search(None, queries, None, queries, pred, n_buckets=b, k=args.k,
                                      policy=args.policy, store=store)) for b in visits]
        torch.cuda.synchronize()
        counts = read_counts()
        # --------------------------------------------------------------
        search_coll = timer.read()
        peak = max(build_peak, torch.cuda.max_memory_allocated())
        corpus_bytes = gdata.block.numel() * gdata.block.element_size()
        launches = {k: launches[k] + counts[k] for k in counts}
        train_t = build_t - cluster_t
        one_train = single["build_t"] - single["cluster_t"]
        log(f"[multi-process] {name}: rank-local build {build_t:.1f} s (cluster {cluster_t:.1f} "
            f"s, train {train_t:.1f} s, {steps.n} steps, {1e3 * train_t / steps.n:.2f} ms a "
            f"step), {nb} buckets; one device (phase_cli, 120): build {single['build_t']:.1f} s "
            f"(cluster {single['cluster_t']:.1f} s, train {one_train:.1f} s, "
            f"{single['train_steps']} steps, {1e3 * one_train / single['train_steps']:.2f} ms a "
            f"step); collectives in the build: {collectives_text(build_coll)}; routed store "
            f"{store_s:.2f} s ({store.nbytes_device_arrays() / 1e9:.2f} GB, "
            f"{collectives_text(store_coll)}; the fill's peak {fill_added / 1e9:.2f} GB above "
            f"what was resident, {fill_added / corpus_bytes:.2f}x the rank's "
            f"{corpus_bytes / 1e9:.2f} GB of rows); launches {counts}  [{smi}]")
        bound = store.nbytes() + 4 * sharded_index.ROUTED_BLOCK_BYTES
        check(fill_added <= bound, f"{name}: the routed fill added {fill_added} bytes at its "
              f"peak, more than the shard and its bounded exchanges ({bound})")
        check(isinstance(store, lmi.ShardedStore) and store.world is world
              and len(store.shards) == 1 and store.shards[0].device == dev,
              f"{name}: the rank's one shard on {dev}")
        check(counts["scan_pairs"] == len(visits) and counts["scan_merge"] == counts["scan_split"]
              and counts["gather_pairs"] == 0
              and counts["gather_rows"] == 0 and counts[WGMMA_F32] == len(visits),
              f"{name}: {counts} launches for {len(visits)} searches (one scan a search, on the "
              f"wgmma body over f32 rows)")
        check(search_coll["all_gather"][0] == len(visits),
              f"{name}: one all_gather a search: {search_coll}")
        recalls = []
        for b, dists, nns, measured in searches:
            check(nns.shape == (len(queries), args.k) and bool(np.isfinite(dists).all())
                  and bool((nns > 0).all()), f"{name} visit {b}: finite, filled")
            order, _ = index.compute_bucket_order(q_dev, b, policy=args.policy,
                                                  keep_on_device=True)
            _, ref_i = visited_exact(store, q_dev, order, args.k)
            r_vis = recall(nns, ref_i, args.k)
            recalls.append(recall(nns, gt_i, args.k))
            line = ""
            if name == "120" and b in single["visits"]:
                r1 = single["recalls"][single["visits"].index(b)]
                line = f"; one device {r1:.4f}"
                if b <= 8:
                    check(abs(recalls[-1] - r1) <= 0.03,
                          f"visit {b}: recall {recalls[-1]} vs one device's {r1}")
            log(f"[multi-process] {name}, visit {b:3d}: search {measured['search']:.4f} s; "
                f"recall@{args.k} vs the baseline {recalls[-1]:.4f}{line}; vs visited-bucket "
                f"exact {r_vis:.4f} ({len(queries)} queries)  [{smi}]")
            check(r_vis >= 0.999, f"{name} visit {b}: recall {r_vis} vs visited-bucket exact")
        check(all(b2 >= b1 for b1, b2 in zip(recalls, recalls[1:])),
              f"{name}: recall does not fall as visits rise: {recalls}")
        check(recalls[-1] >= 0.999 and visits[-1] >= nb,
              f"{name}: every bucket visited: recall {recalls[-1]} vs the baseline")

        # ---- warm visit-4 search, its collective; the rank's scan held to plain ----
        order, _ = index.compute_bucket_order(q_dev, CLI_TRACE_VISIT, policy=args.policy,
                                              keep_on_device=True)
        search = lambda: index.search(None, queries, None, queries, pred,  # noqa: E731
                                      n_buckets=CLI_TRACE_VISIT, k=args.k, policy=args.policy,
                                      store=store)
        search()
        timer.read()
        warm = min(synced(search)[1] for _ in range(3))
        one_coll = timer.read()
        out["err"] = max(out["err"], shards_held_to_plain(store, q_dev, order,
                                                          f"multi-process {name}"))
        log(f"[multi-process] {name}: warm visit-{CLI_TRACE_VISIT} search {warm:.4f} s per "
            f"{len(queries)} queries (best of 3; one device {meta['warm_s']:.4f} s); its "
            f"collectives over 3 searches: {collectives_text(one_coll)}; peak device memory "
            f"{peak / 1e9:.2f} GB (one device {single['peak_gb']:.2f} GB)  [{smi}]")
        out[name] = {"build_t": build_t, "cluster_t": cluster_t, "train_step_ms":
                     1e3 * train_t / steps.n, "recalls": recalls, "warm_s": warm,
                     "peak_gb": peak / 1e9, "fill_added_gb": fill_added / 1e9,
                     "collective_ms": {"build": build_coll, "store": store_coll,
                                       "search": one_coll}}
        del index, store, searches, order
        torch.cuda.empty_cache()
    timer.close()
    torch.distributed.destroy_process_group()
    out["launches"] = launches
    print(RANK_RESULT + json.dumps(out), flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=10_000_000, help="corpus rows")
    p.add_argument("--rank-dir", type=Path, help=argparse.SUPPRESS)  # phase_multi_process's rank
    args = p.parse_args()
    if args.rank_dir is not None:
        rank_main(args.rank_dir)
        return

    t_script = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    small = phase_kernel_vs_plain(dev)
    data = make_corpus(dev, args.rows, 10_000, 120)
    main_launches, timing, ctx = phase_main(dev, data, smi)
    virt_launches, virt_timing = phase_virtual(dev, data, ctx, smi)
    shard_launches, _ = phase_sharded(dev, data, ctx, timing["bf16"]["ms"], smi)
    merge_errs = [t["err"] for t in ctx["merge"].values() if "err" in t]
    del ctx
    torch.cuda.empty_cache()
    build_launches, gather_timing, (index, store) = phase_build_path(dev, data, smi)
    dyn_launches, dyn_out, dyn = phase_dynamic(dev, index, store, data, smi)
    del store
    merge_timing = dyn_out["merge"]  # the kernels line's merge: shape (A), the serving plan
    merge_errs.append(merge_timing["err"])
    mut_launches, mut_out = phase_multi_mutation(dev, index, dyn, data, smi, dyn_out)
    del index, dyn, data
    torch.cuda.empty_cache()
    cli_launches, cli_timing, single = phase_cli(dev, smi)
    multi_launches, multi_out = phase_multi_build(dev, smi, single)
    proc_launches, proc_out = phase_multi_process(smi, single)
    del single
    rows = []
    for name, source, replaces, t, errs in (
        ("scan_pairs", KERNEL_SOURCE, REPLACES, timing["bf16"],
         [e for pair in small.values() for e in pair[:1]] + [t["err"] for t in timing.values()]
         + [virt_timing["err"], cli_timing["err"], mut_out["err"], multi_out["err"],
            proc_out["err"]]),
        ("scan_merge", MERGE_SOURCE, MERGE_REPLACES, merge_timing, merge_errs),
        # the row gather's kernels: the merge gather is the one the search launches
        ("gather_pairs", GATHER_SOURCE, GATHER_REPLACES, gather_timing["merge"],
         [t["err"] for t in gather_timing.values()]),
    ):
        def total(key):  # over every path's run
            return sum(run[key] for run in (main_launches, virt_launches, shard_launches,
                                            build_launches, dyn_launches, mut_launches,
                                            cli_launches, multi_launches, proc_launches))

        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": total(name),
                     "max_abs_err": max(errs), "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
        if name == "scan_pairs":  # its launches a body
            rows[-1]["bodies"] = {
                "mma.sync": total(name) - total(WGMMA_INT8) - total(WGMMA_F32)
                - total(WGMMA_F32MODE) - total(WGMMA_WIDE) - total(WGMMA_F32X) - total(WGMMA_S8)
                - total(WGMMA_S8_WIDE) - total(WGMMA_F32MODE_WIDE) - total(WGMMA_F32_WIDE)
                - total(WGMMA_INT8_ROWMAP) - total(WGMMA_F32MODE_ROWMAP),
                "wgmma (bf16 over int8 rows)": total(WGMMA_INT8),
                "wgmma (bf16 over f32 rows)": total(WGMMA_F32),
                "wgmma (f32 over int8 rows)": total(WGMMA_F32MODE),
                "wgmma (bf16 over int8 rows, lists of 64 and 128)": total(WGMMA_WIDE),
                "wgmma (f32 over f32 rows, six products)": total(WGMMA_F32X),
                "wgmma (int8 over int8 rows)": total(WGMMA_S8),
                "wgmma (int8 over int8 rows, lists of 64 and 128)": total(WGMMA_S8_WIDE),
                "wgmma (f32 over int8 rows, lists of 64 and 128)": total(WGMMA_F32MODE_WIDE),
                "wgmma (bf16 over f32 rows, lists of 64 and 128)": total(WGMMA_F32_WIDE),
                "wgmma (bf16 over a row map of int8 rows)": total(WGMMA_INT8_ROWMAP),
                "wgmma (f32 over a row map of int8 rows)": total(WGMMA_F32MODE_ROWMAP)}
            check(total(WGMMA_F32MODE) > 0, "no scan launch took the f32-mode wgmma body")
            check(total(WGMMA_WIDE) > 0, "no scan launch took the wide-list wgmma body")
            check(total(WGMMA_F32X) > 0, "no scan launch took the six-term wgmma body")
            check(total(WGMMA_S8) > 0, "no scan launch took the int8 wgmma body")
            check(total(WGMMA_S8_WIDE) > 0,
                  "no scan launch took the int8 wgmma body with wide lists")
            check(total(WGMMA_F32MODE_WIDE) > 0,
                  "no scan launch took the f32-mode wgmma body with wide lists")
            check(total(WGMMA_F32_WIDE) > 0,
                  "no scan launch took the wgmma body over f32 rows with wide lists")
            check(total(WGMMA_INT8_ROWMAP) > 0, "no scan launch took the row-map wgmma body")
            check(total(WGMMA_F32MODE_ROWMAP) > 0,
                  "no scan launch took the f32-mode row-map wgmma body")
        if name == "scan_merge":  # one merge a scan launch that split a pair, and some did
            rows[-1]["back_to_back_ms"] = t["back_to_back_ms"]
            rows[-1]["timed"] = ("ms: 50 launches queued behind a spin (device time); "
                                 "back_to_back_ms: 50 launched back to back through the wrapper")
            check(0 < total("scan_merge") == total("scan_split"),
                  f"{total('scan_merge')} merges for {total('scan_split')} scan launches that "
                  f"split a pair")
    log(f"[total] chip_smoke.py {time.perf_counter() - t_script:.1f} s, the kernels' build "
        f"included  [{smi}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
