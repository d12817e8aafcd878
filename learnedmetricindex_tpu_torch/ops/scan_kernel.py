"""The fused bucket scan: a hand-written CUDA kernel and its plain
PyTorch version (counterpart of ``learnedmetricindex_tpu/ops/scan_kernel.py``).

For every (bucket, query-tile) *pair* of a scan plan, each query's exact
top-``k`` of ``1 - <q, x>·scale(·qscale)`` over all of the bucket's
chunks, ascending, ties toward the earlier row in the bucket's scan
order.  Padding slots (scale 0) never enter; what no row reaches is
``+inf`` / slot -1, as is every entry of a padding query (qidx -1) and
of a pair whose bucket has no chunks.

* :func:`scan_pairs_reference` — the plain PyTorch version.
* :func:`scan_pairs` — the wrapper.  CPU tensors run the plain version;
  CUDA tensors launch ``csrc/scan_pairs.cu`` (built with ``nvcc`` for
  ``sm_90a`` at first use into ``build/torch_kernels/``) or raise.  A
  ``k`` wider than the kernel's widest list (:data:`MAX_K`) runs as
  rounds of at most ``MAX_K`` (:func:`scan_in_rounds`).
* The split: each launch cuts every bucket's chunk list into segments
  (:func:`split_pairs`) so that no (pair, segment) *item* holds more
  than a share of one slot's fair share of the launch's work
  (:func:`segment_length`), scans the items as pseudo-buckets with the
  unchanged kernel (:func:`split_inputs`) and merges each pair's item
  lists back into one (:func:`merge_split_lists`: ``csrc/scan_merge.cu``
  on CUDA, :func:`merge_split_lists_reference` on the CPU).  The lists
  are those of one scan of the whole bucket, bit for bit.  A launch whose
  pairs are all one item merges nothing: the scan's lists are the pairs'.
* Twelve bodies: the bf16 queries over an int8 packed store at list width
  32 (the default search) and over an f32 packed store (the default
  search over ``BuildConfiguration(dtype="float32")``, the CLI's store)
  run the Hopper bodies (wgmma, TMA, a resident query tile of 64 slots a
  block), and so do the bf16 queries over an int8 or an f32 packed store
  at list widths 64 and 128 (``k_scan`` 33 to 128: ``search(k=100)``), the
  f32 queries over an int8 or an f32 packed store at list width 32
  (``precision="highest"``, the default of ``sharded_search`` and
  ``scan_buckets``: the three terms of 32 slots a block resident; over an
  f32 store six products a k-step) and over an int8 packed store at list
  widths 64 and 128 (its ``search(k=100)``), and the int8 queries over an int8
  packed store at list width 32 and at list widths 64 and 128
  (``precision="int8"``, and its ``search(k=100)``: s8 wgmma, exact
  integer sums), and the bf16 and f32 queries over a virtual store of an
  int8 corpus at list width 32 (the row map: the same blocks, their rings
  filled by producer warps that gather each slot's row through the id
  grid); every other call the mma.sync body.
  The library decides (``wgmma_scope``); :func:`scan_body` asks it which
  body a launch takes, and each launch checks that the queries were laid
  out for the body that runs.
* :func:`operand_queries` — the query rows the kernel reads;
  :func:`split_f32` — the exact three-term bf16 split of f32 queries
  behind them in mode ``"f32"``; :func:`split_f32_truncated` — the
  kernel's split of f32 store values (its plain model, for the tests).
* ``LAUNCHES`` — how many times the wrapper launched the kernel
  (``WGMMA_LAUNCHES``: of those, the launches that ran a Hopper body;
  ``WGMMA_F32_LAUNCHES``: of those, the body over an f32 store;
  ``WGMMA_F32MODE_LAUNCHES``: of those, the body in f32 mode over an int8
  store; ``WGMMA_WIDE_LAUNCHES``: of those, the body at list widths 64 and
  128; ``WGMMA_F32X_LAUNCHES``: of those, the six-term body in f32 mode
  over an f32 store; ``WGMMA_S8_LAUNCHES``: of those, the body in int8
  mode; ``WGMMA_S8_WIDE_LAUNCHES``: of those, the body in int8 mode at list
  widths 64 and 128; ``WGMMA_F32MODE_WIDE_LAUNCHES``: of those, the body in
  f32 mode over an int8 store at list widths 64 and 128;
  ``WGMMA_F32_WIDE_LAUNCHES``: of those, the body over an f32 store at list
  widths 64 and 128; ``WGMMA_INT8_ROWMAP_LAUNCHES``: of those, the body over
  a row map of an int8 corpus; ``WGMMA_F32MODE_ROWMAP_LAUNCHES``: of those,
  the body in f32 mode over a row map of an int8 corpus);
  ``MERGE_LAUNCHES`` — the merge kernel; ``SPLIT_LAUNCHES`` — the scan
  launches that split at least one pair (one merge each).
* Spans (``utils/profiling.py::span``, recorded while a profiler runs):
  ``lmi.split`` over a CUDA round (the plan's host read, the body, the
  segment length, the split), ``lmi.launch`` inside it over each scan
  and merge launch.

Stores: a packed store is ``(n_slots, d)`` rows with ``(n_slots,)``
scales (0 = padding slot).  A *virtual* store keeps no copy of the rows:
``row_ids`` is its ``(n_slots,)`` id grid (1-based corpus rows, 0 =
padding), the store argument the unmoved ``(n, d)`` corpus, and
``scales`` the corpus's ``(n,)`` row scales (an int8 corpus) or ``None``
(scale 1).  Results are slots either way.

Modes: ``"f32"`` (full f32 queries as three bf16 terms on the tensor
cores: over an int8 or bf16 store, whose values are exact in bf16, three
passes of exact products; over an f32 store, whose values the kernel
splits into three bf16 terms too, the six products that reach f32
precision), ``"bf16"``
(both operands rounded to bf16, products summed in f32 on the tensor
cores) and ``"int8"`` (int8 queries with per-query ``qscales`` against an
int8 store, exact integer sums on the tensor cores).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch.ops import cuda_build
from learnedmetricindex_tpu_torch.ops.precision import full_f32
from learnedmetricindex_tpu_torch.ops.select import smallest_k
from learnedmetricindex_tpu_torch.utils.profiling import span

MODES = {"f32": 0, "bf16": 1, "int8": 2}
MAX_K = 1024  # the widest top-k list of csrc/scan_pairs.cu: wider k runs in rounds
MAX_QTILE = 128  # QT in csrc/scan_pairs.cu
#: the bodies as the library numbers them (enum Body in csrc/scan_pairs.cu)
BODY_NAMES = ("mma.sync", "wgmma", "wgmma over f32", "wgmma in f32 mode", "wgmma wide lists",
              "wgmma six-term", "wgmma int8", "wgmma int8 wide lists",
              "wgmma f32-mode wide lists", "wgmma over f32 wide lists", "wgmma row map",
              "wgmma f32-mode row map")
_STORE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: kernel launches made by :func:`scan_pairs` (never by the plain version)
LAUNCHES = 0
#: of LAUNCHES, those that ran a wgmma body (as the library reports each launch)
WGMMA_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body over an f32 store
WGMMA_F32_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body in f32 mode (over an int8 store)
WGMMA_F32MODE_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body at list widths 64 and 128
WGMMA_WIDE_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the six-term wgmma body (f32 mode over an f32 store)
WGMMA_F32X_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body in int8 mode (over an int8 store)
WGMMA_S8_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body in int8 mode at list widths 64 and 128
WGMMA_S8_WIDE_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body in f32 mode over an int8
#: store at list widths 64 and 128
WGMMA_F32MODE_WIDE_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body over an f32 store at
#: list widths 64 and 128
WGMMA_F32_WIDE_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body over a row map (a virtual
#: store) of an int8 corpus
WGMMA_INT8_ROWMAP_LAUNCHES = 0
#: of WGMMA_LAUNCHES, those that ran the wgmma body in f32 mode over a row map
#: of an int8 corpus
WGMMA_F32MODE_ROWMAP_LAUNCHES = 0
#: merge kernel launches made by :func:`merge_split_lists` (never by its plain version)
MERGE_LAUNCHES = 0
#: scan kernel launches whose work list cut at least one pair into several items
SPLIT_LAUNCHES = 0

#: The merge kernel's plan (:func:`merge_plan`): lists of at most this many
#: entries are merged in the lanes of a warp (csrc/scan_merge.cu's
#: WARP_MAX_K), a block a group of this many query slots (on an H100 the
#: fastest of 4 to 128 at a 1,024-query dispatch's k 16 merge)
MERGE_WARP_MAX_K = 32
MERGE_WARP_GROUP = 16
#: wider lists: a block stages the lists of every item of at most
#: MERGE_WARPS query slots in at most this much shared memory (on an H100
#: at k 106 the fastest: 8 slots of two items, 4 of seven, of 1 to 64);
#: pairs whose lists of one slot pass MERGE_SMEM_MAX are streamed from
#: device memory instead
MERGE_SMEM_TARGET = 28 * 1024
MERGE_SMEM_MAX = 200 * 1024
#: the items a pair may have to be staged when the caller does not say
MERGE_DEFAULT_CAP = 8
#: a block's warps (csrc/scan_merge.cu's WARPS): the most query slots a
#: block stages, and the slots a block where pairs are streamed (a warp a slot)
MERGE_WARPS = 8

#: An item (one segment of a pair's chunk list) holds at most this share
#: of one slot's fair share of a launch's work (:func:`segment_length`)
SEGMENT_SHARE = 0.5

#: Depth order, within each group of 16, of the bf16 queries that meet an
#: int8 store: the kernel widens the 4 int8 values k = 4t..4t+3 that
#: ldmatrix gives lane t of a quad into the bf16 B registers of depths
#: (2t, 2t+1) and (2t+8, 2t+9) of an m16n8k16 step, so the query values
#: must sit at those depths too.
WIDEN_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)

#: Depth order, within each group of 64, of the bf16 queries that the
#: wgmma body reads: a TMA box holds 64 depths of each store row, and
#: lane t of a quad reads its bytes 16t .. 16t+15 as four words, word j
#: widening into the A registers of k-step j of the box at depths
#: (2t, 2t+1) and (2t+8, 2t+9) of that k-step.  So position 16j + k' of
#: the group holds depth 16·((k' % 8) // 2) + 4j + k' % 2 + 2·(k' // 8).
WGMMA_ORDER = tuple(16 * ((kk % 8) // 2) + 4 * j + kk % 2 + 2 * (kk // 8)
                    for j in range(4) for kk in range(16))

#: Depth order, within each group of 32, of the bf16 queries that the
#: wgmma body over an f32 store reads: a TMA box holds 32 f32 depths (128
#: bytes) of each store row, and in k-step j of the box lane t of a quad
#: reads its 16-byte chunk 2t + j (depths 8t + 4j .. 8t + 4j + 3), whose
#: values round into the A registers of depths (2t, 2t+1) and (2t+8,
#: 2t+9).  So position 16j + k' of the group holds depth
#: 8·((k' % 8) // 2) + 4j + k' % 2 + 2·(k' // 8).
WGMMA_F32_ORDER = tuple(8 * ((kk % 8) // 2) + 4 * j + kk % 2 + 2 * (kk // 8)
                        for j in range(2) for kk in range(16))

#: Depth order, within each group of 64, of the int8 queries that the
#: wgmma body in int8 mode reads: a TMA box holds 64 depths of each store
#: row, and lane t of a quad reads its bytes 16t .. 16t+15 as four words,
#: words 2s and 2s + 1 the A registers of 32-deep k-step s of the box at
#: depths 4t .. 4t+3 and 16 + 4t .. 16 + 4t + 3 of that k-step (no
#: widening).  So position 32s + k' of the group holds depth
#: 16·((k' % 16) // 4) + 8s + 4·(k' // 16) + k' % 4.
WGMMA_S8_ORDER = tuple(16 * ((kk % 16) // 4) + 8 * s + 4 * (kk // 16) + kk % 4
                       for s in range(2) for kk in range(32))

SOURCE = cuda_build.CSRC / "scan_pairs.cu"
MERGE_SOURCE = cuda_build.CSRC / "scan_merge.cu"


def build() -> Tuple[Path, float]:
    """Compile the kernel if this source has no build yet: ``(library
    path, seconds compiling)``."""
    return cuda_build.build_many([SOURCE])[0]


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lmi_scan_pairs.argtypes = [vp] * 14 + [ci] * 9 + [ctypes.POINTER(ci), vp]
    lib.lmi_scan_pairs.restype = ci
    lib.lmi_scan_body.argtypes = [ci, ci, ci, ci, vp, vp, ci] + [ctypes.POINTER(ci)] * 4
    lib.lmi_scan_body.restype = ci


def _bind_merge(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lmi_scan_merge.argtypes = [vp] * 5 + [ci] * 6 + [vp]
    lib.lmi_scan_merge.restype = ci


def _check(queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales, row_ids,
           *, k, qtile, chunk, mode):
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r} (one of {sorted(MODES)})")
    tensors = [t for t in (queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales,
                           row_ids) if t is not None]
    if any(t.device != store.device for t in tensors):
        raise ValueError("scan_pairs: every tensor must be on the store's device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("scan_pairs: tensors must be contiguous")
    for name, t in (("qidx", qidx), ("pair_bucket", pair_bucket), ("ptr", ptr),
                    ("chunk_of", chunk_of), ("row_ids", row_ids)):
        if t is not None and (t.dtype != torch.int32 or t.dim() != 1):
            raise ValueError(f"scan_pairs: {name} must be 1-D int32")
    if store.dim() != 2 or store.dtype not in _STORE_TYPES:
        raise ValueError("scan_pairs: store must be (rows, d) f32, bf16 or int8")
    n_rows, d = store.shape
    n_slots = n_rows if row_ids is None else row_ids.shape[0]
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"scan_pairs: queries must be (n, {d})")
    if scales is None and row_ids is None:
        raise ValueError("scan_pairs: a packed store needs its slot scales")
    if scales is not None and (scales.dtype != torch.float32 or scales.shape != (n_rows,)):
        raise ValueError(f"scan_pairs: scales must be ({n_rows},) f32")
    if n_slots % chunk or n_slots >= 2**31 or n_rows >= 2**31:
        raise ValueError("scan_pairs: n_slots must be whole chunks, slots and rows < 2**31")
    if qidx.shape[0] != pair_bucket.shape[0] * qtile:
        raise ValueError("scan_pairs: qidx must hold n_pairs * qtile slots")
    if not (1 <= qtile <= MAX_QTILE and 1 <= k):
        raise ValueError(
            f"scan_pairs takes 1 <= qtile <= {MAX_QTILE} and k >= 1, got qtile={qtile}, k={k}"
        )
    if mode == "int8":
        if store.dtype != torch.int8 or queries.dtype != torch.int8:
            raise ValueError("scan mode 'int8' needs an int8 store and int8 queries")
        if qscales is None or qscales.dtype != torch.float32 or qscales.shape != (queries.shape[0],):
            raise ValueError("scan mode 'int8' needs (n_queries,) f32 qscales")
    elif queries.dtype != torch.float32:
        raise ValueError(f"scan mode {mode!r} needs f32 queries")


@full_f32()
def scan_pairs_reference(
    queries: torch.Tensor,  # (n_queries, d) f32, or int8 for mode "int8"
    qidx: torch.Tensor,  # (n_pairs·qtile,) int32 query row per slot, -1 = pad
    pair_bucket: torch.Tensor,  # (n_pairs,) int32
    ptr: torch.Tensor,  # (n_buckets+1,) int32 chunk CSR
    chunk_of: torch.Tensor,  # (n_assigned,) int32 CSR position → physical chunk
    store: torch.Tensor,  # (n_slots, d) f32 / bf16 / int8
    scales: torch.Tensor,  # (n_slots,) f32, 0 = padding slot
    qscales: Optional[torch.Tensor] = None,  # (n_queries,) f32, mode "int8"
    row_ids: Optional[torch.Tensor] = None,  # (n_slots,) int32 id grid of a virtual store
    *,
    k: int,
    qtile: int,
    chunk: int,
    mode: str,
    floor: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: one matmul per visited bucket
    over all of its query tiles.  Returns ``(dists, slots)``, each
    ``(n_pairs, qtile, k)``, ascending per query.  With a virtual store
    (``row_ids``) slot ``s`` reads corpus row ``row_ids[s] - 1``.
    ``floor``: ``(distances (n_pairs·qtile,) f32, scan positions int32)``;
    a row enters a query's list only if its (distance, position in the
    bucket's scan order) is lexicographically above the query's floor."""
    _check(queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales, row_ids,
           k=k, qtile=qtile, chunk=chunk, mode=mode)
    device = store.device
    n_pairs = pair_bucket.shape[0]
    out_d = torch.full((n_pairs, qtile, k), torch.inf, device=device)
    out_s = torch.full((n_pairs, qtile, k), -1, dtype=torch.int32, device=device)
    if n_pairs == 0:
        return out_d, out_s
    qidx2 = qidx.reshape(n_pairs, qtile).long()
    ptr_h = ptr.cpu().tolist()
    # runs of pairs on one bucket share one slab matmul
    buckets, runs = torch.unique_consecutive(pair_bucket.cpu(), return_counts=True)
    first = torch.cumsum(runs, 0) - runs
    # int8 sums are exact in f64; bf16 products are exact in f32
    work = torch.float64 if mode == "int8" else torch.float32
    for b, p0, npairs in zip(buckets.tolist(), first.tolist(), runs.tolist()):
        chunks = chunk_of[ptr_h[b] : ptr_h[b + 1]].long()
        if chunks.numel() == 0:
            continue
        slots = (chunks[:, None] * chunk + torch.arange(chunk, device=device)).reshape(-1)
        rows = qidx2[p0 : p0 + npairs].reshape(-1)
        q = queries[rows.clamp_min(0)].to(work)
        if row_ids is None:
            x, sc = store[slots], scales[slots]
        else:  # a virtual store: each slot's corpus row, scale 0 on padding
            ids = row_ids[slots].long()
            src = (ids - 1).clamp_min(0)
            x = store[src]
            sc = torch.ones_like(src, dtype=torch.float32) if scales is None else scales[src]
            sc = torch.where(ids > 0, sc, 0.0)
        x = x.to(work)
        if mode == "bf16":
            q = q.to(torch.bfloat16).float()
            x = x.to(torch.bfloat16).float()
        raw = (q @ x.T).float()
        dist = raw * (-sc)
        if mode == "int8":
            dist = dist * qscales[rows.clamp_min(0)][:, None]
        dist = dist + torch.where(sc == 0.0, torch.inf, 1.0)
        dist = torch.where((rows >= 0)[:, None], dist, torch.inf)
        if floor is not None:
            fd = floor[0][p0 * qtile : (p0 + npairs) * qtile, None]
            fp = floor[1][p0 * qtile : (p0 + npairs) * qtile, None]
            pos = torch.arange(dist.shape[1], device=device)[None, :]
            dist = torch.where((dist > fd) | ((dist == fd) & (pos > fp)), dist, torch.inf)
        kk = min(k, dist.shape[1])
        vals, pos = smallest_k(dist, kk)
        sel = torch.where(torch.isinf(vals), -1, slots[pos]).to(torch.int32)
        out_d[p0 : p0 + npairs, :, :kk] = vals.reshape(npairs, qtile, kk)
        out_s[p0 : p0 + npairs, :, :kk] = sel.reshape(npairs, qtile, kk)
    return out_d, out_s


def split_f32(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hi, mid, lo)`` bf16 with ``hi + mid + lo == queries`` exactly:
    each rounded to nearest even from what the terms before it left, and
    both subtractions exact in f32.  Exact for ``2**-110 <= |q|`` below
    bf16's overflow edge (~3.39e38) and for 0; below ``2**-110`` the part
    under bf16's smallest subnormal, less than ``2**-133``, is lost."""
    hi = queries.to(torch.bfloat16)
    rest = queries - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def split_f32_truncated(values: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(hi, mid, lo)`` bf16 with ``hi + mid + lo == values`` exactly: the
    kernel's split of f32 store values, by truncation (``hi`` the top 16
    bits of each value, ``mid`` those of what is left, ``lo`` the rest;
    both subtractions exact in f32).  Exact for ``2**-110 <= |x|`` and
    for 0, up to the largest f32 (no term rounds up to infinity); below
    ``2**-110`` the part under bf16's smallest subnormal, less than
    ``2**-133``, is lost."""

    def top16(x):
        return (x.view(torch.int32) & -65536).view(torch.float32)

    x = values.float()
    hi = top16(x)
    rest = x - hi
    mid = top16(rest)
    lo = top16(rest - mid)
    return hi.bfloat16(), mid.bfloat16(), lo.bfloat16()


def operand_queries(queries: torch.Tensor, mode: str, store_dtype: torch.dtype,
                    wgmma_qd: int = 0) -> torch.Tensor:
    """The query rows the kernel reads, 16-byte aligned: in mode
    ``"bf16"`` the queries rounded to bf16 (nearest even, once per call)
    and in mode ``"int8"`` the int8 rows, each zero-padded to a multiple
    of 16 values; in mode ``"f32"`` (over any store) the three terms of
    :func:`split_f32`, each zero-padded to a multiple of 32 values and
    laid out per 32-value depth slice as ``hi, mid, lo`` side by side,
    ``(n, 3·qd)``.  Where bf16 terms meet an int8 store, each group of 16
    values is in :data:`WIDEN_ORDER`; for a wgmma body the rows are
    zero-padded to ``wgmma_qd`` values instead (the width it reads,
    :attr:`Body.qd`: a multiple of 64 >= d), each group of 64 in
    :data:`WGMMA_ORDER` over an int8 store (:data:`WGMMA_S8_ORDER` in mode
    ``"int8"``, for the int8 bodies at every list width; over a row map of an
    int8 corpus as over the int8 packed store), each group of 32 in
    :data:`WGMMA_F32_ORDER` over an f32 store (at every list width); in mode ``"f32"`` the three
    terms so laid out are planes side by side, ``hi, mid, lo``, ``(n,
    3·wgmma_qd)``, over an int8 store (the f32-mode bodies at every list
    width) and over an f32 store (the six-term body) alike."""
    if mode == "f32":
        terms, group = split_f32(queries), 32
    else:
        terms, group = (queries.to(torch.bfloat16) if mode == "bf16" else queries,), 16
    n, d = queries.shape
    qd = d + -d % group
    if wgmma_qd:
        if wgmma_qd < d or wgmma_qd % 64:
            raise ValueError(f"operand_queries: wgmma rows of {wgmma_qd} values for d {d}")
        qd = wgmma_qd
    out = []
    for q in terms:
        if qd > d:
            q = torch.cat([q, q.new_zeros((n, qd - d))], dim=1)
        if wgmma_qd:
            order = (WGMMA_S8_ORDER if mode == "int8" else
                     WGMMA_F32_ORDER if store_dtype == torch.float32 else WGMMA_ORDER)
            q = q.reshape(n, qd // len(order), len(order))[:, :, list(order)].reshape(n, qd)
        elif mode != "int8" and store_dtype == torch.int8:
            order = torch.tensor(WIDEN_ORDER, device=q.device)
            q = q.reshape(n, qd // 16, 16)[:, :, order].reshape(n, qd)
        out.append(q)
    if len(out) == 1:
        q = out[0]
    elif wgmma_qd:
        q = torch.cat(out, dim=1)
    else:
        q = torch.stack([t.reshape(n, qd // group, group) for t in out], dim=2).reshape(n, -1)
    if not q.is_contiguous() or q.data_ptr() % 16:
        q = q.clone(memory_format=torch.contiguous_format)
    return q


def chunk_positions(ptr: torch.Tensor, chunk_of: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """``(n_chunks,)`` int64: each physical chunk's place in its bucket's
    chunk list (0 for a chunk no list names), so that slot ``s`` lies at
    scan position ``positions[s // chunk] * chunk + s % chunk`` of its
    bucket."""
    ptr = ptr.long()
    counts = ptr[1:] - ptr[:-1]
    n_assigned = int(ptr[-1])
    entry = torch.arange(n_assigned, device=ptr.device)
    bucket = torch.repeat_interleave(torch.arange(counts.shape[0], device=ptr.device), counts)
    positions = torch.zeros(n_chunks, dtype=torch.int64, device=ptr.device)
    positions[chunk_of[:n_assigned].long()] = entry - ptr[bucket]
    return positions


def scan_in_rounds(
    scan_round,
    qidx: torch.Tensor,
    pair_bucket: torch.Tensor,
    positions: torch.Tensor,
    *,
    k: int,
    qtile: int,
    chunk: int,
    width: int = MAX_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's top-``k`` in rounds of at most ``width``: round ``r``
    is ``scan_round(qidx, pair_bucket, w, floor)`` over the pairs still
    open, ``floor`` (``None`` in the first round) the last entry of each
    query's previous round as ``(distance, scan position)``.  A list
    holds the first ``w`` rows in (distance, scan position) order, so the
    rounds' lists side by side are the first ``k``: exact under the
    scan's tie rule.  A pair whose last round left a query's list short
    (slot -1) has no more rows and takes no further round.
    ``positions``: :func:`chunk_positions` of the store."""
    n_pairs = pair_bucket.shape[0]
    device = qidx.device
    out_d = torch.full((n_pairs, qtile, k), torch.inf, device=device)
    out_s = torch.full((n_pairs, qtile, k), -1, dtype=torch.int32, device=device)
    floor_d = torch.full((n_pairs, qtile), -torch.inf, device=device)
    floor_p = torch.full((n_pairs, qtile), -1, dtype=torch.int32, device=device)
    qidx2 = qidx.reshape(n_pairs, qtile)
    open_pairs = torch.arange(n_pairs, device=device)
    done = 0
    while done < k and open_pairs.numel():
        w = min(width, k - done)
        floor = None
        if done:
            floor = (floor_d[open_pairs].reshape(-1), floor_p[open_pairs].reshape(-1))
        d, sl = scan_round(qidx2[open_pairs].reshape(-1), pair_bucket[open_pairs], w, floor)
        out_d[open_pairs, :, done : done + w] = d
        out_s[open_pairs, :, done : done + w] = sl
        last = sl[:, :, -1].long()
        at = last.clamp_min(0)
        floor_d[open_pairs] = d[:, :, -1]
        floor_p[open_pairs] = torch.where(
            last >= 0, positions[at // chunk] * chunk + at % chunk, -1).to(torch.int32)
        open_pairs = open_pairs[(last >= 0).any(dim=1)]
        done += w
    return out_d, out_s


def list_width(k: int) -> int:
    """The kernel's list width for ``k <= MAX_K``: the narrowest of 32,
    64, ..., 1024 that holds ``k``."""
    return max(32, 1 << (k - 1).bit_length())


def queries_per_block(width: int) -> int:
    """Query slots whose lists one mma.sync block keeps at a list width (QB
    in csrc/scan_pairs.cu): above 128 a pair's queries split over blocks."""
    return MAX_QTILE if width <= 128 else MAX_QTILE * 128 // width


class WorkList(NamedTuple):
    """A launch's pairs cut into items (:func:`split_pairs`), host arrays.
    Segment ``g`` scans ``chunk_of[seg_ptr[g]:seg_ptr[g + 1]]``; item
    ``i`` is segment ``item_segment[i]`` of pair ``item_pair[i]``'s
    bucket, whose chunk list it enters ``item_offset[i]`` chunks in."""

    seg_ptr: np.ndarray  # (n_segments + 1,) int64, a refinement of the bucket CSR
    item_segment: np.ndarray  # (n_items,) int64
    item_pair: np.ndarray  # (n_items,) int64, ascending: a pair's items in scan order
    item_offset: np.ndarray  # (n_items,) int64 chunks
    pair_items: np.ndarray  # (n_pairs + 1,) int64: pair p's items pair_items[p]:pair_items[p+1]


def split_pairs(ptr: np.ndarray, pair_bucket: np.ndarray, segment: int) -> WorkList:
    """Cut each bucket's chunk list ``ptr[b]:ptr[b + 1]`` into segments of
    ``segment`` consecutive entries (the last may be shorter; a bucket
    without chunks keeps one empty segment, whose items write the fill),
    and each pair into one item a segment of its bucket, in scan order.
    A pair whose bucket has at most ``segment`` chunks stays one item."""
    if segment < 1:
        raise ValueError(f"split_pairs: segment must be >= 1, got {segment}")
    ptr = np.asarray(ptr, dtype=np.int64)
    pair_bucket = np.asarray(pair_bucket, dtype=np.int64)
    counts = ptr[1:] - ptr[:-1]
    n_seg = np.maximum(1, -(-counts // segment))
    seg_first = np.concatenate([[0], np.cumsum(n_seg)])
    seg_bucket = np.repeat(np.arange(len(counts)), n_seg)
    seg_rank = np.arange(seg_first[-1]) - seg_first[seg_bucket]
    starts = np.minimum(ptr[seg_bucket] + seg_rank * segment, ptr[seg_bucket + 1])
    per_pair = n_seg[pair_bucket]
    pair_items = np.concatenate([[0], np.cumsum(per_pair)])
    item_pair = np.repeat(np.arange(len(pair_bucket)), per_pair)
    item_rank = np.arange(pair_items[-1]) - pair_items[item_pair]
    return WorkList(
        seg_ptr=np.append(starts, ptr[-1]),
        item_segment=seg_first[pair_bucket[item_pair]] + item_rank,
        item_pair=item_pair,
        item_offset=item_rank * segment,
        pair_items=pair_items,
    )


def segment_length(ptr: np.ndarray, pair_bucket: np.ndarray, live: np.ndarray, *,
                   width: int, slots: int, share: float = SEGMENT_SHARE,
                   wgmma_block: int = 0) -> int:
    """The segment length (in chunks) of a launch: the longest that keeps
    every block's work within ``share`` of one slot's fair share, the
    launch's work over ``slots`` (SMs × blocks an SM).  A block's work is
    its item's chunks × the 16-query m-tiles it computes (``live``: bit m
    set where m-tile m of the pair holds a query): the mma.sync body's
    all 8 at list width 32, else those of its own query slots; the wgmma
    body's (``wgmma_block``: its blocks' query slots, :attr:`Body.block_queries`)
    its m-tiles up to its last live one, the width of its wgmma.  Where no
    block has work, no bucket is cut."""
    ptr = np.asarray(ptr, dtype=np.int64)
    chunks = (ptr[1:] - ptr[:-1])[np.asarray(pair_bucket, dtype=np.int64)]
    tiles = MAX_QTILE // 16
    bits = (np.asarray(live, dtype=np.int64)[:, None] >> np.arange(tiles)) & 1
    per_block = (wgmma_block or queries_per_block(width)) // 16
    if wgmma_block:
        bits = bits.reshape(len(chunks), -1, per_block)
        last = per_block - np.argmax(bits[:, :, ::-1], axis=2)  # past the last live m-tile
        block_tiles = np.where(bits.any(axis=2), last, 0)
    else:
        if width == 32:  # a width-32 block computes every m-tile
            bits = np.ones_like(bits)
        block_tiles = bits.reshape(len(chunks), -1, per_block).sum(axis=2)
    total = int((chunks[:, None] * block_tiles).sum())
    if total == 0:
        return max(1, int(chunks.max(initial=1)))
    heaviest = int(block_tiles[chunks > 0].max())
    return max(1, int(share * total / (slots * heaviest)))


class SplitInputs(NamedTuple):
    """The kernel's inputs over a :class:`WorkList`'s items, on the device."""

    qidx: torch.Tensor  # (n_items·qtile,) int32: each item's pair's query slots
    pair_bucket: torch.Tensor  # (n_items,) int32: each item's segment
    ptr: torch.Tensor  # (n_segments + 1,) int32
    floor: Optional[Tuple[torch.Tensor, torch.Tensor]]  # positions from the segment's start
    pair_items: torch.Tensor  # (n_pairs + 1,) int32


def split_inputs(work: WorkList, qidx: torch.Tensor,
                 floor: Optional[Tuple[torch.Tensor, torch.Tensor]], *, qtile: int,
                 chunk: int) -> SplitInputs:
    """Feed each item to the kernel as a pseudo-bucket: its segment in
    the refined CSR (``chunk_of`` unchanged), its pair's query slots
    repeated, and a floor's scan position shifted by the segment's first
    scan position, so that (distance, position in the segment) above
    (fd, fp − offset) is the bucket-wide rule.  One host→device copy."""
    parts = (work.seg_ptr, work.item_segment, work.item_pair, work.item_offset * chunk,
             work.pair_items)
    host = np.concatenate(parts).astype(np.int32)
    dev = torch.as_tensor(host).to(qidx.device)
    bounds = np.cumsum([0] + [len(a) for a in parts])
    ptr, segs, pairs, shift, pair_items = (dev[a:b] for a, b in zip(bounds[:-1], bounds[1:]))
    pairs = pairs.long()
    item_qidx = qidx.view(-1, qtile)[pairs].reshape(-1)
    item_floor = None
    if floor is not None:
        fd, fp = (t.view(-1, qtile)[pairs] for t in floor)
        item_floor = (fd.reshape(-1), (fp - shift[:, None]).reshape(-1))
    return SplitInputs(item_qidx, segs, ptr, item_floor, pair_items)


def scan_split(scan_items, merge, qidx: torch.Tensor,
               floor: Optional[Tuple[torch.Tensor, torch.Tensor]], ptr: np.ndarray,
               pair_bucket: np.ndarray, segment: int, *, qtile: int, chunk: int):
    """One scan of the pairs ``pair_bucket`` (host) over the buckets
    ``ptr`` (host) as items of at most ``segment`` chunks:
    ``scan_items(qidx, pair_bucket, ptr, floor)`` scans the items as
    pseudo-buckets and ``merge(dists, slots, pair_items, max_items)``
    merges each pair's item lists (``max_items``: the most items a pair
    has, from the host's work list).  Returns ``(n_pairs, qtile, k)``
    lists.  Where every pair is one item, the items' lists are the pairs'
    lists bit for bit: they are returned as they are and ``merge`` is not
    called (decided on the host, with no read from the device)."""
    work = split_pairs(ptr, pair_bucket, segment)
    inputs = split_inputs(work, qidx, floor, qtile=qtile, chunk=chunk)
    d, s = scan_items(inputs.qidx, inputs.pair_bucket, inputs.ptr, inputs.floor)
    if work.pair_items[-1] == len(work.pair_items) - 1:
        return d, s
    return merge(d, s, inputs.pair_items, int(np.diff(work.pair_items).max()))


def merge_split_lists_reference(item_d: torch.Tensor, item_s: torch.Tensor,
                                pair_items: torch.Tensor, max_items: Optional[int] = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the merge kernel: for each pair ``p`` and query
    slot, the first ``k`` of its items' lists ``pair_items[p] :
    pair_items[p + 1]`` (each ``(qtile, k)``, ascending, fill ``+inf`` /
    -1) by (distance, item order, place in list): a stable
    :func:`smallest_k` over the lists side by side in item order.
    ``max_items`` (the kernel's plan) is not needed here."""
    _, qtile, k = item_d.shape
    n_pairs = pair_items.shape[0] - 1
    if n_pairs == 0:
        return item_d[:0].clone(), item_s[:0].clone()
    flat_d, flat_s = lists_side_by_side(item_d, item_s, pair_items)
    vals, pos = smallest_k(flat_d, k)
    slots = torch.where(torch.isinf(vals), -1, torch.gather(flat_s, 1, pos))
    return vals.reshape(n_pairs, qtile, k), slots.reshape(n_pairs, qtile, k)


def lists_side_by_side(item_d: torch.Tensor, item_s: torch.Tensor,
                       pair_items: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each (pair, query slot)'s item lists side by side in item order,
    ``(n_pairs·qtile, width·k)`` (``width`` the most items of a pair),
    padded with ``+inf`` / -1: what :func:`merge_split_lists_reference`
    selects from."""
    n_items, qtile, k = item_d.shape
    bounds = pair_items.cpu().long()
    n_pairs = bounds.shape[0] - 1
    counts = bounds[1:] - bounds[:-1]
    width = int(counts.max()) if n_pairs else 0
    cat_d = torch.full((n_pairs, width, qtile, k), torch.inf, device=item_d.device)
    cat_s = torch.full((n_pairs, width, qtile, k), -1, dtype=torch.int32, device=item_d.device)
    item_pair = torch.repeat_interleave(torch.arange(n_pairs), counts)
    rank = torch.arange(n_items) - bounds[item_pair]
    cat_d[item_pair, rank] = item_d
    cat_s[item_pair, rank] = item_s
    return (cat_d.permute(0, 2, 1, 3).reshape(n_pairs * qtile, width * k),
            cat_s.permute(0, 2, 1, 3).reshape(n_pairs * qtile, width * k))


class MergePlan(NamedTuple):
    """How ``csrc/scan_merge.cu`` cuts a launch (:func:`merge_plan`)."""

    group: int  # query slots a block: a block a (pair, group of slots)
    cap: int  # pairs of 2 .. cap items are merged in shared memory, more are streamed
    smem: int  # the block's dynamic shared memory, bytes


def merge_smem_bytes(group: int, cap: int, k: int) -> int:
    """Shared memory of a block that stages ``cap`` items' lists of
    ``group`` query slots: the distances and slots of each item and of the
    merged lists, each run ``group·k`` values with up to 3 ahead of it (so
    that its 16-byte chunks fall where they fall in device memory), in
    whole 16 bytes; 0 where nothing is staged (``cap`` < 2)."""
    if cap < 2:
        return 0
    return (2 * cap + 2) * ((group * k + 6) // 4 * 4) * 4


def merge_plan(k: int, qtile: int, max_items: Optional[int] = None) -> MergePlan:
    """The merge kernel's plan for lists of ``k`` in query tiles of
    ``qtile`` whose pairs have at most ``max_items`` items (unknown:
    :data:`MERGE_DEFAULT_CAP`; pairs with more are streamed, right but
    slower).  Lists of at most :data:`MERGE_WARP_MAX_K`: merged in a warp's
    lanes whatever the count, :data:`MERGE_WARP_GROUP` query slots a block,
    nothing staged (``cap`` 0).  Wider: the most query slots a block, at
    most :data:`MERGE_WARPS`, whose staged lists fit in
    :data:`MERGE_SMEM_TARGET` bytes, at least one
    (nothing staged where no pair has two items: the blocks copy); where
    one slot's lists pass :data:`MERGE_SMEM_MAX`, a warp a slot streamed
    from device memory (``cap`` 0)."""
    if k <= MERGE_WARP_MAX_K:
        return MergePlan(min(qtile, MERGE_WARP_GROUP), 0, 0)
    cap = MERGE_DEFAULT_CAP if max_items is None else max_items
    run = MERGE_SMEM_TARGET // ((2 * cap + 2) * 4) // 4 * 4  # the values of one run that fit
    group = max(1, min(qtile, MERGE_WARPS, (run - 3) // k))
    smem = merge_smem_bytes(group, cap, k)
    if smem > MERGE_SMEM_MAX:
        return MergePlan(min(qtile, MERGE_WARPS), 0, 0)
    return MergePlan(group, cap, smem)


def merge_split_lists(item_d: torch.Tensor, item_s: torch.Tensor, pair_items: torch.Tensor,
                      max_items: Optional[int] = None, *, plan: Optional[MergePlan] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge (see :func:`merge_split_lists_reference`): the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.
    ``item_d`` (n_items, qtile, k) f32, ``item_s`` int32, ``pair_items``
    (n_pairs + 1,) int32; ``max_items``: the most items a pair has, a host
    integer (:func:`merge_plan`; without it any count is still merged
    right); ``plan`` overrides :func:`merge_plan`'s (tests, probes)."""
    if item_d.device.type == "cpu":
        return merge_split_lists_reference(item_d, item_s, pair_items)
    if item_d.device.type != "cuda":
        raise ValueError(f"merge_split_lists runs on cpu or cuda, not {item_d.device}")
    if (item_d.dtype != torch.float32 or item_s.dtype != torch.int32 or item_d.dim() != 3
            or item_s.shape != item_d.shape or pair_items.dtype != torch.int32
            or pair_items.dim() != 1):
        raise ValueError("merge_split_lists: (n_items, qtile, k) f32 and int32 lists, "
                         "1-D int32 pair_items")
    if any(t.device != item_d.device or not t.is_contiguous()
           for t in (item_s, pair_items)) or not item_d.is_contiguous():
        raise ValueError("merge_split_lists: contiguous tensors on one device")
    _, qtile, k = item_d.shape
    n_pairs = pair_items.shape[0] - 1
    plan = plan or merge_plan(k, qtile, max_items)
    lib = cuda_build.load(MERGE_SOURCE, _bind_merge)
    out_d = torch.empty((n_pairs, qtile, k), dtype=torch.float32, device=item_d.device)
    out_s = torch.empty((n_pairs, qtile, k), dtype=torch.int32, device=item_d.device)
    with torch.cuda.device(item_d.device), span("lmi.launch"):
        err = lib.lmi_scan_merge(item_d.data_ptr(), item_s.data_ptr(), pair_items.data_ptr(),
                                 out_d.data_ptr(), out_s.data_ptr(), n_pairs, qtile, k,
                                 plan.group, plan.cap, plan.smem,
                                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan_merge kernel launch failed: cudaError {err}")
    global MERGE_LAUNCHES
    MERGE_LAUNCHES += 1
    return out_d, out_s


class Body(NamedTuple):
    """What the library says of a launch (``lmi_scan_body``, the one place
    that picks the body)."""

    kind: int  # the body that takes it: an index of BODY_NAMES
    qd: int  # the width of the query rows that body reads
    block_queries: int  # query slots one of its blocks keeps
    slots: int  # its blocks that the card holds at once: SMs × blocks an SM

    @property
    def wgmma(self) -> bool:
        """A wgmma body takes it; else the mma.sync body."""
        return self.kind > 0


# (library, device, mode, store type, list width, d, virtual, aligned, floored) → Body
_bodies: Dict[tuple, Body] = {}


def scan_body(lib, store: torch.Tensor, mode: str, k: int,
              row_ids: Optional[torch.Tensor] = None, floored: bool = False) -> Body:
    """The body that a launch at ``k`` over ``store`` (a virtual store's
    corpus with ``row_ids``; ``floored``: under floors) takes, as the
    library decides it, with its query row width, its blocks' query slots
    and the card's slots (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``):
    asked once for each case and cached."""
    d = store.shape[1]
    key = (lib._name, store.device.index, mode, store.dtype, list_width(k), d,
           row_ids is not None, store.data_ptr() % 16 == 0, floored)
    if key not in _bodies:
        out = [ctypes.c_int(0) for _ in range(4)]
        with torch.cuda.device(store.device):
            err = lib.lmi_scan_body(
                k, MODES[mode], _STORE_TYPES[store.dtype], d, store.data_ptr(),
                row_ids.data_ptr() if row_ids is not None else None, int(floored),
                *(ctypes.byref(o) for o in out))
        body, qd, block_queries, blocks = (o.value for o in out)
        if err != 0 or blocks < 1:
            raise RuntimeError(f"scan_pairs occupancy query failed: cudaError {err}, "
                               f"{blocks} blocks an SM")
        sms = torch.cuda.get_device_properties(store.device).multi_processor_count
        _bodies[key] = Body(body, qd, block_queries, sms * blocks)
    return _bodies[key]


def host_plan(ptr: torch.Tensor, pair_bucket: torch.Tensor, qidx: torch.Tensor,
              qtile: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(ptr, pair_bucket, live)`` on the host in one device→host read:
    ``live[p]`` has bit m set where m-tile m (query slots 16m..16m+15)
    of pair p holds a query."""
    n_pairs = pair_bucket.shape[0]
    tiles = -(-qtile // 16)
    q = qidx.view(n_pairs, qtile) >= 0
    q = torch.nn.functional.pad(q, (0, tiles * 16 - qtile)).view(n_pairs, tiles, 16).any(dim=2)
    bits = 1 << torch.arange(tiles, device=q.device, dtype=torch.int32)
    live = (q.int() * bits).sum(dim=1, dtype=torch.int32)
    host = torch.cat([ptr, pair_bucket, live]).cpu().numpy()
    n_b = ptr.shape[0]
    return host[:n_b], host[n_b : n_b + n_pairs], host[n_b + n_pairs :]


def _launch_items(lib, queries, qscales, qidx, pair_bucket, ptr, chunk_of, store, scales,
                  row_ids, floor, *, k: int, qtile: int, chunk: int, mode: str, terms: int,
                  body: int):
    """One kernel launch over the given pairs (here: items over the
    segments ``ptr``), ``k <= MAX_K``; ``queries`` laid out by
    :func:`operand_queries` for the body ``body`` (:attr:`Body.kind`)
    names, which the library holds to the body it takes (raises where
    they differ)."""
    n_pairs = pair_bucket.shape[0]
    out_d = torch.empty((n_pairs, qtile, k), dtype=torch.float32, device=store.device)
    out_s = torch.empty((n_pairs, qtile, k), dtype=torch.int32, device=store.device)
    # blocks start on the largest items, so the long ones do not run last
    # alone (measured 1.25x at the flagship shape on an H100, unsplit)
    n_chunks = (ptr[1:] - ptr[:-1])[pair_bucket.long()]
    pair_order = torch.argsort(n_chunks, descending=True, stable=True).to(torch.int32)
    floor_d, floor_p = floor if floor is not None else (None, None)

    def ptr_of(t):
        return t.data_ptr() if t is not None else None

    ran = ctypes.c_int(body)
    with torch.cuda.device(store.device), span("lmi.launch"):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lmi_scan_pairs(
            queries.data_ptr(), ptr_of(qscales),
            qidx.data_ptr(), pair_bucket.data_ptr(), pair_order.data_ptr(), ptr.data_ptr(),
            chunk_of.data_ptr(), store.data_ptr(), ptr_of(scales), ptr_of(row_ids),
            ptr_of(floor_d), ptr_of(floor_p), out_d.data_ptr(), out_s.data_ptr(),
            n_pairs, qtile, k, store.shape[1], queries.shape[1] // terms, chunk, MODES[mode],
            _STORE_TYPES[store.dtype], store.shape[0], ctypes.byref(ran), stream,
        )
    if ran.value != body:
        raise RuntimeError(f"scan_pairs: the kernel takes the {BODY_NAMES[ran.value]} body, "
                           f"the queries are laid out for the {BODY_NAMES[body]} body")
    if err != 0:
        raise RuntimeError(f"scan_pairs kernel launch failed: cudaError {err}")
    global LAUNCHES, WGMMA_LAUNCHES, WGMMA_F32_LAUNCHES, WGMMA_F32MODE_LAUNCHES
    global WGMMA_WIDE_LAUNCHES, WGMMA_F32X_LAUNCHES, WGMMA_S8_LAUNCHES, WGMMA_S8_WIDE_LAUNCHES
    global WGMMA_F32MODE_WIDE_LAUNCHES, WGMMA_F32_WIDE_LAUNCHES
    global WGMMA_INT8_ROWMAP_LAUNCHES, WGMMA_F32MODE_ROWMAP_LAUNCHES
    LAUNCHES += 1
    WGMMA_LAUNCHES += ran.value > 0
    WGMMA_F32_LAUNCHES += ran.value == 2
    WGMMA_F32MODE_LAUNCHES += ran.value == 3
    WGMMA_WIDE_LAUNCHES += ran.value == 4
    WGMMA_F32X_LAUNCHES += ran.value == 5
    WGMMA_S8_LAUNCHES += ran.value == 6
    WGMMA_S8_WIDE_LAUNCHES += ran.value == 7
    WGMMA_F32MODE_WIDE_LAUNCHES += ran.value == 8
    WGMMA_F32_WIDE_LAUNCHES += ran.value == 9
    WGMMA_INT8_ROWMAP_LAUNCHES += ran.value == 10
    WGMMA_F32MODE_ROWMAP_LAUNCHES += ran.value == 11
    return out_d, out_s


def _kernel_round(queries, ptr, chunk_of, store, scales, qscales, row_ids, *, qtile: int,
                  chunk: int, mode: str, segment: Optional[int] = None):
    """``scan_round(qidx, pair_bucket, k, floor)`` of :func:`scan_in_rounds`:
    the pairs split into items (one host read of the plan, one upload),
    one scan kernel launch over the items and, where a pair split, one
    merge kernel launch (counted in ``SPLIT_LAUNCHES``), ``k <= MAX_K``,
    the queries laid out once for each body that reads them
    (:func:`scan_body`: a round's width may change the body).
    ``segment`` forces the segment length (tests and ``chip_smoke.py``);
    by default :func:`segment_length` picks it."""
    lib = cuda_build.load(SOURCE, _bind)
    terms = 3 if mode == "f32" else 1
    laid_out = {}

    def body_queries(body):
        qd = body.qd if body.wgmma else 0
        if qd not in laid_out:
            laid_out[qd] = operand_queries(queries, mode, store.dtype, qd)
        return laid_out[qd]

    def scan_round(q_idx, p_bucket, w, floor):
        n_pairs = p_bucket.shape[0]
        if n_pairs == 0:
            empty = torch.empty((0, qtile, w), device=store.device)
            return empty, empty.int()
        with span("lmi.split"):  # the round's host work; its launches in lmi.launch
            ptr_h, pb_h, live_h = host_plan(ptr, p_bucket, q_idx, qtile)
            body = scan_body(lib, store, mode, w, row_ids, floor is not None)
            seg = segment
            if seg is None:
                seg = segment_length(ptr_h, pb_h, live_h, width=list_width(w),
                                     slots=body.slots,
                                     wgmma_block=body.block_queries if body.wgmma else 0)

            def scan_items(i_qidx, i_bucket, i_ptr, i_floor):
                return _launch_items(lib, body_queries(body), qscales, i_qidx, i_bucket, i_ptr,
                                     chunk_of, store, scales, row_ids, i_floor, k=w,
                                     qtile=qtile, chunk=chunk, mode=mode, terms=terms,
                                     body=body.kind)

            global SPLIT_LAUNCHES
            # a bucket of several segments
            SPLIT_LAUNCHES += bool((np.diff(ptr_h)[pb_h] > seg).any())
            return scan_split(scan_items, merge_split_lists, q_idx, floor, ptr_h, pb_h, seg,
                              qtile=qtile, chunk=chunk)

    return scan_round


def scan_pairs(
    queries: torch.Tensor,
    qidx: torch.Tensor,
    pair_bucket: torch.Tensor,
    ptr: torch.Tensor,
    chunk_of: torch.Tensor,
    store: torch.Tensor,
    scales: Optional[torch.Tensor],
    qscales: Optional[torch.Tensor] = None,
    row_ids: Optional[torch.Tensor] = None,
    *,
    k: int,
    qtile: int,
    chunk: int,
    mode: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan (see module docstring): the CUDA kernels for CUDA tensors,
    the plain version for CPU tensors.  Same arguments and results as
    :func:`scan_pairs_reference`.  On CUDA each launch splits the pairs
    into items and merges them back (one scan launch, and one merge
    launch where a pair split), and
    a ``k`` above :data:`MAX_K` takes one such launch a round of at most
    ``MAX_K`` (:func:`scan_in_rounds`)."""
    if store.device.type == "cpu":
        return scan_pairs_reference(
            queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales, row_ids,
            k=k, qtile=qtile, chunk=chunk, mode=mode,
        )
    if store.device.type != "cuda":
        raise ValueError(f"scan_pairs runs on cpu or cuda, not {store.device}")
    _check(queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales, row_ids,
           k=k, qtile=qtile, chunk=chunk, mode=mode)
    scan_round = _kernel_round(queries, ptr, chunk_of, store, scales, qscales, row_ids,
                               qtile=qtile, chunk=chunk, mode=mode)
    if k <= MAX_K:
        return scan_round(qidx, pair_bucket, k, None)
    n_slots = store.shape[0] if row_ids is None else row_ids.shape[0]
    return scan_in_rounds(scan_round, qidx, pair_bucket,
                          chunk_positions(ptr, chunk_of, n_slots // chunk),
                          k=k, qtile=qtile, chunk=chunk)
