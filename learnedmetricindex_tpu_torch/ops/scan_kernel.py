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
  ``sm_90a`` at first use into ``build/torch_kernels/``) or raise.
* :func:`operand_queries` — the query rows the kernel reads in the
  tensor-core modes.
* ``LAUNCHES`` — how many times the wrapper launched the kernel.

Modes: ``"f32"`` (full f32, IEEE FMA on the CUDA cores), ``"bf16"`` (both
operands rounded to bf16, products summed in f32 on the tensor cores)
and ``"int8"`` (int8 queries with per-query ``qscales`` against an int8
store, exact integer sums on the tensor cores).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from learnedmetricindex_tpu_torch.ops import cuda_build
from learnedmetricindex_tpu_torch.ops.select import smallest_k

MODES = {"f32": 0, "bf16": 1, "int8": 2}
MAX_K = 256  # the widest top-k list of csrc/scan_pairs.cu
MAX_QTILE = 128  # QT in csrc/scan_pairs.cu
_STORE_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}

#: kernel launches made by :func:`scan_pairs` (never by the plain version)
LAUNCHES = 0

#: Depth order, within each group of 16, of the bf16 queries that meet an
#: int8 store: the kernel widens the 4 int8 values k = 4t..4t+3 that
#: ldmatrix gives lane t of a quad into the bf16 B registers of depths
#: (2t, 2t+1) and (2t+8, 2t+9) of an m16n8k16 step, so the query values
#: must sit at those depths too.
WIDEN_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)

SOURCE = cuda_build.CSRC / "scan_pairs.cu"


def build() -> Tuple[Path, float]:
    """Compile the kernel if this source has no build yet: ``(library
    path, seconds compiling)``."""
    return cuda_build.build_many([SOURCE])[0]


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lmi_scan_pairs.argtypes = [vp] * 11 + [ci] * 8 + [vp]
    lib.lmi_scan_pairs.restype = ci


def _check(queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales,
           *, k, qtile, chunk, mode):
    if mode not in MODES:
        raise ValueError(f"unknown scan mode {mode!r} (one of {sorted(MODES)})")
    tensors = [queries, qidx, pair_bucket, ptr, chunk_of, store, scales]
    if qscales is not None:
        tensors.append(qscales)
    if any(t.device != store.device for t in tensors):
        raise ValueError("scan_pairs: every tensor must be on the store's device")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("scan_pairs: tensors must be contiguous")
    for name, t in (("qidx", qidx), ("pair_bucket", pair_bucket), ("ptr", ptr),
                    ("chunk_of", chunk_of)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"scan_pairs: {name} must be 1-D int32")
    if store.dim() != 2 or store.dtype not in _STORE_TYPES:
        raise ValueError("scan_pairs: store must be (n_slots, d) f32, bf16 or int8")
    n_slots, d = store.shape
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"scan_pairs: queries must be (n, {d})")
    if scales.dtype != torch.float32 or scales.shape != (n_slots,):
        raise ValueError(f"scan_pairs: scales must be ({n_slots},) f32")
    if n_slots % chunk or n_slots >= 2**31:
        raise ValueError("scan_pairs: n_slots must be whole chunks and < 2**31")
    if qidx.shape[0] != pair_bucket.shape[0] * qtile:
        raise ValueError("scan_pairs: qidx must hold n_pairs * qtile slots")
    if not (1 <= qtile <= MAX_QTILE and 1 <= k <= MAX_K):
        raise ValueError(
            f"scan_pairs takes 1 <= qtile <= {MAX_QTILE} and 1 <= k <= {MAX_K}, "
            f"got qtile={qtile}, k={k}"
        )
    if mode == "int8":
        if store.dtype != torch.int8 or queries.dtype != torch.int8:
            raise ValueError("scan mode 'int8' needs an int8 store and int8 queries")
        if qscales is None or qscales.dtype != torch.float32 or qscales.shape != (queries.shape[0],):
            raise ValueError("scan mode 'int8' needs (n_queries,) f32 qscales")
        if d % 4 or store.data_ptr() % 4 or queries.data_ptr() % 4:
            raise ValueError(
                f"scan mode 'int8' copies rows in 4-byte granules: needs d % 4 == 0 (d={d}) "
                "and 4-byte aligned store and queries"
            )
    elif queries.dtype != torch.float32:
        raise ValueError(f"scan mode {mode!r} needs f32 queries")


def scan_pairs_reference(
    queries: torch.Tensor,  # (n_queries, d) f32, or int8 for mode "int8"
    qidx: torch.Tensor,  # (n_pairs·qtile,) int32 query row per slot, -1 = pad
    pair_bucket: torch.Tensor,  # (n_pairs,) int32
    ptr: torch.Tensor,  # (n_buckets+1,) int32 chunk CSR
    chunk_of: torch.Tensor,  # (n_assigned,) int32 CSR position → physical chunk
    store: torch.Tensor,  # (n_slots, d) f32 / bf16 / int8
    scales: torch.Tensor,  # (n_slots,) f32, 0 = padding slot
    qscales: Optional[torch.Tensor] = None,  # (n_queries,) f32, mode "int8"
    *,
    k: int,
    qtile: int,
    chunk: int,
    mode: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: one matmul per visited bucket
    over all of its query tiles.  Returns ``(dists, slots)``, each
    ``(n_pairs, qtile, k)``, ascending per query."""
    _check(queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales,
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
        x = store[slots].to(work)
        if mode == "bf16":
            q = q.to(torch.bfloat16).float()
            x = x.to(torch.bfloat16).float()
        raw = (q @ x.T).float()
        sc = scales[slots]
        dist = raw * (-sc)
        if mode == "int8":
            dist = dist * qscales[rows.clamp_min(0)][:, None]
        dist = dist + torch.where(sc == 0.0, torch.inf, 1.0)
        dist = torch.where((rows >= 0)[:, None], dist, torch.inf)
        kk = min(k, dist.shape[1])
        vals, pos = smallest_k(dist, kk)
        sel = torch.where(torch.isinf(vals), -1, slots[pos]).to(torch.int32)
        out_d[p0 : p0 + npairs, :, :kk] = vals.reshape(npairs, qtile, kk)
        out_s[p0 : p0 + npairs, :, :kk] = sel.reshape(npairs, qtile, kk)
    return out_d, out_s


def operand_queries(queries: torch.Tensor, mode: str, store_dtype: torch.dtype) -> torch.Tensor:
    """The query rows the kernel reads in mode ``"bf16"`` or ``"int8"``:
    bf16 (``queries`` rounded to nearest even, once per call) or the int8
    rows, zero-padded to a multiple of 16 values and 16-byte aligned; for
    bf16 over an int8 store, each group of 16 in :data:`WIDEN_ORDER`."""
    q = queries.to(torch.bfloat16) if mode == "bf16" else queries
    n, d = q.shape
    pad = -d % 16
    if pad:
        q = torch.cat([q, q.new_zeros((n, pad))], dim=1)
    if mode == "bf16" and store_dtype == torch.int8:
        order = torch.tensor(WIDEN_ORDER, device=q.device)
        q = q.reshape(n, (d + pad) // 16, 16)[:, :, order].reshape(n, d + pad)
    if not q.is_contiguous() or q.data_ptr() % 16:
        q = q.clone(memory_format=torch.contiguous_format)
    return q


def scan_pairs(
    queries: torch.Tensor,
    qidx: torch.Tensor,
    pair_bucket: torch.Tensor,
    ptr: torch.Tensor,
    chunk_of: torch.Tensor,
    store: torch.Tensor,
    scales: torch.Tensor,
    qscales: Optional[torch.Tensor] = None,
    *,
    k: int,
    qtile: int,
    chunk: int,
    mode: str,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan (see module docstring): the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors.  Same arguments and results as
    :func:`scan_pairs_reference`."""
    if store.device.type == "cpu":
        return scan_pairs_reference(
            queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales,
            k=k, qtile=qtile, chunk=chunk, mode=mode,
        )
    if store.device.type != "cuda":
        raise ValueError(f"scan_pairs runs on cpu or cuda, not {store.device}")
    _check(queries, qidx, pair_bucket, ptr, chunk_of, store, scales, qscales,
           k=k, qtile=qtile, chunk=chunk, mode=mode)
    lib = cuda_build.load(SOURCE, _bind)
    n_pairs = pair_bucket.shape[0]
    out_d = torch.empty((n_pairs, qtile, k), dtype=torch.float32, device=store.device)
    out_s = torch.empty((n_pairs, qtile, k), dtype=torch.int32, device=store.device)
    if n_pairs == 0:
        return out_d, out_s
    # blocks start on the largest buckets, so the long ones do not run last
    # alone (measured 1.25x at the flagship shape on an H100)
    n_chunks = (ptr[1:] - ptr[:-1])[pair_bucket.long()]
    pair_order = torch.argsort(n_chunks, descending=True, stable=True).to(torch.int32)
    if mode != "f32":
        queries = operand_queries(queries, mode, store.dtype)
    with torch.cuda.device(store.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.lmi_scan_pairs(
            queries.data_ptr(),
            qscales.data_ptr() if qscales is not None else None,
            qidx.data_ptr(), pair_bucket.data_ptr(), pair_order.data_ptr(), ptr.data_ptr(),
            chunk_of.data_ptr(),
            store.data_ptr(), scales.data_ptr(), out_d.data_ptr(), out_s.data_ptr(),
            n_pairs, qtile, k, store.shape[1], queries.shape[1], chunk, MODES[mode],
            _STORE_TYPES[store.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"scan_pairs kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out_d, out_s
