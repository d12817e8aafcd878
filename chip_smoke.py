#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--rows N]

Drives ``learnedmetricindex_tpu_torch`` through its public entry points
at the reference's flagship configuration — 120 buckets, MLP-4, a
10M×768 int8 packed store, 10k queries visiting 4 buckets, k=10 — in
phases:

1. device: CUDA must be present; prints the card's name and power limit;
2. build: compiles ``csrc/scan_pairs.cu`` and ``csrc/gather_rows.cu``
   with nvcc for sm_90a, both at once, and prints each kernel instance's
   registers and spills;
3. kernel vs plain: the scan kernel against its plain PyTorch version on
   the card at d 768, 96 and 100, all three modes over every store type
   they take, k 16 to 600 (every list width, 32 to 1024), qtile
   1/8/100/128, with duplicated rows whose exact ties must go to the
   earlier slot; f32 over int8 and bf16 stores also on rows of one power
   of two, where each distance needs all three bf16 terms of a query;
4. corpus: a seeded 10M×768 int8 corpus (+ f32 row scales) on the
   device and the exact f32 top-10 of the queries;
5. search path: an index whose MLP-4 encodes a nearest-centroid
   partition exactly, .npz round trip, packed store, timed searches and
   checks against exact kNN restricted to each query's visited buckets;
   then, at the flagship shape, the scan kernel, its plain version and
   the library yardstick (per bucket one matmul + ``torch.topk``) timed
   with CUDA events beside the least time the card could take (bound),
   the f32 kernel's and plain version's distances against float64 (the
   kernel's error may not exceed the plain version's), and
   the search's split between navigation, the scan and the rest;
6. build path: ``LearnedIndexBuilder`` at the bench's flagship
   configuration (1 level, 120 buckets, 4 epochs, batch 1024, lr 0.01,
   balanced class weights, seed 2023), save, load, packed store, search
   with ``LMI_GATHER_MODE=auto`` and ``=kernel`` (bit-identical), the
   gather kernel against its plain version and ``index_select`` at the
   path's shapes; then the 2-level [10, 10] index searched best-first at
   visits 1-8.

Each path runs with the launch counts set to 0 just before it and read
just after.  Any failure raises (exit code 1).  Without CUDA it exits
non-zero and prints no result.  The last two lines are the kernels JSON
and the result JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.data import BlobGenerator
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs
from learnedmetricindex_tpu_torch.index.serialization import index_from_arrays
from learnedmetricindex_tpu_torch.ops import cuda_build, gather_kernel, quantize, scan_kernel
from learnedmetricindex_tpu_torch.ops.knn import recall, restricted_knn

ROOT = Path(__file__).resolve().parent
WORK_DIR = ROOT / "build" / "chip_smoke"

# the scan kernel against its plain version: sorted candidate distances,
# and slot ids that may differ only where the distances are tied
RTOL, ATOL = 1e-4, 1e-5
TIE_RTOL, TIE_ATOL = 1e-6, 1e-7
# ... where "tied" for f32 sums of 768 products means within their
# rounding: the kernel (tensor-core sums of exact products, or an FMA
# chain over an f32 store) and cuBLAS add in other orders; the bf16 body
# and the FMA chain differed from it by up to 1.4e-6 and 1.7e-6 on unit
# vectors (H100 runs); int8 sums are exact in both, so int8 keeps the
# tight bar
FLOAT_TIE_ATOL = 5e-6
# f32 queries against rows that each hold one power of two (split_terms_check):
# every product is exact, so the plain version's f32 matmul is exact, and a
# distance needs all three bf16 terms of its query value.  The kernel stays
# within this share of 1 + |dot| of it; the same queries without their lo
# terms must miss the bar, or the check could not tell the bodies apart
SPLIT_REL_ERR = 2.0**-20
REPLACES = "learnedmetricindex_tpu/ops/scan_kernel.py:325"
KERNEL_SOURCE = "learnedmetricindex_tpu_torch/csrc/scan_pairs.cu"
GATHER_REPLACES = "learnedmetricindex_tpu/ops/gather_kernel.py:151"
GATHER_SOURCE = "learnedmetricindex_tpu_torch/csrc/gather_rows.cu"
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published device-memory rate
# published dense peaks of the H100 SXM at 700 W (operations/s): bf16 and
# int8 on the tensor cores, f32 on the CUDA cores.  The scan's bound takes
# the fastest exact form of its products on this card (scan_work): f32
# queries over an int8 or bf16 store are three bf16 terms whose products
# with the store's values are exact, so three bf16 passes; only f32 over
# an f32 store is bound by the CUDA cores' f32 rate
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


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


def earlier_duplicate_first(slots, partner, what: str) -> int:
    """Every list that holds the later copy of a duplicated row holds the
    earlier copy (``partner[later] = earlier``) before it: exact ties go
    to the earlier slot.  Returns how many later copies were checked."""
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
    built = cuda_build.build_many([scan_kernel.SOURCE, gather_kernel.SOURCE])
    for (path, seconds), src in zip(built, (KERNEL_SOURCE, GATHER_SOURCE)):
        log(f"[build] {src} -> {path.relative_to(ROOT)} "
            f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)}) in {seconds:.1f} s")
        report = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
        if shutil.which("c++filt"):  # the kernel instances' template arguments
            report = subprocess.run(["c++filt"], input=report, capture_output=True, text=True,
                                    timeout=60).stdout
        for line in report.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] both kernels, compiled in parallel: {time.perf_counter() - t0:.1f} s")


def reset_counts() -> None:
    scan_kernel.LAUNCHES = 0
    gather_kernel.LAUNCHES = 0


def read_counts() -> dict:
    return {"scan_pairs": scan_kernel.LAUNCHES, "gather_rows": gather_kernel.LAUNCHES}


def kv_stores(dev, d: int, seed: int = 7):
    """A small multi-chunk store of each type at width ``d`` (an empty
    bucket, padding slots, chunk 320: not a whole number of 128-row
    tiles), 60 rows duplicated later in their own bucket, and 300
    queries visiting 3 buckets (the first 60 are the duplicated rows and
    visit their bucket; 20 leave their last visit unused)."""
    g = BlobGenerator(16, d, seed=seed, noise=0.45, device=dev)
    n, nb, chunk = 6000, 7, 320
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
    row_slot = stores["f32"].row_slot.cpu().numpy()  # the same layout in all three
    partner = np.full(stores["f32"].chunk_data.shape[0], -1, np.int64)
    partner[row_slot[dst]] = row_slot[src]
    return stores, queries, order, chunk, partner


def phase_kernel_vs_plain(dev) -> dict:
    """The scan kernel against its plain version at widths 768, 96 and
    100 (rows not 16-byte aligned: a depth tail and narrower copies):
    every mode over every store type it takes (bf16 over f32/bf16/int8,
    int8, f32 over f32/bf16/int8) at k 16/36/64/100/256/300/600, every
    list width from 32 to 1024, with qtile 1/8/100/128 in turn; then f32
    over bf16 and int8 stores of one-hot rows (split_terms_check).
    Returns, per mode, (largest |Δd|, largest |Δd| where slots differ)."""
    qtiles = (1, 8, 100, 128)
    combos = [("bf16", "f32"), ("bf16", "bf16"), ("bf16", "int8"), ("int8", "int8"),
              ("f32", "bf16"), ("f32", "int8"), ("f32", "f32")]
    worst = {m: (0.0, 0.0) for m in ("f32", "bf16", "int8")}
    for d in (768, 96, 100):
        stores, queries, order, chunk, partner = kv_stores(dev, d)
        cases = [(mode, k, qtiles[(ki + si) % 4], store)
                 for ki, k in enumerate((16, 36, 64, 100, 256, 300, 600))
                 for si, (mode, store) in enumerate(combos)]
        for mode, k, qtile, store_name in cases:
            store = stores[store_name]
            plan, args = scan_inputs(store, queries, order, qtile, mode)
            kw = dict(k=k, qtile=qtile, chunk=chunk, mode=mode)
            kd, ks = scan_kernel.scan_pairs(*args, **kw)
            torch.cuda.synchronize()
            rd, rs = scan_kernel.scan_pairs_reference(*args, **kw)
            what = f"{mode} store={store_name} d={d} k={k} qtile={qtile}"
            err, gap = compare_candidates(kd, ks, rd, rs, mode, what)
            n_dup = earlier_duplicate_first(ks, partner, what)
            earlier_duplicate_first(rs, partner, f"{what} (plain)")
            n_swapped = int((ks != rs).sum().item())
            worst[mode] = (max(worst[mode][0], err), max(worst[mode][1], gap))
            log(f"[kernel-vs-plain] {what:36s} pairs={plan.n_pairs:4d}: agree, "
                f"max|Δd|={err:.3g}, {n_swapped} slots swapped at ties (max|Δd| there "
                f"{gap:.3g}), {n_dup} later duplicates after their earlier copy")
        del stores
        for si, store_name in enumerate(("bf16", "int8")):
            for ki, k in enumerate((16, 100)):
                split_terms_check(dev, d, store_name, k, qtiles[(2 * si + ki + d) % 4])
    for mode, (err, gap) in worst.items():
        log(f"[kernel-vs-plain] {mode}: max|Δd| {err:.3g}; at swapped slots {gap:.3g}")
    return worst


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


def phase_main(dev, data: dict, smi: str):
    corpus, row_scales, queries = data["corpus"], data["row_scales"], data["queries"]
    gt_ids, centroids = data["gt_ids"], data["centroids"]
    (n, d), nb, chunk, nq = corpus.shape, centroids.shape[0], 2048, queries.shape[0]
    block = 500_000
    t_all = time.perf_counter()

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
    t0 = time.perf_counter()
    store = index.prepare_packed_store((corpus, row_scales), data_prediction)
    torch.cuda.synchronize()
    log(f"[store] packed int8 store on device: {store.n_chunks} chunks of {chunk}, "
        f"{store.nbytes() / 1e9:.2f} GB, {time.perf_counter() - t0:.1f} s")
    del pred
    torch.cuda.empty_cache()

    def search(q, n_buckets=4, precision="default"):
        return index.search(None, q, None, q, data_prediction, n_buckets=n_buckets,
                            k=10, store=store, precision=precision)

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
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    # ------------------------------------------------------------------
    check(launches["scan_pairs"] > 0, "the main path launched the scan kernel")
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
        f"{launches}  [{smi}]")

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
    log(f"[check] precision=highest: equals visited-bucket exact kNN ({nc} queries, "
        f"{n_tied} ids differ at ties)")
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
    timing = {}
    for mode in ("bf16", "f32", "int8"):
        plan, sargs = scan_inputs(store, queries, order, 128, mode)
        kw = dict(k=16, qtile=128, chunk=chunk, mode=mode)
        mac, ops, peak, nbytes = scan_work(store, plan, order, d, 16, mode)
        bound = {"operations": ops / peak * 1e3, "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
        bound_by = max(bound, key=bound.get)
        k_ms = cuda_ms(lambda: scan_kernel.scan_pairs(*sargs, **kw), 3)
        p_ms = cuda_ms(lambda: scan_kernel.scan_pairs_reference(*sargs, **kw), 1)
        lib_ms = cuda_ms(library_scan(store, plan, sargs, 16, mode), 1)
        torch.cuda.empty_cache()  # the library's slab copies
        kd, ks = scan_kernel.scan_pairs(*sargs, **kw)
        rd, rs = scan_kernel.scan_pairs_reference(*sargs, **kw)
        err, gap = compare_candidates(kd, ks, rd, rs, mode, f"flagship {mode}")
        if mode == "f32":  # no less exact than cuBLAS's f32: both against float64
            k_err = float64_error(store, sargs[0], plan, kd, ks)
            p_err = float64_error(store, sargs[0], plan, rd, rs)
            log(f"[flagship] scan_pairs f32 against float64 distances, the candidates of the first "
                f"16 pairs: kernel max|err| {k_err:.3g}, plain {p_err:.3g}")
            check(k_err <= p_err, f"flagship f32: the kernel's error against float64 {k_err:.3g} "
                  f"exceeds the plain version's {p_err:.3g}")
        timing[mode] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "err": err,
                        "bound_ms": bound[bound_by], "bound_by": bound_by}
        log(f"[flagship] scan_pairs {mode}: kernel {k_ms:.3f} ms, plain {p_ms:.2f} ms, library "
            f"{lib_ms:.2f} ms; bound {bound[bound_by]:.3f} ms by {bound_by} ({mac:.4g} MAC, "
            f"{ops:.4g} operations at {peak / 1e12:g} T/s, {nbytes / 1e9:.3f} GB) = "
            f"{bound[bound_by] / k_ms:.1%} of it; {plan.n_pairs} pairs, "
            f"{mac / k_ms / 1e9:.1f} TMAC/s; agree, max|Δd|={err:.3g} (at swapped slots "
            f"{gap:.3g})  [{smi}]")
    scan_s = timing["bf16"]["ms"] / 1e3
    log(f"[split] search at default precision {mean_s:.4f} s per {nq}: navigation "
        f"{measured['inference']:.4f} s, scan kernel {scan_s:.4f} s (CUDA events, same plan), "
        f"plan + merge + rerank + copy {measured['seq_search'] - scan_s:.4f} s (seq_search "
        f"{measured['seq_search']:.4f} s of the last rep)")
    log(f"[main] total {time.perf_counter() - t_all:.1f} s")
    del store
    torch.cuda.empty_cache()
    return launches, timing


def scan_work(store, plan, order, d: int, k: int, mode: str) -> tuple:
    """What the scan of this visit set needs: (multiply-adds, operations,
    the peak rate they run at, bytes).  Multiply-adds: each visiting
    query with each true row of the bucket it visits (no tile or chunk
    padding).  Operations: 2 per multiply-add in the mode's type, 6 (three
    bf16 passes at the bf16 rate) for f32 queries over an int8 or bf16
    store, whose exact product is that.  Bytes: each visited bucket's rows
    and row scales read once, the queries read once in the mode's type,
    the (n_pairs, qtile, k) distances and slots written once."""
    sizes = torch.as_tensor(store.bucket_sizes, device=order.device).long()
    visits = order[order >= 0].long()
    rows = float(sizes[visits].sum())
    visited = torch.unique(visits)
    row_bytes = d * store.chunk_data.element_size() + 4
    q_bytes = {"f32": 4, "bf16": 2, "int8": 1}[mode] * d
    out_bytes = plan.n_pairs * 128 * k * 8
    nbytes = float(sizes[visited].sum()) * row_bytes + order.shape[0] * q_bytes + out_bytes
    split = mode == "f32" and store.chunk_data.dtype != torch.float32
    peak = PEAK_OPS["bf16" if split else mode]
    return rows * d, (6.0 if split else 2.0) * rows * d, peak, nbytes


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
    cast to bf16 or f32 once, here, outside what is timed.  The port
    never calls it."""
    queries, qidx = sargs[0], plan.qidx
    ptr = store.bucket_chunk_start
    chunk = store.chunk
    buckets, runs = torch.unique_consecutive(plan.pair_bucket.cpu(), return_counts=True)
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
        x = store.chunk_data[int(ptr[b]) * chunk : int(ptr[b + 1]) * chunk]
        work.append((q, x if mode == "int8" else x.to(q.dtype)))

    def run():
        for q, x in work:
            if mode == "int8":
                sims = torch._int_mm(q, x.T)
            else:
                sims = q @ x.T
            torch.topk(sims, k, dim=1)

    return run


def gather_vs_plain(table, idx, what: str, smi: str) -> dict:
    """The gather kernel against its plain version on one (table, idx):
    bit-equal, then the kernel, the plain version and the library call
    (one ``index_select`` on indices clamped beforehand) timed with CUDA
    events.  The bound is the bytes moved (rows read and written once,
    the indices read once) over 3.35 TB/s."""
    got = gather_kernel.gather_rows(table, idx)
    torch.cuda.synchronize()
    ref = gather_kernel.gather_rows_reference(table, idx)
    check(got.dtype == ref.dtype and got.shape == ref.shape, f"gather {what}: shape and type")
    check(torch.equal(got.view(torch.uint8), ref.view(torch.uint8)), f"gather {what}: bit-equal")
    wide = torch.float64 if got.dtype.is_floating_point else torch.int64
    err = float((got.to(wide) - ref.to(wide)).abs().max()) if got.numel() else 0.0
    k_ms = cuda_ms(lambda: gather_kernel.gather_rows(table, idx), 10)
    p_ms = cuda_ms(lambda: gather_kernel.gather_rows_reference(table, idx), 10)
    clamped = idx.long().clamp(0, table.shape[0] - 1)
    lib_ms = cuda_ms(lambda: torch.index_select(table, 0, clamped), 10)
    row_bytes = table.shape[1] * table.element_size()
    moved = 2 * idx.shape[0] * row_bytes + idx.shape[0] * idx.element_size()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    log(f"[gather-vs-plain] {what}: table {tuple(table.shape)} {table.dtype}, {idx.shape[0]} "
        f"indices: bit-equal; kernel {k_ms:.4f} ms ({moved / k_ms / 1e6:.1f} GB/s, "
        f"{moved / k_ms / 1e-3 / HBM_BYTES_PER_S:.1%} of 3.35 TB/s), plain {p_ms:.4f} ms, "
        f"index_select {lib_ms:.4f} ms, bound {bound_ms:.4f} ms  [{smi}]")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "err": err,
            "bound_ms": bound_ms, "bound_by": "bytes"}


def visited_recall(index, store, queries, n_buckets, ids, policy, nc=256) -> float:
    """Recall@10 of ``ids`` against exact kNN over the buckets each of the
    first ``nc`` queries visits."""
    order, _ = index.compute_bucket_order(queries[:nc], n_buckets, policy=policy,
                                          keep_on_device=True)
    _, ref_i = restricted_knn(store, queries[:nc], order, 10)
    return recall(ids[:nc], ref_i.cpu().numpy(), 10)


def phase_build_path(dev, data: dict, smi: str):
    """The build path at full width: LearnedIndexBuilder → save → load →
    packed store → search in both gather modes; then the 2-level index."""
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

    results, counts = {}, {}
    for mode in ("auto", "kernel"):
        os.environ["LMI_GATHER_MODE"] = mode
        reset_counts()
        t0 = time.perf_counter()
        dists, ids, _ = search(index, store, saved_pred, 4)
        seconds = time.perf_counter() - t0
        counts[mode] = read_counts()
        results[mode] = (dists, ids)
        log(f"[search] built index, LMI_GATHER_MODE={mode}: {seconds:.4f} s per {nq} queries; "
            f"launches {counts[mode]}")
    os.environ["LMI_GATHER_MODE"] = "auto"
    check(counts["auto"]["gather_rows"] == 0, "auto mode launches no gather kernel")
    check(counts["kernel"]["gather_rows"] > 0, "kernel mode launches the gather kernel")
    check(counts["kernel"]["scan_pairs"] > 0, "the build path's search launches the scan kernel")
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

    # ---- the gather kernel against its plain version at the path's shapes ----
    order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
    plan, sargs = scan_inputs(store, queries, order, 128, "bf16")
    timing = {"work queries": gather_vs_plain(queries, plan.qidx, "work queries", smi)}
    cand_d, cand_s = scan_kernel.scan_pairs(*sargs, k=16, qtile=128, chunk=chunk, mode="bf16")
    rows = plan.pair_rows
    timing["merge dists"] = gather_vs_plain(cand_d.reshape(-1, 16), rows, "merge dists", smi)
    timing["merge slots"] = gather_vs_plain(cand_s.reshape(-1, 16), rows, "merge slots", smi)
    g = torch.Generator(device=dev).manual_seed(5)
    slots = torch.randint(0, store.chunk_data.shape[0], (nq * 16,), generator=g, device=dev)
    timing["store rows"] = gather_vs_plain(store.chunk_data, slots, "store rows", smi)
    n_slots = store.chunk_data.shape[0]
    wild = torch.tensor([-7, -1, 0, 5, n_slots - 1, n_slots, n_slots + 9, 2**31 - 1],
                        dtype=torch.int32, device=dev)
    timing["out of range"] = gather_vs_plain(store.chunk_data, wild, "out-of-range indices", smi)
    del store, cand_d, cand_s, plan, sargs
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
    check(counts2["gather_rows"] > 0 and counts2["scan_pairs"] > 0,
          "2-level searches launch both kernels")
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
    launches = {k: counts["kernel"][k] + counts2[k] for k in counts2}
    log(f"[build-path] total {time.perf_counter() - t_all:.1f} s")
    return launches, timing


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, default=10_000_000, help="corpus rows")
    args = p.parse_args()

    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    small = phase_kernel_vs_plain(dev)
    data = make_corpus(dev, args.rows, 10_000, 120)
    main_launches, timing = phase_main(dev, data, smi)
    build_launches, gather_timing = phase_build_path(dev, data, smi)
    rows = []
    for name, source, replaces, t, errs in (
        ("scan_pairs", KERNEL_SOURCE, REPLACES, timing["bf16"],
         [e for pair in small.values() for e in pair[:1]] + [t["err"] for t in timing.values()]),
        ("gather_rows", GATHER_SOURCE, GATHER_REPLACES, gather_timing["work queries"],
         [t["err"] for t in gather_timing.values()]),
    ):
        rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                     "launches": main_launches[name] + build_launches[name],
                     "max_abs_err": max(errs), "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                     "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    sys.exit(main())
