"""The CUDA kernels (bucket scan, row gather) against their plain
PyTorch versions, also over mutated stores whose chunk lists are out of
physical order, and the port's search, build and dynamic checkpoints on
the GPU.

These need an NVIDIA GPU (sm_90a) and nvcc and skip elsewhere.  The file
imports no jax, so on a machine with a GPU and no jax it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, build_plan, scan_inputs
from learnedmetricindex_tpu_torch.index import mutation
from learnedmetricindex_tpu_torch.index.serialization import index_from_arrays
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.ops import cuda_build, gather_kernel, quantize, scan_kernel

torch.set_num_threads(2)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the scan kernel runs only on the GPU")
    return torch.device("cuda")


def _corpus(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(12, d)).astype(np.float32)
    x = centers[rng.integers(0, 12, n)] + 0.3 * rng.normal(size=(n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32), rng


def _tensor_core_cases():
    """Every body: bf16 over every store type, int8, f32 over bf16 and
    int8 stores (three bf16 terms a query value) and over an f32 store
    (six products of three terms on each side), at k
    16/36/64/100/256/300/600 (list widths 32 to 1024) with qtile
    1/8/100/128 in turn, at d 768, 96 and 100 (rows not 16-byte aligned and a depth
    tail)."""
    combos = [("bf16", "float32"), ("bf16", "bfloat16"), ("bf16", "int8"), ("int8", "int8"),
              ("f32", "bfloat16"), ("f32", "int8"), ("f32", "float32")]
    qtiles = (1, 8, 100, 128)
    return [(mode, store, k, qtiles[(ki + ci) % 4], d)
            for d in (768, 96, 100)
            for ki, k in enumerate((16, 36, 64, 100, 256, 300, 600))
            for ci, (mode, store) in enumerate(combos)]


@pytest.mark.parametrize(
    "mode,store_dtype,k,qtile,d",
    [(m, s, k, q, 64) for m, s, k, q in [
        ("f32", "float32", 12, 128), ("f32", "int8", 24, 8), ("bf16", "bfloat16", 16, 16),
        ("bf16", "int8", 10, 128), ("int8", "int8", 24, 16), ("int8", "int8", 16, 128),
        # list widths past 32; k 256 splits a pair's queries over two blocks
        ("f32", "float32", 36, 128), ("bf16", "int8", 36, 16), ("int8", "int8", 36, 8),
        ("f32", "bfloat16", 64, 16), ("bf16", "bfloat16", 64, 128), ("int8", "int8", 64, 128),
        ("f32", "float32", 100, 1),
        ("f32", "float32", 256, 100), ("bf16", "int8", 256, 128), ("int8", "int8", 256, 16),
        # 512 and 1024: four and eight blocks a pair
        ("f32", "float32", 300, 8), ("f32", "float32", 600, 128)]]
    # int8 rows of 30 and 102 bytes: no 4-byte granule, staged through registers
    + [("int8", "int8", 16, 128, 30), ("int8", "int8", 36, 8, 30), ("int8", "int8", 16, 100, 102),
       ("int8", "int8", 100, 128, 102), ("bf16", "int8", 16, 128, 30), ("f32", "int8", 16, 8, 102)]
    # f32 rows of 28 and 24 bytes: copied 4 and 8 bytes at a time
    + [("f32", "float32", 16, 128, 7), ("f32", "float32", 100, 8, 7),
       ("f32", "float32", 36, 100, 6), ("f32", "float32", 300, 1, 6)]
    + _tensor_core_cases(),
)
def test_kernel_matches_plain_version(cuda, mode, store_dtype, k, qtile, d):
    """Multi-chunk buckets, an empty bucket, padding slots, a chunk that
    is not a whole number of the kernel's 128-row tiles, unused visits,
    and 40 rows duplicated later in their own bucket.  int8 is bit-equal
    (distances and slots); f32/bf16 within the bars, with slots differing
    only at ties; exact ties between duplicated rows go to the earlier
    slot."""
    data, rng = _corpus(3000, d, seed=d + k)
    nb, chunk = 6, 96
    bucket_ids = rng.integers(0, nb, 3000)
    bucket_ids[bucket_ids == 2] = 3
    src, dst = np.arange(0, 40), np.arange(1500, 1540)  # dst duplicates src, same bucket
    data[dst], bucket_ids[dst] = data[src], bucket_ids[src]
    if store_dtype == "int8":
        store = BucketStore.build_packed_int8(data, bucket_ids, nb, chunk=chunk, device=cuda)
    else:
        store = BucketStore.build(data, bucket_ids, nb, chunk=chunk, dtype=store_dtype, device=cuda)
    queries = torch.as_tensor(np.concatenate([data[src], data[40:150] + 0.05]), device=cuda)
    order = np.stack([rng.choice(nb, 3, replace=False) for _ in range(150)])
    order[:40, 0] = bucket_ids[src]  # the duplicated rows' queries visit their bucket
    order[:40, 1:] = [[b for b in rng.permutation(nb) if b != bucket_ids[i]][:2] for i in src]
    order = torch.as_tensor(order, device=cuda)
    order[-10:, 2] = -1
    _, args = scan_inputs(store, queries, order, qtile, mode)
    kw = dict(k=k, qtile=qtile, chunk=chunk, mode=mode)
    before = scan_kernel.LAUNCHES
    kd, ks = scan_kernel.scan_pairs(*args, **kw)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES == before + 1
    rd, rs = scan_kernel.scan_pairs_reference(*args, **kw)
    assert scan_kernel.LAUNCHES == before + 1
    kd, ks, rd, rs = (t.cpu().numpy() for t in (kd, ks, rd, rs))
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(rd))
    if mode == "int8":
        np.testing.assert_array_equal(kd.view(np.uint32), rd.view(np.uint32))
        np.testing.assert_array_equal(ks, rs)
    else:
        np.testing.assert_allclose(kd, rd, rtol=1e-4, atol=1e-5)
        mism = ks != rs
        # ties within the rounding of f32 sums in two orders: 64 products,
        # or up to 768 (the tensor cores and cuBLAS sum in other orders)
        tie_atol = 4e-7 if d == 64 else 5e-6
        np.testing.assert_allclose(kd[mism], rd[mism], rtol=1e-6, atol=tie_atol)
    partner = np.full(store.chunk_data.shape[0], -1)
    row_slot = store.row_slot.cpu().numpy()
    partner[row_slot[dst]] = row_slot[src]
    lists = ks.reshape(-1, k)
    earlier = np.where(lists >= 0, partner[np.maximum(lists, 0)], -1)
    rows, cols = np.nonzero(earlier >= 0)
    assert len(rows) > 0
    for r, j in zip(rows, cols):
        assert (lists[r, :j] == earlier[r, j]).any(), (r, j)


@pytest.mark.parametrize("store_dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("d,k,qtile", [(768, 16, 128), (100, 100, 8), (96, 300, 1)])
def test_f32_body_reads_all_three_query_terms(cuda, store_dtype, d, k, qtile):
    """f32 queries against rows that each hold one power of two (int8
    rows with f32 scales): every product is exact, so the plain
    version's f32 matmul is exact, and each distance needs all three
    bf16 terms of its query value.  The kernel stays within 2^-20 of
    1 + |dot| of the plain version at every rank; the queries' hi + mid
    alone miss that bar."""
    rng = np.random.default_rng(d + k)
    n, nb, chunk = 3000, 5, 96
    dtype = getattr(torch, store_dtype)
    x = torch.zeros((n, d), dtype=dtype, device=cuda)
    vals = np.ldexp(rng.choice([-1.0, 1.0], n), rng.integers(0, 7, n)).astype(np.float32)
    x[torch.arange(n), torch.as_tensor(rng.integers(0, d, n))] = torch.as_tensor(vals).to(
        cuda, dtype)
    scales = (torch.as_tensor(rng.uniform(0.01, 0.03, n).astype(np.float32), device=cuda)
              if store_dtype == "int8" else None)
    store = BucketStore.build_packed_device(x, rng.integers(0, nb, n), nb, chunk=chunk,
                                            row_scales=scales)
    queries = torch.as_tensor(rng.normal(size=(150, d)).astype(np.float32), device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(nb, 3, replace=False) for _ in range(150)]),
                            device=cuda)
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    kw = dict(k=k, qtile=qtile, chunk=chunk, mode="f32")
    kd, _ = scan_kernel.scan_pairs(*args, **kw)
    rd, _ = scan_kernel.scan_pairs_reference(*args, **kw)
    hi, mid, _ = scan_kernel.split_f32(args[0])
    td, _ = scan_kernel.scan_pairs_reference(hi.float() + mid.float(), *args[1:], **kw)
    fin = torch.isfinite(rd)
    assert torch.equal(fin, torch.isfinite(kd)) and fin.any()
    bar = 2.0**-20 * (1.0 + (1.0 - rd[fin]).abs())
    assert ((kd[fin] - rd[fin]).abs() <= bar).all()
    assert ((td[fin] - rd[fin]).abs() > bar).any()


def _split_edge_rows(kind, n, rng):
    """f32 store values where the kernel's split of the store must be exact:
    bf16 binade edges (2^e, its neighbours, 1.5·2^e, the top of the binade)
    with random mantissas between them, or large magnitudes up to the
    largest f32 (where rounding to bf16 overflows), with the query scale
    that keeps the products finite."""
    if kind == "binade_edges":
        e = rng.integers(-40, 40, n).astype(np.float64)
        m = rng.choice([1.0, 1.0 + 2.0**-23, 2.0 - 2.0**-23, 1.5, 2.0 - 2.0**-7,
                        1.0 + 2.0**-8 + 2.0**-16], n)
        m = np.where(rng.random(n) < 0.5, m, rng.integers(2**23, 2**24, n) / 2.0**23)
        return (m * 2.0**e).astype(np.float32), 1.0
    e = rng.integers(90, 127, n).astype(np.float64)
    v = (rng.integers(2**23, 2**24, n) / 2.0**23 * 2.0**e).astype(np.float32)
    v[:8] = np.array([0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0x7F7F0000] * 2, np.uint32).view(np.float32)
    return v, 2.0**-90


@pytest.mark.parametrize("kind", ["binade_edges", "large"])
@pytest.mark.parametrize("d,k,qtile", [(768, 16, 128), (100, 100, 8), (7, 300, 1)])
def test_f32_store_split_is_exact(cuda, kind, d, k, qtile):
    """f32 queries over an f32 store whose rows each hold one value at a
    bf16 binade edge or of a large magnitude (up to the largest f32):
    every distance is one product, which the plain version rounds once.
    The kernel stays within 2^-20 of 1 + |dot| of it at every rank; the
    store rows without their lo term (the plain version over hi + mid)
    miss that bar somewhere, so the kernel reads all three store terms."""
    rng = np.random.default_rng(d + k + len(kind))
    n, nb, chunk = 3000, 5, 96
    vals, q_scale = _split_edge_rows(kind, n, rng)
    vals *= rng.choice([-1.0, 1.0], n).astype(np.float32)
    x = torch.zeros((n, d), dtype=torch.float32, device=cuda)
    x[torch.arange(n), torch.as_tensor(rng.integers(0, d, n))] = torch.as_tensor(vals, device=cuda)
    store = BucketStore.build_packed_device(x, rng.integers(0, nb, n), nb, chunk=chunk)
    z = rng.normal(size=(150, d))
    z = np.sign(z) * np.maximum(np.abs(z), 2.0**-10)  # |q| >= 2^-100: split_f32 exact
    queries = torch.as_tensor((z * q_scale).astype(np.float32), device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(nb, 3, replace=False) for _ in range(150)]),
                            device=cuda)
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    kw = dict(k=k, qtile=qtile, chunk=chunk, mode="f32")
    kd, _ = scan_kernel.scan_pairs(*args, **kw)
    rd, _ = scan_kernel.scan_pairs_reference(*args, **kw)
    hi, mid, _ = scan_kernel.split_f32_truncated(args[5])
    two = (*args[:5], hi.float() + mid.float(), *args[6:])
    td, _ = scan_kernel.scan_pairs_reference(*two, **kw)
    fin = torch.isfinite(rd)
    assert torch.equal(fin, torch.isfinite(kd)) and fin.any()
    bar = 2.0**-20 * (1.0 + (1.0 - rd[fin]).abs())
    assert ((kd[fin] - rd[fin]).abs() <= bar).all()
    assert ((td[fin] - rd[fin]).abs() > bar).any()


def test_f32_store_kernel_is_no_less_exact_than_plain(cuda):
    """Over an f32 store of unit rows at d 768, the kernel's distances of
    the candidates it returns are no farther from float64 than the plain
    version's (cuBLAS SGEMM in full f32) of its own candidates."""
    data, rng = _corpus(6000, 768, seed=5)
    store = BucketStore.build(data, rng.integers(0, 4, 6000), 4, chunk=256, device=cuda)
    queries = torch.as_tensor(data[:400] + 0.05 * rng.normal(size=(400, 768)).astype(np.float32),
                              device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(4, 2, replace=False) for _ in range(400)]),
                            device=cuda)
    _, args = scan_inputs(store, queries, order, 128, "f32")
    kw = dict(k=32, qtile=128, chunk=256, mode="f32")
    rows = args[1].reshape(-1, 128).long()

    def error(dists, slots):
        ok = (slots >= 0) & (rows >= 0)[:, :, None]
        q = args[0][rows.clamp_min(0)].double()
        x = args[5][slots.long().clamp_min(0)].double()
        exact = 1.0 - torch.einsum("pqd,pqkd->pqk", q, x)
        return float((dists.double() - exact).abs()[ok].max())

    k_err = error(*scan_kernel.scan_pairs(*args, **kw))
    p_err = error(*scan_kernel.scan_pairs_reference(*args, **kw))
    assert 0.0 < k_err <= p_err, (k_err, p_err)


def test_kernel_rejects_what_it_does_not_take(cuda):
    """Tensors on two devices and int8 queries in another mode raise; int8
    rows of 6 bytes (no 4-byte granule) run and equal the plain version,
    also at k past the widest list (1025, in two rounds)."""
    store = BucketStore.build(np.ones((64, 6), np.float32), np.zeros(64, int), 1, chunk=32,
                              device=cuda)
    plan = build_plan(torch.zeros((4, 1), dtype=torch.int64, device=cuda), 1, 8)
    q8, qs = quantize.quantize_rows(torch.ones((4, 6), device=cuda))
    args = (q8, plan.qidx, plan.pair_bucket,
            torch.as_tensor(store.bucket_chunk_start, dtype=torch.int32, device=cuda),
            torch.arange(store.n_chunks, dtype=torch.int32, device=cuda),
            store.chunk_data.to(torch.int8), store.scales_flat(), qs)
    kd, ks = scan_kernel.scan_pairs(*args, k=4, qtile=8, chunk=32, mode="int8")
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=4, qtile=8, chunk=32, mode="int8")
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32)) and torch.equal(ks, rs)
    with pytest.raises(ValueError, match="device"):
        scan_kernel.scan_pairs(*(a.cpu() if i == 0 else a for i, a in enumerate(args)),
                               k=4, qtile=8, chunk=32, mode="int8")
    with pytest.raises(ValueError, match="f32 queries"):
        scan_kernel.scan_pairs(*args, k=4, qtile=8, chunk=32, mode="bf16")
    before = scan_kernel.LAUNCHES
    kd, ks = scan_kernel.scan_pairs(*args, k=1025, qtile=8, chunk=32, mode="int8")
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=1025, qtile=8, chunk=32, mode="int8")
    assert scan_kernel.LAUNCHES == before + 1  # 64 rows: the first round leaves lists short
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32)) and torch.equal(ks, rs)


@pytest.mark.parametrize("precision", ["highest", "default", "int8"])
def test_search_on_gpu_matches_cpu(cuda, precision):
    data, rng = _corpus(4000, 64, seed=9)
    nb = 8
    params = [{"w": rng.normal(size=(1, 64, 32)).astype(np.float32),
               "b": np.zeros((1, 32), np.float32)},
              {"w": rng.normal(size=(1, 32, nb)).astype(np.float32),
               "b": np.zeros((1, nb), np.float32)}]
    cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-6", 0.01, [nb], chunk_size=128)
    pred = rng.integers(0, nb, (4000, 1))
    results = []
    for dev in ("cpu", cuda):
        index = index_from_arrays(cfg, [params], [np.ones((1, nb), bool)], ["MLP-6"],
                                  np.ones(nb, bool), dev)
        store = BucketStore.build_packed_int8(
            data, index.bucket_ids_from_prediction(pred), nb, chunk=128, device=dev)
        results.append(index.search(None, data[:300], None, data[:300], pred, n_buckets=3,
                                    k=10, store=store, precision=precision))
    (cd, ci, _), (gd, gi, _) = results
    np.testing.assert_allclose(gd, cd, rtol=1e-4, atol=1e-5)
    mism = gi != ci
    if mism.any():
        np.testing.assert_allclose(gd[mism], cd[mism], rtol=1e-6, atol=4e-7)


@pytest.mark.parametrize(
    "dtype,d",
    [(torch.float32, 768), (torch.float32, 16), (torch.float32, 7), (torch.int32, 16),
     (torch.int8, 768), (torch.int8, 8), (torch.bfloat16, 768), (torch.bfloat16, 6)],
)
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_gather_kernel_matches_plain_version(cuda, dtype, d, index_dtype):
    """Bit-equal rows for 16-byte and 4-byte row words, out-of-range
    indices clamped, one launch counted."""
    g = torch.Generator(device=cuda).manual_seed(d)
    table = torch.randint(-100, 100, (5000, d), generator=g, device=cuda).to(dtype)
    idx = torch.randint(-50, 5050, (3333,), generator=g, device=cuda).to(index_dtype)
    idx[:3] = torch.tensor([-(2**31), 2**31 - 1, 4999])
    before = gather_kernel.LAUNCHES
    got = gather_kernel.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather_kernel.LAUNCHES == before + 1
    ref = gather_kernel.gather_rows_reference(table, idx)
    assert gather_kernel.LAUNCHES == before + 1
    assert got.dtype == dtype and torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    assert gather_kernel.gather_rows(table, idx[:0]).shape == (0, d)


def test_gather_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="multiple of 4 bytes"):
        gather_kernel.gather_rows(torch.zeros((4, 3), dtype=torch.int8, device=cuda),
                                  torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        gather_kernel.gather_rows(torch.zeros((4, 8), device=cuda)[:, ::2],
                                  torch.zeros(2, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="device"):
        gather_kernel.gather_rows(torch.zeros((4, 8), device=cuda),
                                  torch.zeros(2, dtype=torch.int32))


@pytest.mark.parametrize("k", [1, 3, 10, 16])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_gather_pairs_matches_plain_version(cuda, k, index_dtype):
    """The merge's gather in one launch, bit-equal to its plain version:
    16-byte vectors (k 16) and 4-byte words (k 1, 3, 10), rows -1, 0, the
    last and beyond the end."""
    g = torch.Generator(device=cuda).manual_seed(k)
    R, V, Q = 6000, 4, 5000
    cand_d = torch.randn((R, k), generator=g, device=cuda)
    cand_d[::7] = torch.inf
    cand_d[1, 0] = -0.0
    cand_s = torch.randint(-1, 10**6, (R, k), generator=g, device=cuda, dtype=torch.int32)
    rows = torch.randint(-1, R + 3, (Q * V,), generator=g, device=cuda).to(index_dtype)
    rows[:4] = torch.tensor([-1, 0, R - 1, R + 100])
    before = (gather_kernel.LAUNCHES, gather_kernel.PAIR_LAUNCHES)
    gd, gs = gather_kernel.gather_pairs(cand_d, cand_s, rows, V)
    torch.cuda.synchronize()
    assert (gather_kernel.LAUNCHES, gather_kernel.PAIR_LAUNCHES) == (before[0], before[1] + 1)
    rd, rs = gather_kernel.gather_pairs_reference(cand_d, cand_s, rows, V)
    assert gd.shape == rd.shape == (Q, V * k) and gs.dtype == torch.int32
    assert torch.equal(gd.view(torch.int32), rd.view(torch.int32)) and torch.equal(gs, rs)
    assert gather_kernel.PAIR_LAUNCHES == before[1] + 1


@pytest.mark.parametrize("precision", ["highest", "default", "int8"])
def test_gather_modes_bit_identical_on_gpu(cuda, monkeypatch, precision):
    data, rng = _corpus(4000, 64, seed=4)
    nb = 8
    params = [{"w": rng.normal(size=(1, 64, 32)).astype(np.float32),
               "b": np.zeros((1, 32), np.float32)},
              {"w": rng.normal(size=(1, 32, nb)).astype(np.float32),
               "b": np.zeros((1, nb), np.float32)}]
    cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-6", 0.01, [nb], chunk_size=128)
    pred = rng.integers(0, nb, (4000, 1))
    index = index_from_arrays(cfg, [params], [np.ones((1, nb), bool)], ["MLP-6"],
                              np.ones(nb, bool), cuda)
    store = BucketStore.build_packed_int8(
        data, index.bucket_ids_from_prediction(pred), nb, chunk=128, device=cuda)
    out = {}
    for mode in ("auto", "kernel"):
        monkeypatch.setenv("LMI_GATHER_MODE", mode)
        before = (gather_kernel.LAUNCHES, gather_kernel.PAIR_LAUNCHES)
        out[mode] = index.search(None, data[:300], None, data[:300], pred, n_buckets=3, k=30,
                                 store=store, precision=precision)[:2]
        launched = (gather_kernel.LAUNCHES - before[0], gather_kernel.PAIR_LAUNCHES - before[1])
        # kernel mode: one merge gather, and no work-query rows gathered
        assert launched == ((0, 1) if mode == "kernel" else (0, 0))
    np.testing.assert_array_equal(out["auto"][0].view(np.uint32), out["kernel"][0].view(np.uint32))
    np.testing.assert_array_equal(out["auto"][1], out["kernel"][1])


def test_exact_stages_stay_f32_under_a_tf32_setting(cuda):
    """After ``torch.set_float32_matmul_precision("high")`` (TF32 for the
    caller's matmuls), the search's reranked distances and ``exact_knn``
    stay within the 5e-6 band of float64, and the setting survives."""
    from learnedmetricindex_tpu_torch.ops.knn import exact_knn

    data, rng = _corpus(4000, 768, seed=12)
    nb = 8
    params = [{"w": rng.normal(size=(1, 768, 32)).astype(np.float32),
               "b": np.zeros((1, 32), np.float32)},
              {"w": rng.normal(size=(1, 32, nb)).astype(np.float32),
               "b": np.zeros((1, nb), np.float32)}]
    cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-6", 0.01, [nb], chunk_size=128)
    pred = rng.integers(0, nb, (4000, 1))
    index = index_from_arrays(cfg, [params], [np.ones((1, nb), bool)], ["MLP-6"],
                              np.ones(nb, bool), cuda)
    store = BucketStore.build(data, index.bucket_ids_from_prediction(pred), nb, chunk=128,
                              device=cuda)
    queries = data[:200] + 0.01 * rng.normal(size=(200, 768)).astype(np.float32)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        sd, si, _ = index.search(None, queries, None, queries, pred, n_buckets=3, k=10,
                                 store=store)
        kd, ki = exact_knn(torch.as_tensor(data, device=cuda), queries, k=10)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    x, q = data.astype(np.float64), queries.astype(np.float64)
    for dists, ids in ((sd, si), (kd, ki)):
        exact = 1.0 - np.einsum("qd,qkd->qk", q, x[ids.astype(np.int64) - 1])
        assert np.abs(dists - exact).max() <= 5e-6


def test_builds_and_searches_on_gpu(cuda):
    """A small 2-level build on the GPU: every bucket filled, best-first
    search equal to exact kNN over the visited buckets."""
    from learnedmetricindex_tpu_torch.ops.knn import recall, restricted_knn

    data, _ = _corpus(3000, 32, seed=6)
    cfg = lmi.BuildConfiguration("kmeans", 3, "MLP", 0.01, [4, 3], seed=6, chunk_size=64,
                                 batch_size=128, class_weights="balanced")
    index, pred, nb, _, _ = lmi.LearnedIndexBuilder(torch.as_tensor(data, device=cuda), cfg,
                                                    device=cuda).build()
    assert nb == 12 and (np.bincount(index.bucket_ids_from_prediction(pred), minlength=12) > 0).all()
    store = index.get_bucket_store(data, pred)
    q = torch.as_tensor(data[:200], device=cuda)
    _, ids, _ = index.search(None, q, None, q, pred, n_buckets=3, k=10, store=store,
                             precision="highest")
    order, _ = index.compute_bucket_order(q, 3, keep_on_device=True)
    _, ref = restricted_knn(store, q, order, 10)
    assert recall(ids, ref.cpu().numpy(), 10) >= 0.999


def _shuffled(store, seed):
    """The same store with its chunks at other physical places (each
    bucket's list names them in the old scan order), so lists are out of
    physical order and some later rows of a bucket sit at lower slots."""
    dev = store.device
    perm = torch.as_tensor(np.random.default_rng(seed).permutation(store.n_chunks), device=dev)
    inv = torch.argsort(perm)  # new physical chunk → old
    slots = (inv[:, None] * store.chunk + torch.arange(store.chunk, device=dev)).reshape(-1)
    ptr, clist = store.chunk_list()
    return store._replace(
        chunk_data=store.chunk_data[slots], chunk_ids=store.chunk_ids[inv],
        chunk_scales=None if store.chunk_scales is None else store.chunk_scales[slots],
        row_slot=(perm[store.row_slot.long() // store.chunk] * store.chunk
                  + store.row_slot % store.chunk).int(),
        bucket_chunk_ptr=ptr, bucket_chunk_list=perm.cpu().numpy()[clist].astype(np.int32),
        bucket_fill=store.bucket_fill,
    )


def _mutated_store(dev, d, store_dtype, seed):
    """A 6-bucket store (chunk 96, one bucket empty) after inserts that
    take pool chunks and grow it (40 exact copies of rows 0..39 in their
    own buckets, 700 new rows), 150 deletes of other rows, then its chunks
    shuffled.  Returns (store, 160 queries: the copied rows first, each
    visiting its bucket first, their (160, 3) visits, the copies' ids,
    the copied rows' ids)."""
    data, rng = _corpus(3000, d, seed=seed)
    nb, chunk = 6, 96
    bucket_ids = rng.integers(0, nb, 3000)
    bucket_ids[bucket_ids == 2] = 3
    if store_dtype == "int8":
        store = BucketStore.build_packed_int8(data, bucket_ids, nb, chunk=chunk, device=dev)
    else:
        store = BucketStore.build(data, bucket_ids, nb, chunk=chunk, dtype=store_dtype, device=dev)
    n0 = store.n_chunks
    src = np.arange(40)
    store = mutation.insert_rows(store, data[src], bucket_ids[src], np.arange(3001, 3041))
    more, _ = _corpus(700, d, seed=seed + 1)
    store = mutation.insert_rows(store, more, rng.integers(0, nb, 700), np.arange(3041, 3741))
    store, n_del = mutation.delete_ids(store, rng.choice(np.r_[100:3000, 3041:3741], 150,
                                                         replace=False))
    assert store.n_chunks > n0 and n_del == 150
    store = _shuffled(store, seed)
    queries = torch.as_tensor(np.concatenate([data[src], data[200:320] + 0.05]), device=dev)
    order = np.stack([rng.choice(nb, 3, replace=False) for _ in range(160)])
    for i in src:
        order[i] = [bucket_ids[i]] + [b for b in rng.permutation(nb) if b != bucket_ids[i]][:2]
    order = torch.as_tensor(order, device=dev)
    order[-10:, 2] = -1
    return store, queries, order, np.arange(3001, 3041), src + 1


@pytest.mark.parametrize("mode,store_dtype", [
    ("bf16", "float32"), ("bf16", "bfloat16"), ("bf16", "int8"), ("int8", "int8"),
    ("f32", "float32"), ("f32", "bfloat16"), ("f32", "int8")])
@pytest.mark.parametrize("k,qtile", [(16, 128), (36, 8)])  # list widths 32 and 64
def test_kernel_matches_plain_version_on_mutated_stores(cuda, mode, store_dtype, k, qtile):
    """A store after inserts (pool chunks, growth) and deletes, its chunk
    lists out of physical order: the kernel's candidates equal the plain
    version's (int8 bit-equal), and each exact copy of a row is listed
    after the row itself, the earlier in the bucket's scan order, even
    where the copy sits at the lower slot."""
    store, queries, order, copy_ids, orig_ids = _mutated_store(cuda, 768, store_dtype, seed=k)
    ptr, clist = store.chunk_list()
    assert any((np.diff(clist[a:b]) < 0).any() for a, b in zip(ptr[:-1], ptr[1:]))
    _, args = scan_inputs(store, queries, order, qtile, mode)
    kw = dict(k=k, qtile=qtile, chunk=store.chunk, mode=mode)
    before = scan_kernel.LAUNCHES
    kd, ks = scan_kernel.scan_pairs(*args, **kw)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES == before + 1
    rd, rs = scan_kernel.scan_pairs_reference(*args, **kw)
    kd, ks, rd, rs = (t.cpu().numpy() for t in (kd, ks, rd, rs))
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(rd))
    if mode == "int8":
        np.testing.assert_array_equal(kd.view(np.uint32), rd.view(np.uint32))
        np.testing.assert_array_equal(ks, rs)
    else:
        np.testing.assert_allclose(kd, rd, rtol=1e-4, atol=1e-5)
        mism = ks != rs
        np.testing.assert_allclose(kd[mism], rd[mism], rtol=1e-6, atol=5e-6)
    # partner[later copy] = earlier copy, "earlier" by scan position
    _, position = store.chunk_owner()
    row_slot = store.row_slot.cpu().numpy()
    a, b = row_slot[orig_ids - 1].astype(np.int64), row_slot[copy_ids - 1].astype(np.int64)
    pos = lambda s: position[s // store.chunk] * store.chunk + s % store.chunk  # noqa: E731
    assert (pos(a) < pos(b)).all() and (a > b).any()
    partner = np.full(store.chunk_data.shape[0], -1)
    partner[b] = a
    for slots in (ks, rs):
        lists = slots.reshape(-1, k)
        earlier = np.where(lists >= 0, partner[np.maximum(lists, 0)], -1)
        rows, cols = np.nonzero(earlier >= 0)
        assert len(rows) > 0
        for r, j in zip(rows, cols):
            assert (lists[r, :j] == earlier[r, j]).any(), (r, j)


def _body_case(dev, chunk, seed, d=768, store_dtype="int8"):
    """An int8 (or ``store_dtype``) store of 3000×d rows in 6 buckets (one
    empty) at ``chunk``, 40 rows duplicated later in their own bucket, 150
    queries visiting 3 (the duplicated rows' first), as in
    ``test_kernel_matches_plain_version``."""
    data, rng = _corpus(3000, d, seed=seed)
    nb = 6
    bucket_ids = rng.integers(0, nb, 3000)
    bucket_ids[bucket_ids == 2] = 3
    src, dst = np.arange(0, 40), np.arange(1500, 1540)
    data[dst], bucket_ids[dst] = data[src], bucket_ids[src]
    if store_dtype == "int8":
        store = BucketStore.build_packed_int8(data, bucket_ids, nb, chunk=chunk, device=dev)
    else:
        store = BucketStore.build(data, bucket_ids, nb, chunk=chunk, dtype=store_dtype, device=dev)
    queries = torch.as_tensor(np.concatenate([data[src], data[40:150] + 0.05]), device=dev)
    order = np.stack([rng.choice(nb, 3, replace=False) for _ in range(150)])
    order[:40, 0] = bucket_ids[src]
    order[:40, 1:] = [[b for b in rng.permutation(nb) if b != bucket_ids[i]][:2] for i in src]
    order = torch.as_tensor(order, device=dev)
    order[-10:, 2] = -1
    return store, queries, order


@pytest.mark.parametrize("store_kind", ["chunk96", "chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k", [16, 32])
@pytest.mark.parametrize("qtile", [1, 8, 100, 128])
def test_wgmma_body_matches_plain_version(cuda, store_kind, k, qtile):
    """bf16 over the int8 packed store at list width 32, the launches the
    wgmma body takes: chunks that are not whole 128-row (96, 320) or
    64-row (130) tiles, and a mutated store with its chunk lists out of
    physical order; the kernel within the bf16 bar of the plain version,
    no slot twice, one launch, and that launch the wgmma body."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "int8", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile)
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = scan_kernel.WGMMA_LAUNCHES
    _kernel_vs_plain(args, k, qtile, store.chunk, "bf16", 1)
    assert scan_kernel.WGMMA_LAUNCHES == before + 1


@pytest.mark.parametrize("store_kind", ["chunk96", "chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("qtile", [1, 8, 100, 128])
def test_wgmma_f32_body_matches_plain_version(cuda, store_kind, k, qtile):
    """bf16 over an f32 packed store at list width 32 (the default search
    over ``BuildConfiguration(dtype="float32")``, the CLI's scan), the
    launches the wgmma body over f32 rows takes: chunks that are not whole
    64-row tiles (96, 320, 130), an empty bucket, padding rows, and a
    mutated store with its chunk lists out of physical order; the kernel
    within the bar of the plain version (which rounds both operands to
    bf16 as the kernel does), no slot twice, exact ties to the earlier
    row, one launch, and that launch the body over f32 rows."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "float32", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile,
                                           store_dtype="float32")
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32_LAUNCHES)
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "bf16", 1)
    assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 1)
    if store_kind != "mutated" and k > 1:  # the 40 duplicated rows: the earlier one first
        row_slot = store.row_slot.cpu().numpy()
        partner = np.full(store.chunk_data.shape[0], -1)
        partner[row_slot[1500:1540]] = row_slot[:40]
        lists = ks.reshape(-1, k)
        earlier = np.where(lists >= 0, partner[np.maximum(lists, 0)], -1)
        rows, cols = np.nonzero(earlier >= 0)
        assert len(rows) > 0
        for r, j in zip(rows, cols):
            assert (lists[r, :j] == earlier[r, j]).any(), (r, j)


@pytest.mark.parametrize("d,qtile,body", [(16, 128, 2), (768, 37, 2), (896, 100, 2), (900, 128, 0),
                                          (100, 8, 2), (102, 128, 0), (8, 64, 2)])
def test_wgmma_f32_body_widths(cuda, d, qtile, body):
    """The body over f32 rows from the narrowest d (one partial box) to the
    widest resident query tile (896) and one step past it (900: the
    mma.sync body), rows of 400 bytes (d 100) and 408 (d 102: not whole 16
    bytes, the mma.sync body): within the bar of the plain version, the
    body counted from the library's report of the launch."""
    store, queries, order = _body_case(cuda, 96, seed=d, d=d, store_dtype="float32")
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = scan_kernel.WGMMA_F32_LAUNCHES
    _kernel_vs_plain(args, 16, qtile, store.chunk, "bf16", 1)
    assert scan_kernel.WGMMA_F32_LAUNCHES - before == (body == 2)


@pytest.mark.parametrize("store_kind", ["chunk96", "chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("qtile", [1, 8, 31, 32, 33, 100, 128])
def test_wgmma_f32mode_body_matches_plain_version(cuda, store_kind, k, qtile):
    """f32 queries over the int8 packed store at list width 32
    (``precision="highest"``), the launches the wgmma body in f32 mode
    takes: chunks that are not whole 64-row tiles (96, 320, 130), an empty
    bucket, padding rows, a mutated store with its chunk lists out of
    physical order, and query tiles around its 32-slot blocks (31, 32, 33:
    one or two blocks of one or two m-tiles); the kernel within the f32
    parity bar of the plain version, no slot twice, exact ties to the
    earlier row, one launch, and that launch the f32-mode body."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "int8", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile)
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32MODE_LAUNCHES)
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "f32", 1)
    assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32MODE_LAUNCHES) == (before[0] + 1,
                                                                              before[1] + 1)
    if store_kind != "mutated" and k > 1:  # the 40 duplicated rows: the earlier one first
        row_slot = store.row_slot.cpu().numpy()
        partner = np.full(store.chunk_data.shape[0], -1)
        partner[row_slot[1500:1540]] = row_slot[:40]
        lists = ks.reshape(-1, k)
        earlier = np.where(lists >= 0, partner[np.maximum(lists, 0)], -1)
        rows, cols = np.nonzero(earlier >= 0)
        assert len(rows) > 0
        for r, j in zip(rows, cols):
            assert (lists[r, :j] == earlier[r, j]).any(), (r, j)


@pytest.mark.parametrize("d,qtile,body", [(16, 128, 3), (96, 33, 3), (768, 31, 3), (832, 100, 3),
                                          (896, 128, 3), (912, 128, 0), (100, 8, 0), (1040, 64, 0)])
def test_wgmma_f32mode_body_widths(cuda, d, qtile, body):
    """The f32-mode body from the narrowest d (one partial stage) to the
    widest resident three-term tile (896; 832 rounded up to it) and past
    it (912 and 1040, rounded up to 1024 and 1152: the mma.sync body),
    and int8 rows of 100 bytes (not whole 16 bytes: the mma.sync body):
    within the f32 parity bar of the plain version, the body counted from
    the library's report of the launch."""
    store, queries, order = _body_case(cuda, 96, seed=d, d=d)
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    before = scan_kernel.WGMMA_F32MODE_LAUNCHES
    _kernel_vs_plain(args, 16, qtile, store.chunk, "f32", 1)
    assert scan_kernel.WGMMA_F32MODE_LAUNCHES - before == (body == 3)


@pytest.mark.parametrize("store_kind", ["chunk96", "chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("qtile", [1, 8, 31, 32, 33, 100, 128])
def test_wgmma_f32x_body_matches_plain_version(cuda, store_kind, k, qtile):
    """f32 queries over an f32 packed store at list width 32
    (``precision="highest"`` over ``BuildConfiguration(dtype="float32")``),
    the launches the six-term wgmma body takes: chunks that are not whole
    64-row tiles (96, 320, 130), an empty bucket, padding rows, a mutated
    store with its chunk lists out of physical order, and query tiles
    around its 32-slot blocks; the kernel within the f32 parity bar of the
    plain version, no slot twice, exact ties to the earlier row, one
    launch, and that launch the six-term body."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "float32", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile,
                                           store_dtype="float32")
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32X_LAUNCHES)
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "f32", 1)
    assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32X_LAUNCHES) == (before[0] + 1,
                                                                           before[1] + 1)
    if store_kind != "mutated" and k > 1:  # the 40 duplicated rows: the earlier one first
        row_slot = store.row_slot.cpu().numpy()
        partner = np.full(store.chunk_data.shape[0], -1)
        partner[row_slot[1500:1540]] = row_slot[:40]
        lists = ks.reshape(-1, k)
        earlier = np.where(lists >= 0, partner[np.maximum(lists, 0)], -1)
        rows, cols = np.nonzero(earlier >= 0)
        assert len(rows) > 0
        for r, j in zip(rows, cols):
            assert (lists[r, :j] == earlier[r, j]).any(), (r, j)


@pytest.mark.parametrize("d,qtile,body", [(16, 128, 5), (100, 8, 5), (768, 31, 5), (840, 100, 5),
                                          (896, 128, 5), (900, 128, 0), (102, 33, 0), (7, 8, 0)])
def test_wgmma_f32x_body_widths(cuda, d, qtile, body):
    """The six-term body from the narrowest d (one partial box) to the
    widest resident three-term tile over f32 rows (896; 840 rounded up to
    it) and past it (900, rounded up to 960: the mma.sync body), and f32
    rows that are not whole 16 bytes (d 102 and 7: the mma.sync body):
    within the f32 parity bar of the plain version, the body counted from
    the library's report of the launch."""
    store, queries, order = _body_case(cuda, 96, seed=d, d=d, store_dtype="float32")
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    before = scan_kernel.WGMMA_F32X_LAUNCHES
    _kernel_vs_plain(args, 16, qtile, store.chunk, "f32", 1)
    assert scan_kernel.WGMMA_F32X_LAUNCHES - before == (body == 5)


@pytest.mark.parametrize("case", ["k33", "k106", "virtual", "k1040", "d102", "d900"])
def test_wgmma_f32x_scope_keeps_the_mma_body(cuda, case):
    """f32 over f32 rows outside the six-term body's scope keeps the
    mma.sync body: list widths 64 and 128, a virtual store over an f32
    corpus, k 1040 (a 1024-wide round, then one under floors), rows that
    are not whole 16 bytes (d 102) and a resident tile past the widest (d
    900): within the f32 parity bar of the plain version, no launch on a
    wgmma body."""
    if case == "virtual":
        store, queries, order = _virtual_case(cuda, 768, "float32", seed=7, shuffle=False)
        k, qtile, launches = 16, 128, 1
    elif case == "k1040":
        store, queries, order = _wide_case(cuda, "float32", seed=1041)
        k, qtile, launches = 1040, 8, 2
    else:
        d = int(case[1:]) if case.startswith("d") else 768
        store, queries, order = _body_case(cuda, 96, seed=35, d=d, store_dtype="float32")
        k, qtile, launches = (16 if case.startswith("d") else int(case[1:])), 128, 1
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    before = scan_kernel.WGMMA_LAUNCHES
    _kernel_vs_plain(args, k, qtile, store.chunk, "f32", launches)
    assert scan_kernel.WGMMA_LAUNCHES == before


@pytest.mark.parametrize("k", [16, 32])
def test_f32x_kernel_is_no_less_exact_than_plain(cuda, k):
    """f32 queries over an f32 packed store of unit rows at d 768 (the
    six-term wgmma body, whose x_mid·q_hi and x_lo·q_hi products share the
    truncating fresh sum of x_hi·q_hi for 64 depths): the kernel's
    distances of the candidates it returns are no farther from float64
    than the plain version's (cuBLAS SGEMM in full f32) of its own
    candidates."""
    data, rng = _corpus(6000, 768, seed=25)
    store = BucketStore.build(data, rng.integers(0, 4, 6000), 4, chunk=256, device=cuda)
    queries = torch.as_tensor(data[:400] + 0.05 * rng.normal(size=(400, 768)).astype(np.float32),
                              device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(4, 2, replace=False) for _ in range(400)]),
                            device=cuda)
    _, args = scan_inputs(store, queries, order, 128, "f32")
    kw = dict(k=k, qtile=128, chunk=256, mode="f32")
    rows = args[1].reshape(-1, 128).long()

    def error(dists, slots):
        ok = (slots >= 0) & (rows >= 0)[:, :, None]
        q = args[0][rows.clamp_min(0)].double()
        x = args[5][slots.long().clamp_min(0)].double()
        exact = 1.0 - torch.einsum("pqd,pqkd->pqk", q, x)
        return float((dists.double() - exact).abs()[ok].max())

    before = scan_kernel.WGMMA_F32X_LAUNCHES
    k_err = error(*scan_kernel.scan_pairs(*args, **kw))
    assert scan_kernel.WGMMA_F32X_LAUNCHES == before + 1
    p_err = error(*scan_kernel.scan_pairs_reference(*args, **kw))
    assert 0.0 < k_err <= p_err, (k_err, p_err)


@pytest.mark.parametrize("store_kind", ["chunk96", "chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k", [1, 16, 32])
@pytest.mark.parametrize("qtile", [1, 8, 37, 64, 65, 100, 128])
def test_wgmma_s8_body_matches_plain_version(cuda, store_kind, k, qtile):
    """int8 queries over the int8 packed store at list width 32
    (``precision="int8"``), the launches the wgmma body in int8 mode takes:
    chunks that are not whole 64-row tiles (96, 320, 130), an empty
    bucket, padding rows, a mutated store with its chunk lists out of
    physical order, and query tiles around its 64-slot blocks (one or two
    blocks of one to four m-tiles); the kernel bit-equal to the plain
    version (distances and slots: the integer sums are exact), no slot
    twice, exact ties to the earlier row, one launch, and that launch the
    int8 body."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "int8", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile)
    _, args = scan_inputs(store, queries, order, qtile, "int8")
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_S8_LAUNCHES)
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "int8", 1)
    assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_S8_LAUNCHES) == (before[0] + 1,
                                                                         before[1] + 1)
    if store_kind != "mutated" and k > 1:  # the 40 duplicated rows: the earlier one first
        _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("d,qtile,body", [(16, 128, 6), (96, 37, 6), (768, 64, 6), (1600, 100, 6),
                                          (1664, 128, 6), (1680, 128, 0), (100, 8, 0), (30, 65, 0)])
def test_wgmma_s8_body_widths(cuda, d, qtile, body):
    """The int8 body from the narrowest d (one k-step of real depths) to
    the widest resident int8 query tile (1664; 1600 rounded up to it) and
    past it (1680, rounded up to 1792: the mma.sync body), and int8 rows
    that are not whole 16 bytes (d 100 and 30: the mma.sync body):
    bit-equal to the plain version, the body counted from the library's
    report of the launch."""
    store, queries, order = _body_case(cuda, 96, seed=d, d=d)
    _, args = scan_inputs(store, queries, order, qtile, "int8")
    before = scan_kernel.WGMMA_S8_LAUNCHES
    _kernel_vs_plain(args, 16, qtile, store.chunk, "int8", 1)
    assert scan_kernel.WGMMA_S8_LAUNCHES - before == (body == 6)


@pytest.mark.parametrize("case", ["d100 k64", "d912 k106", "virtual", "k1040"])
def test_wgmma_s8_scope_keeps_the_mma_body(cuda, case):
    """int8 launches outside the int8 bodies' scope keep the mma.sync body:
    int8 rows of 100 bytes at list width 64, d 912 at width 128 (rounded up
    to 1024, past the widest resident tile of the int8 body with wide
    lists, 896), a virtual store over an int8 corpus, and k 1040 (a
    1024-wide round, then one under floors, which keeps the body of the
    round before it): bit-equal to the plain version, no launch on a wgmma
    body.  (The int8 bodies' split is in
    ``test_split_kernel_equals_unsplit_kernel``.)"""
    if case == "virtual":
        store, queries, order = _virtual_case(cuda, 768, "int8", seed=9, shuffle=False)
        k, qtile, launches = 16, 128, 1
    elif case == "k1040":
        store, queries, order = _wide_case(cuda, "int8", seed=1043)
        k, qtile, launches = 1040, 8, 2
    else:
        d, k = (int(w[1:]) for w in case.split())
        store, queries, order = _body_case(cuda, 96, seed=37, d=d)
        qtile, launches = 128, 1
    _, args = scan_inputs(store, queries, order, qtile, "int8")
    before = scan_kernel.WGMMA_LAUNCHES
    _kernel_vs_plain(args, k, qtile, store.chunk, "int8", launches)
    assert scan_kernel.WGMMA_LAUNCHES == before


#: the widest resident query tile of the wgmma body at list widths 64 and
#: 128 (WideList<64>::MAX_QD, WideList<128>::MAX_QD in csrc/scan_pairs.cu)
WIDE_MAX_QD = {64: 1024, 128: 768}
#: ... and of the int8 wgmma body at those widths (S8WideList<64 | 128>::MAX_QD)
S8_WIDE_MAX_QD = {64: 1408, 128: 896}


def _earlier_copy_first(store, ks, k):
    """The 40 rows that ``_body_case`` duplicates later in their own
    bucket: where a list holds the later copy, the earlier one comes
    before it."""
    row_slot = store.row_slot.cpu().numpy()
    partner = np.full(store.chunk_data.shape[0], -1)
    partner[row_slot[1500:1540]] = row_slot[:40]
    lists = ks.reshape(-1, k)
    earlier = np.where(lists >= 0, partner[np.maximum(lists, 0)], -1)
    rows, cols = np.nonzero(earlier >= 0)
    assert len(rows) > 0
    for r, j in zip(rows, cols):
        assert (lists[r, :j] == earlier[r, j]).any(), (r, j)


@pytest.mark.parametrize("k", [33, 64, 65, 106, 128])
@pytest.mark.parametrize("qtile", [1, 37, 64, 128])
@pytest.mark.parametrize("d", [16, 768, "widest"])
def test_wgmma_wide_body_matches_plain_version(cuda, k, qtile, d):
    """bf16 over the int8 packed store at list widths 64 and 128 (k_scan
    33 to 128: ``search(k=100)``), the launches the wide-list wgmma body
    takes: k at both edges of both widths, query tiles of one and of two
    64-slot blocks, d from one k-step to the widest resident query tile of
    the width; chunks of 96 rows (1.5 of its 64-row tiles), an empty
    bucket, padding rows.  The kernel within the bar of the plain version
    (and so within the bf16 bar, ``atol`` 3e-3, of it), no slot twice,
    exact ties to the earlier row, one launch, and that launch the wide
    body."""
    d = WIDE_MAX_QD[scan_kernel.list_width(k)] if d == "widest" else d
    store, queries, order = _body_case(cuda, 96, seed=k + qtile + d, d=d)
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_WIDE_LAUNCHES)
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "bf16", 1)
    assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_WIDE_LAUNCHES) == (before[0] + 1,
                                                                           before[1] + 1)
    _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("store_kind", ["chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k,qtile", [(36, 100), (106, 128), (128, 8)])
def test_wgmma_wide_body_on_other_stores(cuda, store_kind, k, qtile):
    """The wide-list wgmma body over chunks that are not whole 64-row
    tiles (320, 130) and over a mutated store with its chunk lists out of
    physical order: within the bar of the plain version, one launch on the
    wide body."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "int8", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile)
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = scan_kernel.WGMMA_WIDE_LAUNCHES
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "bf16", 1)
    assert scan_kernel.WGMMA_WIDE_LAUNCHES == before + 1
    if store_kind != "mutated":
        _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("k,qtile", [(106, 128), (128, 37), (64, 100)])
def test_wgmma_wide_body_split_through_the_merge(cuda, k, qtile):
    """Segments of one chunk (buckets of up to 7 chunks of 96 rows cut into
    one item a chunk, merged by ``csrc/scan_merge.cu``) give the bits of
    the wide body over whole buckets, and stay within the bar of the plain
    version; each run one scan launch on the wide body and one merge."""
    store, queries, order = _body_case(cuda, 96, seed=k + 1)
    plan, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = scan_kernel.WGMMA_WIDE_LAUNCHES
    whole = _split_kernel(args, plan, store, k, qtile, "bf16", 10**6)
    split = _split_kernel(args, plan, store, k, qtile, "bf16", 1)
    assert scan_kernel.WGMMA_WIDE_LAUNCHES == before + 2
    assert torch.equal(split[0].view(torch.int32), whole[0].view(torch.int32))
    assert torch.equal(split[1], whole[1])
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=96, mode="bf16")
    kd, ks, rd, rs = (t.cpu().numpy() for t in (*split, rd, rs))
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(rd))
    np.testing.assert_allclose(kd, rd, rtol=1e-4, atol=1e-5)
    _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("k", [33, 64, 65, 106, 128])
@pytest.mark.parametrize("qtile", [1, 37, 64, 128])
@pytest.mark.parametrize("d", [16, 768, "widest"])
def test_wgmma_s8_wide_body_matches_plain_version(cuda, k, qtile, d):
    """int8 queries over the int8 packed store at list widths 64 and 128
    (``precision="int8"`` at k_scan 33 to 128: its ``search(k=100)``), the
    launches the int8 wgmma body with wide lists takes: k at both edges of
    both widths, query tiles of one and of two 64-slot blocks, d from one
    k-step to the widest resident int8 query tile of the width (1408, 896);
    chunks of 96 rows (1.5 of its 64-row tiles), an empty bucket, padding
    rows.  The kernel bit-equal to the plain version (distances and slots:
    the integer sums are exact and the epilogue and tie rule are the
    mma.sync body's), no slot twice, exact ties to the earlier row, one
    launch, and that launch the int8 body with wide lists."""
    d = S8_WIDE_MAX_QD[scan_kernel.list_width(k)] if d == "widest" else d
    store, queries, order = _body_case(cuda, 96, seed=k + qtile + d, d=d)
    _, args = scan_inputs(store, queries, order, qtile, "int8")
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_S8_WIDE_LAUNCHES)
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "int8", 1)
    assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_S8_WIDE_LAUNCHES) == (before[0] + 1,
                                                                              before[1] + 1)
    _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("store_kind", ["chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k,qtile", [(36, 100), (106, 128), (128, 8)])
def test_wgmma_s8_wide_body_on_other_stores(cuda, store_kind, k, qtile):
    """The int8 wgmma body with wide lists over chunks that are not whole
    64-row tiles (320, 130) and over a mutated store with its chunk lists
    out of physical order: bit-equal to the plain version, one launch on
    that body."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "int8", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile)
    _, args = scan_inputs(store, queries, order, qtile, "int8")
    before = scan_kernel.WGMMA_S8_WIDE_LAUNCHES
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "int8", 1)
    assert scan_kernel.WGMMA_S8_WIDE_LAUNCHES == before + 1
    if store_kind != "mutated":
        _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("k,qtile", [(106, 128), (128, 37), (64, 100)])
def test_wgmma_s8_wide_body_split_through_the_merge(cuda, k, qtile):
    """Segments of one chunk (buckets of up to 7 chunks of 96 rows cut into
    one item a chunk, merged by ``csrc/scan_merge.cu``) give the bits of
    the int8 body with wide lists over whole buckets, and those are the
    plain version's; each run one scan launch on that body and one
    merge."""
    store, queries, order = _body_case(cuda, 96, seed=k + 2)
    plan, args = scan_inputs(store, queries, order, qtile, "int8")
    before = scan_kernel.WGMMA_S8_WIDE_LAUNCHES
    whole = _split_kernel(args, plan, store, k, qtile, "int8", 10**6)
    split = _split_kernel(args, plan, store, k, qtile, "int8", 1)
    assert scan_kernel.WGMMA_S8_WIDE_LAUNCHES == before + 2
    assert torch.equal(split[0].view(torch.int32), whole[0].view(torch.int32))
    assert torch.equal(split[1], whole[1])
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=96, mode="int8")
    assert torch.equal(split[0].view(torch.int32), rd.view(torch.int32))
    assert torch.equal(split[1], rs)
    _earlier_copy_first(store, split[1].cpu().numpy(), k)


@pytest.mark.parametrize("k", [16, 32])
def test_f32mode_kernel_is_no_less_exact_than_plain(cuda, k):
    """f32 queries over an int8 packed store of unit rows at d 768 (the
    f32-mode wgmma body): the kernel's distances of the candidates it
    returns are no farther from float64 than the plain version's (cuBLAS
    SGEMM in full f32) of its own candidates."""
    data, rng = _corpus(6000, 768, seed=15)
    store = BucketStore.build_packed_int8(data, rng.integers(0, 4, 6000), 4, chunk=256,
                                          device=cuda)
    queries = torch.as_tensor(data[:400] + 0.05 * rng.normal(size=(400, 768)).astype(np.float32),
                              device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(4, 2, replace=False) for _ in range(400)]),
                            device=cuda)
    _, args = scan_inputs(store, queries, order, 128, "f32")
    kw = dict(k=k, qtile=128, chunk=256, mode="f32")
    rows = args[1].reshape(-1, 128).long()

    def error(dists, slots):
        ok = (slots >= 0) & (rows >= 0)[:, :, None]
        q = args[0][rows.clamp_min(0)].double()
        at = slots.long().clamp_min(0)
        x = args[5][at].double()
        exact = 1.0 - torch.einsum("pqd,pqkd->pqk", q, x) * args[6][at].double()
        return float((dists.double() - exact).abs()[ok].max())

    before = scan_kernel.WGMMA_F32MODE_LAUNCHES
    k_err = error(*scan_kernel.scan_pairs(*args, **kw))
    assert scan_kernel.WGMMA_F32MODE_LAUNCHES == before + 1
    p_err = error(*scan_kernel.scan_pairs_reference(*args, **kw))
    assert 0.0 < k_err <= p_err, (k_err, p_err)


#: the widest resident three-term query tile of the f32-mode wgmma body at
#: list widths 64 and 128 (F32ModeWideList<64 | 128>::MAX_QD)
F32MODE_WIDE_MAX_QD = {64: 768, 128: 768}


@pytest.mark.parametrize("k", [33, 64, 106, 128])
@pytest.mark.parametrize("qtile", [1, 37, 128])
@pytest.mark.parametrize("d", [16, 752, "widest"])
def test_wgmma_f32mode_wide_body_matches_plain_version(cuda, k, qtile, d):
    """f32 queries over the int8 packed store at list widths 64 and 128
    (``precision="highest"`` at k_scan 33 to 128: its ``search(k=100)``),
    the launches the f32-mode wgmma body with wide lists takes: k at both
    edges of the widths, query tiles of one and of four 32-slot blocks, d
    from one k-step to the widest resident three-term tile (768 at both
    widths; 752 rounded up to it); chunks of 96 rows (1.5 of its 64-row
    tiles), an empty bucket, padding rows.  The kernel within the f32
    parity bar of the plain version, no slot twice, exact ties to the
    earlier row, one launch, and that launch the f32-mode body with wide
    lists."""
    d = F32MODE_WIDE_MAX_QD[scan_kernel.list_width(k)] if d == "widest" else d
    store, queries, order = _body_case(cuda, 96, seed=k + qtile + d, d=d)
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES)
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "f32", 1)
    assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("store_kind", ["chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k,qtile", [(36, 100), (106, 128), (128, 8)])
def test_wgmma_f32mode_wide_body_on_other_stores(cuda, store_kind, k, qtile):
    """The f32-mode wgmma body with wide lists over chunks that are not
    whole 64-row tiles (320, 130) and over a mutated store with its chunk
    lists out of physical order: within the f32 parity bar of the plain
    version, one launch on that body."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "int8", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile)
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    before = scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "f32", 1)
    assert scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES == before + 1
    if store_kind != "mutated":
        _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("k,qtile", [(106, 128), (128, 37), (64, 100)])
def test_wgmma_f32mode_wide_body_split_through_the_merge(cuda, k, qtile):
    """Segments of one chunk (buckets of up to 7 chunks of 96 rows cut into
    one item a chunk, merged by ``csrc/scan_merge.cu``) give the bits of
    the f32-mode body with wide lists over whole buckets (a row's sum does
    not depend on its segment), within the f32 parity bar of the plain
    version; each run one scan launch on that body and one merge."""
    store, queries, order = _body_case(cuda, 96, seed=k + 3)
    plan, args = scan_inputs(store, queries, order, qtile, "f32")
    before = scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES
    whole = _split_kernel(args, plan, store, k, qtile, "f32", 10**6)
    split = _split_kernel(args, plan, store, k, qtile, "f32", 1)
    assert scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES == before + 2
    assert torch.equal(split[0].view(torch.int32), whole[0].view(torch.int32))
    assert torch.equal(split[1], whole[1])
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=96, mode="f32")
    kd, ks, rd, rs = (t.cpu().numpy() for t in (*split, rd, rs))
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(rd))
    np.testing.assert_allclose(kd, rd, rtol=1e-4, atol=1e-5)
    mism = ks != rs
    np.testing.assert_allclose(kd[mism], rd[mism], rtol=1e-6, atol=5e-6)
    _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("case", ["virtual k64", "d100 k64", "d784 k64", "d896 k106", "k129"])
def test_wgmma_f32mode_wide_scope_keeps_the_mma_body(cuda, case):
    """f32 over int8 rows outside the scope of the f32-mode body with wide
    lists keeps the mma.sync body: a virtual store over an int8 corpus,
    int8 rows of 100 bytes (not whole 16 bytes), d 784 at list width 64 and
    896 at 128 (rounded up to 896, past the widest resident three-term
    tile, 768), and list width 256 (k 129): within the f32 parity bar of
    the plain version, no launch on a wgmma body."""
    words = case.split()
    k = int(words[-1][1:])
    if words[0] == "virtual":
        store, queries, order = _virtual_case(cuda, 768, "int8", seed=11, shuffle=False)
    else:
        d = int(words[0][1:]) if len(words) > 1 else 768
        store, queries, order = _body_case(cuda, 96, seed=39, d=d)
    _, args = scan_inputs(store, queries, order, 128, "f32")
    before = scan_kernel.WGMMA_LAUNCHES
    _kernel_vs_plain(args, k, 128, store.chunk, "f32", 1)
    assert scan_kernel.WGMMA_LAUNCHES == before


@pytest.mark.parametrize("k", [64, 106])
def test_f32mode_wide_kernel_is_no_less_exact_than_plain(cuda, k):
    """f32 queries over an int8 packed store of unit rows at d 768 and list
    widths 64 and 128 (the f32-mode wgmma body with wide lists; 106 is the
    ``highest`` ``search(k=100)``'s k_scan): the kernel's distances of the
    candidates it returns are no farther from float64 than the plain
    version's (cuBLAS SGEMM in full f32) of its own candidates."""
    data, rng = _corpus(6000, 768, seed=17)
    store = BucketStore.build_packed_int8(data, rng.integers(0, 4, 6000), 4, chunk=256,
                                          device=cuda)
    queries = torch.as_tensor(data[:400] + 0.05 * rng.normal(size=(400, 768)).astype(np.float32),
                              device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(4, 2, replace=False) for _ in range(400)]),
                            device=cuda)
    _, args = scan_inputs(store, queries, order, 128, "f32")
    kw = dict(k=k, qtile=128, chunk=256, mode="f32")
    rows = args[1].reshape(-1, 128).long()

    def error(dists, slots):
        ok = (slots >= 0) & (rows >= 0)[:, :, None]
        q = args[0][rows.clamp_min(0)].double()
        at = slots.long().clamp_min(0)
        x = args[5][at].double()
        exact = 1.0 - torch.einsum("pqd,pqkd->pqk", q, x) * args[6][at].double()
        return float((dists.double() - exact).abs()[ok].max())

    before = scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES
    k_err = error(*scan_kernel.scan_pairs(*args, **kw))
    assert scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES == before + 1
    p_err = error(*scan_kernel.scan_pairs_reference(*args, **kw))
    assert 0.0 < k_err <= p_err, (k_err, p_err)


@pytest.mark.parametrize("qtile", [37, 128])
@pytest.mark.parametrize("chunk", [96, 320])
def test_f32mode_wide_lists_begin_with_the_width32_lists(cuda, qtile, chunk):
    """The selection alone: the f32-mode body with wide lists sums each
    (query, row) as the width-32 f32-mode body does, so the first 32
    entries of every list at k_scan 106 (sorted by distance) are the
    width-32 body's list at k_scan 32: the distances bit for bit, the slots
    too except at exact ties (the 40 duplicated rows tie their copies
    exactly)."""
    store, queries, order = _body_case(cuda, chunk, seed=chunk + qtile)
    _, args = scan_inputs(store, queries, order, qtile, "f32")
    kw = dict(qtile=qtile, chunk=chunk, mode="f32")
    before = (scan_kernel.WGMMA_F32MODE_LAUNCHES, scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES)
    wd, ws = scan_kernel.scan_pairs(*args, k=106, **kw)
    nd, ns = scan_kernel.scan_pairs(*args, k=32, **kw)
    torch.cuda.synchronize()
    assert (scan_kernel.WGMMA_F32MODE_LAUNCHES, scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    wd, ws, nd, ns = (t.cpu().numpy().reshape(-1, t.shape[-1]) for t in (wd, ws, nd, ns))
    o = np.argsort(wd, axis=1, kind="stable")
    wd, ws = np.take_along_axis(wd, o, 1), np.take_along_axis(ws, o, 1)
    o = np.argsort(nd, axis=1, kind="stable")
    nd, ns = np.take_along_axis(nd, o, 1), np.take_along_axis(ns, o, 1)
    assert np.isfinite(nd).sum() > 0
    np.testing.assert_array_equal(wd[:, :32].view(np.uint32), nd.view(np.uint32))
    # a slot may differ only where its distance ties another entry of the list
    tied = np.zeros(nd.shape, bool)
    tied[:, 1:] |= nd[:, 1:] == nd[:, :-1]
    tied[:, :-1] |= nd[:, :-1] == nd[:, 1:]
    tied[:, -1] |= wd[:, 32] == wd[:, 31]
    mism = ws[:, :32] != ns
    assert not (mism & ~tied).any()
    assert tied[np.isfinite(nd)].any()


#: the widest resident query tile of the wgmma body over f32 rows at list
#: widths 64 and 128 (F32WideList<64 | 128>::MAX_QD)
F32_WIDE_MAX_QD = {64: 768, 128: 768}


@pytest.mark.parametrize("k", [33, 64, 106, 128])
@pytest.mark.parametrize("qtile", [1, 8, 37, 128])
@pytest.mark.parametrize("d", [16, 100, "widest"])
def test_wgmma_f32_wide_body_matches_plain_version(cuda, k, qtile, d):
    """bf16 over an f32 packed store at list widths 64 and 128 (the default
    ``search(k=100)`` over ``BuildConfiguration(dtype="float32")`` scans at
    106), the launches the wgmma body over f32 rows with wide lists takes:
    k at both edges of the widths, query tiles of one to two 64-slot
    blocks, d from one partial box to the widest resident tile (768 at
    both widths; rows of 400 bytes at d 100); chunks of 96 rows (1.5 of
    its 64-row tiles), an empty bucket, padding rows.  The kernel within
    the bar of the plain version (which rounds both operands to bf16 as
    the kernel does; so within the bf16 bar, ``atol`` 3e-3), no slot
    twice, exact ties to the earlier row, one launch, and that launch the
    body over f32 rows with wide lists."""
    d = F32_WIDE_MAX_QD[scan_kernel.list_width(k)] if d == "widest" else d
    store, queries, order = _body_case(cuda, 96, seed=k + qtile + d, d=d, store_dtype="float32")
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32_WIDE_LAUNCHES)
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "bf16", 1)
    assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32_WIDE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("store_kind", ["chunk320", "chunk130", "mutated"])
@pytest.mark.parametrize("k,qtile", [(36, 100), (106, 128), (128, 8)])
def test_wgmma_f32_wide_body_on_other_stores(cuda, store_kind, k, qtile):
    """The wgmma body over f32 rows with wide lists over chunks that are
    not whole 64-row tiles (320, 130) and over a mutated f32 store with
    its chunk lists out of physical order: within the bar of the plain
    version, one launch on that body."""
    if store_kind == "mutated":
        store, queries, order, _, _ = _mutated_store(cuda, 768, "float32", seed=k + qtile)
    else:
        store, queries, order = _body_case(cuda, int(store_kind[5:]), seed=k + qtile,
                                           store_dtype="float32")
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = scan_kernel.WGMMA_F32_WIDE_LAUNCHES
    ks = _kernel_vs_plain(args, k, qtile, store.chunk, "bf16", 1)
    assert scan_kernel.WGMMA_F32_WIDE_LAUNCHES == before + 1
    if store_kind != "mutated":
        _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("k,qtile", [(106, 128), (128, 37), (64, 100)])
def test_wgmma_f32_wide_body_split_through_the_merge(cuda, k, qtile):
    """Segments of one chunk (buckets of up to 7 chunks of 96 rows cut into
    one item a chunk, merged by ``csrc/scan_merge.cu``) give the bits of
    the body over f32 rows with wide lists over whole buckets (a row's sum
    does not depend on its segment), within the bar of the plain version;
    each run one scan launch on that body and one merge."""
    store, queries, order = _body_case(cuda, 96, seed=k + 5, store_dtype="float32")
    plan, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = scan_kernel.WGMMA_F32_WIDE_LAUNCHES
    whole = _split_kernel(args, plan, store, k, qtile, "bf16", 10**6)
    split = _split_kernel(args, plan, store, k, qtile, "bf16", 1)
    assert scan_kernel.WGMMA_F32_WIDE_LAUNCHES == before + 2
    assert torch.equal(split[0].view(torch.int32), whole[0].view(torch.int32))
    assert torch.equal(split[1], whole[1])
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=96, mode="bf16")
    kd, ks, rd, rs = (t.cpu().numpy() for t in (*split, rd, rs))
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(rd))
    np.testing.assert_allclose(kd, rd, rtol=1e-4, atol=1e-5)
    mism = ks != rs
    np.testing.assert_allclose(kd[mism], rd[mism], rtol=1e-6, atol=5e-6)
    _earlier_copy_first(store, ks, k)


@pytest.mark.parametrize("case", ["f32 k64", "f32 k106", "virtual k106", "floored k106",
                                  "d772 k106", "d800 k106", "d800 k64", "d102 k64"])
def test_wgmma_f32_wide_scope_keeps_the_mma_body(cuda, case):
    """Launches over f32 rows at list widths 64 and 128 outside the scope
    of the wgmma body over f32 rows with wide lists keep the mma.sync
    body: f32 queries (the six-term mma.sync body), a virtual store over an
    f32 corpus, a round under a floor (one that admits every row), d 772
    and 800 (rounded up to 832, past the widest resident tile, 768) and
    rows of 408 bytes (d 102, not whole 16 bytes): within the bar of the
    plain version, no launch on a wgmma body."""
    words = case.split()
    k = int(words[-1][1:])
    mode = "f32" if words[0] == "f32" else "bf16"
    if words[0] == "virtual":
        store, queries, order = _virtual_case(cuda, 768, "float32", seed=13, shuffle=False)
    else:
        d = int(words[0][1:]) if words[0].startswith("d") else 768
        store, queries, order = _body_case(cuda, 96, seed=41, d=d, store_dtype="float32")
    plan, args = scan_inputs(store, queries, order, 128, mode)
    before = scan_kernel.WGMMA_LAUNCHES
    if words[0] != "floored":
        _kernel_vs_plain(args, k, 128, store.chunk, mode, 1)
        assert scan_kernel.WGMMA_LAUNCHES == before
        return
    # (distance −inf, position −1): every row is above the floor
    floor = (torch.full(plan.qidx.shape, -torch.inf, device=cuda),
             torch.full(plan.qidx.shape, -1, dtype=torch.int32, device=cuda))
    launch = scan_kernel._kernel_round(args[0], *args[3:7], args[7], args[8], qtile=128,
                                       chunk=store.chunk, mode=mode)
    runs = scan_kernel.LAUNCHES
    kd, ks = launch(plan.qidx, plan.pair_bucket, k, floor)
    torch.cuda.synchronize()
    assert (scan_kernel.LAUNCHES - runs, scan_kernel.WGMMA_LAUNCHES) == (1, before)
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=128, chunk=store.chunk,
                                              mode=mode)
    kd, ks, rd, rs = (t.cpu().numpy() for t in (kd, ks, rd, rs))
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(rd))
    np.testing.assert_allclose(kd, rd, rtol=1e-4, atol=1e-5)
    mism = ks != rs
    np.testing.assert_allclose(kd[mism], rd[mism], rtol=1e-6, atol=5e-6)


@pytest.mark.parametrize("qtile", [37, 128])
@pytest.mark.parametrize("chunk", [96, 320])
def test_f32_wide_lists_begin_with_the_width32_lists(cuda, qtile, chunk):
    """The selection alone: the wgmma body over f32 rows with wide lists
    sums each (query, row) as the width-32 body over f32 rows does (the
    same k-steps into one sum in the same order, in one-box stages at list
    width 128), so the first 32 entries of every list at k_scan 106
    (sorted by distance) are the width-32 body's list at k_scan 32: the
    distances bit for bit, the slots too except at exact ties (the 40
    duplicated rows tie their copies exactly)."""
    store, queries, order = _body_case(cuda, chunk, seed=chunk + qtile + 1,
                                       store_dtype="float32")
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    kw = dict(qtile=qtile, chunk=chunk, mode="bf16")
    before = (scan_kernel.WGMMA_F32_LAUNCHES, scan_kernel.WGMMA_F32_WIDE_LAUNCHES)
    wd, ws = scan_kernel.scan_pairs(*args, k=106, **kw)
    nd, ns = scan_kernel.scan_pairs(*args, k=32, **kw)
    torch.cuda.synchronize()
    assert (scan_kernel.WGMMA_F32_LAUNCHES, scan_kernel.WGMMA_F32_WIDE_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    wd, ws, nd, ns = (t.cpu().numpy().reshape(-1, t.shape[-1]) for t in (wd, ws, nd, ns))
    o = np.argsort(wd, axis=1, kind="stable")
    wd, ws = np.take_along_axis(wd, o, 1), np.take_along_axis(ws, o, 1)
    o = np.argsort(nd, axis=1, kind="stable")
    nd, ns = np.take_along_axis(nd, o, 1), np.take_along_axis(ns, o, 1)
    assert np.isfinite(nd).sum() > 0
    np.testing.assert_array_equal(wd[:, :32].view(np.uint32), nd.view(np.uint32))
    # a slot may differ only where its distance ties another entry of the list
    tied = np.zeros(nd.shape, bool)
    tied[:, 1:] |= nd[:, 1:] == nd[:, :-1]
    tied[:, :-1] |= nd[:, :-1] == nd[:, 1:]
    tied[:, -1] |= wd[:, 32] == wd[:, 31]
    mism = ws[:, :32] != ns
    assert not (mism & ~tied).any()
    assert tied[np.isfinite(nd)].any()


@pytest.mark.parametrize("case", ["k33", "k106", "virtual", "k1040"])
def test_wgmma_f32_scope_keeps_the_mma_body(cuda, case):
    """bf16 over f32 rows outside the wgmma bodies' scope keeps the mma.sync
    body: list widths 64 and 128 past the widest resident tile of the body
    over f32 rows with wide lists (d 800 at k 33, 772 at k 106: rounded up
    to 832, past 768), a virtual store over an f32 corpus, and k 1040 (a
    1024-wide round, then one under floors): within the bar of the plain
    version, no launch on a wgmma body."""
    if case == "virtual":
        store, queries, order = _virtual_case(cuda, 768, "float32", seed=5, shuffle=False)
        k, qtile, launches = 16, 128, 1
    elif case == "k1040":
        store, queries, order = _wide_case(cuda, "float32", seed=1040)
        k, qtile, launches = 1040, 8, 2
    else:
        k, qtile, launches = int(case[1:]), 128, 1
        store, queries, order = _body_case(cuda, 96, seed=33, d={33: 800, 106: 772}[k],
                                           store_dtype="float32")
    _, args = scan_inputs(store, queries, order, qtile, "bf16")
    before = scan_kernel.WGMMA_LAUNCHES
    _kernel_vs_plain(args, k, qtile, store.chunk, "bf16", launches)
    assert scan_kernel.WGMMA_LAUNCHES == before


@pytest.mark.parametrize(
    "mode,store_dtype,k,d,virtual,aligned,expect",
    [
        ("bf16", torch.int8, 16, 768, False, True, 1),  # the default search
        ("bf16", torch.int8, 32, 768, False, True, 1),
        ("bf16", torch.int8, 1, 96, False, True, 1),
        ("bf16", torch.int8, 16, 784, False, True, 1),
        ("bf16", torch.int8, 16, 1024, False, True, 1),
        ("bf16", torch.int8, 16, 1040, False, True, 1),  # rounded up to 1152 ...
        ("bf16", torch.int8, 16, 1152, False, True, 1),  # ... the widest resident tile
        ("bf16", torch.int8, 16, 1168, False, True, 0),  # rounded up to 1280: too wide
        ("bf16", torch.int8, 33, 768, False, True, 4),  # list width 64: the wide body
        ("bf16", torch.int8, 64, 768, False, True, 4),
        ("bf16", torch.int8, 65, 768, False, True, 4),  # list width 128
        ("bf16", torch.int8, 106, 768, False, True, 4),  # search(k=100)
        ("bf16", torch.int8, 128, 768, False, True, 4),
        ("bf16", torch.int8, 129, 768, False, True, 0),  # list width 256
        ("bf16", torch.int8, 64, 1024, False, True, 4),  # the widest tile at width 64
        ("bf16", torch.int8, 64, 1040, False, True, 0),
        ("bf16", torch.int8, 106, 16, False, True, 4),
        ("bf16", torch.int8, 106, 752, False, True, 4),  # rounded up to 768 ...
        ("bf16", torch.int8, 106, 784, False, True, 0),  # ... the widest at width 128
        ("bf16", torch.int8, 106, 768, True, True, 0),  # a virtual store
        ("bf16", torch.int8, 106, 100, False, True, 0),  # rows not of whole 16 bytes
        ("bf16", torch.int8, 106, 768, False, False, 0),  # an unaligned store
        ("bf16", torch.bfloat16, 106, 768, False, True, 0),
        ("bf16", torch.float32, 106, 768, False, True, 9),  # the f32 store's search(k=100)
        ("int8", torch.int8, 106, 768, False, True, 7),  # the int8 search(k=100)
        ("int8", torch.int8, 33, 768, False, True, 7),  # list width 64: the int8 wide body
        ("bf16", torch.int8, 16, 768, True, True, 10),  # a virtual store: its row map
        ("bf16", torch.int8, 32, 96, True, True, 10),
        ("bf16", torch.int8, 16, 896, True, True, 10),  # the row map's widest tile ...
        ("bf16", torch.int8, 16, 912, True, True, 0),  # ... and one step past it
        ("bf16", torch.int8, 16, 100, True, True, 0),  # rows not of whole 16 bytes
        ("bf16", torch.int8, 33, 768, True, True, 0),  # a row map at list width 64
        ("bf16", torch.int8, 16, 768, True, False, 0),  # an unaligned corpus
        ("bf16", torch.bfloat16, 16, 768, True, True, 0),  # a row map over a bf16 corpus
        ("int8", torch.int8, 16, 768, True, True, 0),  # int8 queries over a row map
        ("bf16", torch.int8, 16, 100, False, True, 0),  # rows not of whole 16 bytes
        ("bf16", torch.int8, 16, 30, False, True, 0),
        ("bf16", torch.int8, 16, 768, False, False, 0),  # an unaligned store
        ("bf16", torch.bfloat16, 16, 768, False, True, 0),
        ("bf16", torch.float32, 16, 768, False, True, 2),  # the CLI's store
        ("bf16", torch.float32, 32, 768, False, True, 2),
        ("bf16", torch.float32, 1, 16, False, True, 2),
        ("bf16", torch.float32, 16, 100, False, True, 2),  # rows of 400 bytes
        ("bf16", torch.float32, 16, 840, False, True, 2),  # rounded up to 896 ...
        ("bf16", torch.float32, 16, 896, False, True, 2),  # ... the widest resident tile
        ("bf16", torch.float32, 16, 900, False, True, 0),  # rounded up to 960: too wide
        ("bf16", torch.float32, 16, 102, False, True, 0),  # rows not of whole 16 bytes
        ("bf16", torch.float32, 33, 768, False, True, 9),  # list width 64: the wide body
        ("bf16", torch.float32, 64, 768, False, True, 9),  # over f32 rows
        ("bf16", torch.float32, 65, 768, False, True, 9),  # list width 128
        ("bf16", torch.float32, 128, 768, False, True, 9),
        ("bf16", torch.float32, 129, 768, False, True, 0),  # list width 256
        ("bf16", torch.float32, 106, 16, False, True, 9),
        ("bf16", torch.float32, 106, 100, False, True, 9),  # rows of 400 bytes
        ("bf16", torch.float32, 64, 740, False, True, 9),  # rounded up to 768, the widest ...
        ("bf16", torch.float32, 64, 800, False, True, 0),  # ... at width 64
        ("bf16", torch.float32, 106, 752, False, True, 9),  # and at width 128
        ("bf16", torch.float32, 106, 772, False, True, 0),
        ("bf16", torch.float32, 106, 102, False, True, 0),  # rows not of whole 16 bytes
        ("bf16", torch.float32, 106, 768, True, True, 0),  # a virtual store
        ("bf16", torch.float32, 106, 768, False, False, 0),  # an unaligned store
        ("bf16", torch.float32, 16, 768, True, True, 0),  # a virtual store
        ("bf16", torch.float32, 16, 768, False, False, 0),  # an unaligned store
        ("int8", torch.int8, 16, 768, False, True, 6),  # precision="int8"
        ("int8", torch.int8, 32, 768, False, True, 6),
        ("int8", torch.int8, 1, 96, False, True, 6),
        ("int8", torch.int8, 16, 16, False, True, 6),
        ("int8", torch.int8, 16, 1600, False, True, 6),  # rounded up to 1664 ...
        ("int8", torch.int8, 16, 1664, False, True, 6),  # ... the widest int8 tile
        ("int8", torch.int8, 16, 1680, False, True, 0),  # rounded up to 1792: too wide
        ("int8", torch.int8, 16, 100, False, True, 0),  # rows not of whole 16 bytes
        ("int8", torch.int8, 16, 768, True, True, 0),  # a virtual store
        ("int8", torch.int8, 16, 768, False, False, 0),  # an unaligned store
        ("int8", torch.int8, 64, 768, False, True, 7),
        ("int8", torch.int8, 65, 768, False, True, 7),  # list width 128
        ("int8", torch.int8, 128, 768, False, True, 7),
        ("int8", torch.int8, 129, 768, False, True, 0),  # list width 256
        ("int8", torch.int8, 106, 16, False, True, 7),
        ("int8", torch.int8, 64, 1408, False, True, 7),  # the widest int8 tile at width 64
        ("int8", torch.int8, 64, 1424, False, True, 0),  # rounded up to 1536: too wide
        ("int8", torch.int8, 106, 880, False, True, 7),  # rounded up to 896 ...
        ("int8", torch.int8, 106, 896, False, True, 7),  # ... the widest at width 128
        ("int8", torch.int8, 106, 912, False, True, 0),
        ("int8", torch.int8, 106, 100, False, True, 0),  # rows not of whole 16 bytes
        ("int8", torch.int8, 106, 768, True, True, 0),  # a virtual store
        ("int8", torch.int8, 106, 768, False, False, 0),  # an unaligned store
        ("f32", torch.int8, 16, 768, False, True, 3),  # precision="highest"
        ("f32", torch.int8, 32, 768, False, True, 3),
        ("f32", torch.int8, 1, 96, False, True, 3),
        ("f32", torch.int8, 16, 16, False, True, 3),
        ("f32", torch.int8, 16, 832, False, True, 3),  # rounded up to 896 ...
        ("f32", torch.int8, 16, 896, False, True, 3),  # ... the widest three-term tile
        ("f32", torch.int8, 16, 912, False, True, 0),  # rounded up to 1024: too wide
        ("f32", torch.int8, 16, 1152, False, True, 0),
        ("f32", torch.int8, 16, 904, False, True, 0),  # rows not of whole 16 bytes
        ("f32", torch.int8, 16, 100, False, True, 0),
        ("f32", torch.int8, 33, 768, False, True, 8),  # list width 64: the f32-mode wide body
        ("f32", torch.int8, 106, 768, False, True, 8),  # the highest search(k=100)
        ("f32", torch.int8, 64, 768, False, True, 8),
        ("f32", torch.int8, 65, 768, False, True, 8),  # list width 128
        ("f32", torch.int8, 128, 768, False, True, 8),
        ("f32", torch.int8, 129, 768, False, True, 0),  # list width 256
        ("f32", torch.int8, 106, 16, False, True, 8),
        ("f32", torch.int8, 64, 752, False, True, 8),  # rounded up to 768, the widest ...
        ("f32", torch.int8, 64, 784, False, True, 0),  # ... at width 64; 896 is too wide
        ("f32", torch.int8, 106, 752, False, True, 8),
        ("f32", torch.int8, 106, 784, False, True, 0),  # and at width 128
        ("f32", torch.int8, 106, 100, False, True, 0),  # rows not of whole 16 bytes
        ("f32", torch.int8, 106, 768, True, True, 0),  # a virtual store
        ("f32", torch.int8, 106, 768, False, False, 0),  # an unaligned store
        ("f32", torch.int8, 16, 768, True, True, 11),  # a virtual store: its row map
        ("f32", torch.int8, 32, 96, True, True, 11),
        ("f32", torch.int8, 16, 752, True, True, 11),  # rounded up to the widest tile ...
        ("f32", torch.int8, 16, 784, True, True, 0),  # ... and one step past it
        ("f32", torch.int8, 16, 100, True, True, 0),  # rows not of whole 16 bytes
        ("f32", torch.int8, 33, 768, True, True, 0),  # a row map at list width 64
        ("f32", torch.bfloat16, 16, 768, True, True, 0),  # a row map over a bf16 corpus
        ("f32", torch.int8, 16, 768, False, False, 0),  # an unaligned store
        ("f32", torch.bfloat16, 16, 768, False, True, 0),
        ("f32", torch.float32, 16, 768, False, True, 5),  # highest over the default store
        ("f32", torch.float32, 32, 768, False, True, 5),
        ("f32", torch.float32, 1, 16, False, True, 5),
        ("f32", torch.float32, 16, 100, False, True, 5),  # rows of 400 bytes
        ("f32", torch.float32, 16, 840, False, True, 5),  # rounded up to 896 ...
        ("f32", torch.float32, 16, 896, False, True, 5),  # ... the widest six-term tile
        ("f32", torch.float32, 16, 900, False, True, 0),  # rounded up to 960: too wide
        ("f32", torch.float32, 16, 102, False, True, 0),  # rows not of whole 16 bytes
        ("f32", torch.float32, 33, 768, False, True, 0),  # list width 64
        ("f32", torch.float32, 106, 768, False, True, 0),
        ("f32", torch.float32, 16, 768, True, True, 0),  # a virtual store
        ("f32", torch.float32, 16, 768, False, False, 0),  # an unaligned store
    ],
)
def test_library_picks_the_body(cuda, mode, store_dtype, k, d, virtual, aligned, expect):
    """Which launches take a wgmma body, as the library says (``scan_body``,
    the one place that decides): bf16 over an int8 packed store (body 1) or
    an f32 packed store (body 2), f32 over an int8 packed store (body 3) or
    an f32 packed store (body 5), int8 over an int8 packed store (body 6),
    k <= 32 and no floor, whole 16-byte rows at an aligned store, d rounded
    up to 128 (int8) or 64 (f32) within the resident tile (896 for the three
    terms over either store, 1664 for int8 queries), and bf16 over an int8
    packed store at k 33 to 128 on the same terms (body 4, the tile within
    1024 at list width 64 and 768 at 128), and so int8 queries (body 7, the
    tile within 1408 at list width 64 and 896 at 128) and f32 queries (body
    8, the tile within 768 at both widths), and bf16 over an f32 packed
    store at k 33 to 128 (body 9, the tile within 768 at both widths, d % 4
    == 0), and bf16 and f32 over a virtual store (the row map) of an int8
    corpus at k <= 32 (bodies 10 and 11, the tile within 896 and 768; d %
    16 == 0, an aligned corpus); everything else keeps the
    mma.sync body (0), and so does every round under a floor.  With the
    body come the width of the query rows it reads and its blocks' query
    slots (32 for the three terms)."""
    lib = cuda_build.load(scan_kernel.SOURCE, scan_kernel._bind)
    flat = torch.zeros(64 * d + 16, dtype=store_dtype, device=cuda)
    store = flat[(0 if aligned else 1):][: 64 * d].view(64, d)
    assert (store.data_ptr() % 16 == 0) is aligned
    row_ids = torch.arange(1, 65, dtype=torch.int32, device=cuda) if virtual else None
    body = scan_kernel.scan_body(lib, store, mode, k, row_ids)
    assert body.kind == expect and body.wgmma is (expect > 0)
    assert body.slots >= torch.cuda.get_device_properties(cuda).multi_processor_count
    if expect:
        step = 64 if expect in (2, 5, 9) else 128
        assert (body.qd, body.block_queries) == (-(-d // step) * step,
                                                 32 if expect in (3, 5, 8, 11) else 64)
    else:
        group = 32 if mode == "f32" else 16
        width = scan_kernel.list_width(k)
        assert (body.qd, body.block_queries) == (-(-d // group) * group,
                                                 scan_kernel.queries_per_block(width))
    assert not scan_kernel.scan_body(lib, store, mode, k, row_ids, floored=True).wgmma


@pytest.mark.parametrize("case", ["virtual", "d100", "d96", "k33", "k106", "k129", "k1040",
                                  "d1040", "d1152", "f32 virtual", "f32 d100", "f32 d96",
                                  "f32 k33", "f32 k106", "f32 k1040", "f32 d896", "f32 d912"])
def test_wgmma_scope_picks_the_body(cuda, case):
    """The launches outside the wgmma bodies' scope keep the mma.sync body
    (rows of 100 bytes, f32 at lists of width 64 and 128,
    bf16 at width 256, and k 1040: a 1024-wide round, then a 16-wide one
    under its floors, which keeps the body of the round before it, so that
    both sum a row the same way); bf16 at d 96, 1040 and 1152 (the widest
    resident query tile) and at k 33 and 106 (the wide-list body), and f32
    (the three-term body) at d 96 and 896 (its widest; 912 is past it) and
    at k 33 and 106 (the f32-mode body with wide lists) take a wgmma body,
    and so do both over a virtual store of an int8 corpus (the row-map
    bodies).
    Each within the bar of the plain version, the body counted from the
    library's report of each launch."""
    mode, _, case = case.rpartition(" ")
    mode = mode or "bf16"
    k = {"k33": 33, "k106": 106, "k129": 129, "k1040": 1040}.get(case, 16)
    before = (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32MODE_LAUNCHES,
              scan_kernel.WGMMA_WIDE_LAUNCHES, scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES,
              scan_kernel.WGMMA_INT8_ROWMAP_LAUNCHES, scan_kernel.WGMMA_F32MODE_ROWMAP_LAUNCHES)
    if case == "k1040":  # buckets of ~3,000 rows, wider than one round
        store, queries, order = _wide_case(cuda, "int8", seed=1040)
        _, args = scan_inputs(store, queries, order, 8, mode)
        _kernel_vs_plain(args, k, 8, 256, mode, 2)
        assert (scan_kernel.WGMMA_LAUNCHES, scan_kernel.WGMMA_F32MODE_LAUNCHES,
                scan_kernel.WGMMA_WIDE_LAUNCHES, scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES,
                scan_kernel.WGMMA_INT8_ROWMAP_LAUNCHES,
                scan_kernel.WGMMA_F32MODE_ROWMAP_LAUNCHES) == before
        return
    if case == "virtual":
        store, queries, order = _virtual_case(cuda, 768, "int8", seed=3, shuffle=False)
        chunk = 96
    else:
        d = int(case[1:]) if case.startswith("d") else 768
        data, rng = _corpus(2000, d, seed=4)
        store = BucketStore.build_packed_int8(data, rng.integers(0, 5, 2000), 5, chunk=96,
                                              device=cuda)
        queries = torch.as_tensor(data[:90] + 0.05, device=cuda)
        order = torch.as_tensor(np.stack([rng.choice(5, 2, replace=False) for _ in range(90)]),
                                device=cuda)
        chunk = 96
    _, args = scan_inputs(store, queries, order, 128, mode)
    _kernel_vs_plain(args, k, 128, chunk, mode, 1)
    takes = {"bf16": ("virtual", "d96", "d1040", "d1152", "k33", "k106"),
             "f32": ("virtual", "d96", "d896", "k33", "k106")}[mode]
    n_w = scan_kernel.WGMMA_LAUNCHES - before[0]
    assert n_w == (1 if case in takes else 0)
    row_map = n_w if case == "virtual" else 0
    assert (scan_kernel.WGMMA_INT8_ROWMAP_LAUNCHES - before[4],
            scan_kernel.WGMMA_F32MODE_ROWMAP_LAUNCHES - before[5]) == (
        (0, row_map) if mode == "f32" else (row_map, 0))
    assert scan_kernel.WGMMA_F32MODE_LAUNCHES - before[1] == (
        n_w - row_map if mode == "f32" and k <= 32 else 0)
    assert scan_kernel.WGMMA_WIDE_LAUNCHES - before[2] == (n_w if mode == "bf16" and k > 32
                                                           else 0)
    assert scan_kernel.WGMMA_F32MODE_WIDE_LAUNCHES - before[3] == (n_w if mode == "f32" and k > 32
                                                                   else 0)


@pytest.mark.parametrize("d,laid_out,store_dtype,mode,k", [
    (768, 0, "int8", "bf16", 16), (100, 1, "int8", "bf16", 16), (768, 0, "float32", "bf16", 16),
    (768, 1, "float32", "bf16", 16), (102, 2, "float32", "bf16", 16), (768, 3, "int8", "bf16", 16),
    (768, 0, "int8", "f32", 16), (768, 1, "int8", "f32", 16), (100, 3, "int8", "f32", 16),
    (912, 3, "int8", "f32", 16), (768, 0, "int8", "bf16", 106), (768, 1, "int8", "bf16", 106),
    (768, 4, "int8", "bf16", 16), (784, 4, "int8", "bf16", 106), (768, 4, "int8", "f32", 106),
    (768, 0, "float32", "f32", 16), (768, 3, "float32", "f32", 16), (768, 2, "float32", "f32", 16),
    (768, 5, "float32", "f32", 33), (102, 5, "float32", "f32", 16), (768, 5, "float32", "bf16", 16),
    (768, 5, "int8", "f32", 16), (768, 0, "int8", "int8", 16), (768, 6, "int8", "int8", 33),
    (100, 6, "int8", "int8", 16), (768, 1, "int8", "int8", 16), (768, 6, "int8", "bf16", 16),
    (768, 6, "int8", "f32", 16), (768, 7, "int8", "int8", 16), (768, 0, "int8", "int8", 106),
    (768, 4, "int8", "int8", 106), (912, 7, "int8", "int8", 106), (768, 7, "int8", "bf16", 106),
    (768, 8, "int8", "f32", 16), (768, 3, "int8", "f32", 106), (768, 0, "int8", "f32", 106),
    (784, 8, "int8", "f32", 106), (768, 8, "int8", "bf16", 106), (768, 8, "int8", "int8", 64),
    (768, 2, "float32", "bf16", 106), (768, 0, "float32", "bf16", 106),
    (768, 9, "float32", "bf16", 16), (800, 9, "float32", "bf16", 106),
    (768, 9, "float32", "f32", 106), (768, 4, "float32", "bf16", 106)])
def test_launch_rejects_queries_laid_out_for_the_other_body(cuda, d, laid_out, store_dtype, mode,
                                                            k):
    """Every launch is held to the body the library picks: queries laid
    out for another body (the mma.sync layout where a wgmma body runs, a
    wgmma layout where the mma.sync body or another wgmma body runs, in
    bf16 and in f32 mode, over int8 and f32 rows, at list width 32 and 128:
    the width-32 and the wide-list bodies over int8 rows read one layout,
    and are still held apart, as are the two int8 bodies, the two
    f32-mode bodies over int8 rows and the two bf16 bodies over f32 rows,
    which read one layout too; int8
    queries laid out for an int8 body where the mma.sync body or a bf16 or
    f32 body runs, and the other way round) launch nothing, raise, and
    count no launch."""
    data, rng = _corpus(2000, d, seed=6)
    if store_dtype == "int8":
        store = BucketStore.build_packed_int8(data, rng.integers(0, 5, 2000), 5, chunk=96,
                                              device=cuda)
    else:
        store = BucketStore.build(data, rng.integers(0, 5, 2000), 5, chunk=96, dtype=store_dtype,
                                  device=cuda)
    queries = torch.as_tensor(data[:90] + 0.05, device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(5, 2, replace=False) for _ in range(90)]),
                            device=cuda)
    _, (q, qidx, pb, ptr, chunk_of, st, sc, qs, row_ids) = scan_inputs(store, queries, order, 128,
                                                                       mode)
    lib = cuda_build.load(scan_kernel.SOURCE, scan_kernel._bind)
    assert scan_kernel.scan_body(lib, st, mode, k).kind != laid_out
    # the layout of the body laid_out names (bodies 1, 3, 4, 6, 7 and 8: over
    # an int8 store's order, d rounded up to 128; 2, 5 and 9: over an f32
    # store's, to 64)
    layout_dtype = (torch.int8 if laid_out in (1, 3, 4, 6, 7, 8) else torch.float32
                    if laid_out in (2, 5, 9) else st.dtype)
    step = 64 if laid_out in (2, 5, 9) else 128
    op = scan_kernel.operand_queries(q, mode, layout_dtype, -(-d // step) * step if laid_out else 0)
    counts = ("LAUNCHES", "WGMMA_LAUNCHES", "WGMMA_F32_LAUNCHES", "WGMMA_F32MODE_LAUNCHES",
              "WGMMA_WIDE_LAUNCHES", "WGMMA_F32X_LAUNCHES", "WGMMA_S8_LAUNCHES",
              "WGMMA_S8_WIDE_LAUNCHES", "WGMMA_F32MODE_WIDE_LAUNCHES", "WGMMA_F32_WIDE_LAUNCHES")
    before = [getattr(scan_kernel, c) for c in counts]
    other = scan_kernel.BODY_NAMES[laid_out]
    with pytest.raises(RuntimeError, match=f"laid out for the {other} body"):
        scan_kernel._launch_items(lib, op, qs, qidx, pb, ptr, chunk_of, st, sc, row_ids, None,
                                  k=k, qtile=128, chunk=store.chunk, mode=mode,
                                  terms=3 if mode == "f32" else 1, body=laid_out)
    assert [getattr(scan_kernel, c) for c in counts] == before


def test_dynamic_index_on_gpu(cuda, tmp_path):
    """A DynamicIndex on the card: inserts that grow the store, deletes,
    a checkpoint that loads on the card and on the CPU, and a compaction,
    with search output equal throughout and no kernel built anew."""
    data, rng = _corpus(4000, 64, seed=21)
    nb = 8
    params = [{"w": rng.normal(size=(1, 64, 32)).astype(np.float32),
               "b": np.zeros((1, 32), np.float32)},
              {"w": rng.normal(size=(1, 32, nb)).astype(np.float32),
               "b": np.zeros((1, nb), np.float32)}]
    cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-6", 0.01, [nb], chunk_size=128)
    index = index_from_arrays(cfg, [params], [np.ones((1, nb), bool)], ["MLP-6"],
                              np.ones(nb, bool), cuda)
    pred = index.classify(data)
    dyn = lmi.DynamicIndex.from_built(index, torch.as_tensor(data, device=cuda), pred,
                                      dtype="int8")
    queries = data[:300] + 0.02
    builds = cuda_build.BUILDS
    dyn.search(queries[:2], n_buckets=3)  # the kernel's library, built or loaded
    builds = cuda_build.BUILDS
    n0 = dyn.store.n_chunks
    more, _ = _corpus(3000, 64, seed=22)
    ids = dyn.insert(torch.as_tensor(more, device=cuda))
    assert dyn.store.n_chunks > n0
    assert dyn.delete(np.concatenate([ids[::2], np.arange(1, 400)])) == 1500 + 399
    out = {}
    for precision in ("default", "highest"):
        out[precision] = dyn.search(queries, n_buckets=3, k=10, precision=precision)[:2]
        assert not np.isin(out[precision][1], np.arange(1, 400)).any()
    _, self_ids, _ = dyn.search(more[1:200:2], n_buckets=3, k=1, precision="highest")
    np.testing.assert_array_equal(self_ids[:, 0], ids[1:200:2])
    dyn.save(str(tmp_path / "dyn.ckpt"))
    back = lmi.DynamicIndex.load(str(tmp_path / "dyn.ckpt"), cuda)
    cpu = lmi.DynamicIndex.load(str(tmp_path / "dyn.ckpt"), "cpu")
    dyn.compact()
    for precision, (d0, i0) in out.items():
        for other in (back, dyn):
            d1, i1, _ = other.search(queries, n_buckets=3, k=10, precision=precision)
            np.testing.assert_array_equal(i1, i0)
            np.testing.assert_array_equal(d1.view(np.uint32), d0.view(np.uint32))
        dc, ic, _ = cpu.search(queries, n_buckets=3, k=10, precision=precision)
        np.testing.assert_allclose(dc, d0, rtol=1e-4, atol=1e-5)
        mism = ic != i0
        np.testing.assert_allclose(dc[mism], d0[mism], rtol=1e-6, atol=4e-7)
    assert cuda_build.BUILDS == builds  # growth and compaction build nothing


def test_cli_sweep_on_gpu(cuda):
    """The experiment driver on the card: a 20,000×768 synthetic sweep at
    the default f32 store (the bf16 body over f32 rows), each visit count
    equal to exact kNN over the visited buckets, one scan launch a search
    and no merge-gather launch (auto mode)."""
    from learnedmetricindex_tpu_torch import cli
    from learnedmetricindex_tpu_torch.ops.knn import recall, restricted_knn

    args = cli.parse_args(["--synthetic", "20000", "--synthetic-dim", "768", "--n-categories",
                           "16", "--epochs", "2", "--model-type", "MLP-4", "-b", "1", "4", "16",
                           "--chunk-size", "256", "--no-save", "--device", "cuda"])
    scans, pairs = scan_kernel.LAUNCHES, gather_kernel.PAIR_LAUNCHES
    result = cli.sweep(**cli.sweep_arguments(args))
    assert scan_kernel.LAUNCHES - scans == 3 and gather_kernel.PAIR_LAUNCHES == pairs
    assert result.store.chunk_data.dtype == torch.float32 and result.store.device.type == "cuda"
    q = torch.as_tensor(result.queries[:256], device=cuda)
    for n_buckets, dists, nns, measured, _ in result.searches:
        assert nns.shape == (200, 10) and np.isfinite(dists).all()
        order, _ = result.index.compute_bucket_order(q, n_buckets, keep_on_device=True)
        _, ref = restricted_knn(result.store, q, order, 10)
        assert recall(nns, ref.cpu().numpy(), 10) >= 0.999, n_buckets
        assert measured["search"] > 0.0


def test_baseline_on_gpu_matches_cpu(cuda):
    from learnedmetricindex_tpu_torch.data import synthetic_blobs

    data, queries = synthetic_blobs(20000, 96, 300, seed=4)
    gpu = lmi.Baseline(device=cuda)
    dg, ig, _ = gpu.search(queries, data, k=10)
    dc, ic, _ = lmi.Baseline(device="cpu").search(queries, data, k=10)
    assert gpu._norm_cache[1].device.type == "cuda"
    np.testing.assert_allclose(dg, dc, rtol=1e-4, atol=1e-5)
    mism = ig != ic  # only where two f32 sums in other orders nearly tie
    np.testing.assert_allclose(dg[mism], dc[mism], rtol=1e-6, atol=1e-6)


def test_device_trace_names_the_scan_kernel(cuda, tmp_path):
    from learnedmetricindex_tpu_torch.utils.profiling import device_events, device_trace, span

    data, _ = _corpus(4000, 64, seed=8)
    cfg = lmi.BuildConfiguration("kmeans", 2, "MLP", 0.01, [8], seed=8, chunk_size=128)
    index, pred, *_ = lmi.LearnedIndexBuilder(data, cfg, device=cuda).build()
    store = index.get_bucket_store(data, pred)
    q = torch.as_tensor(data[:500], device=cuda)
    index.search(None, q, None, q, pred, n_buckets=3, k=10, store=store)  # warm
    with device_trace(str(tmp_path), device=cuda) as prof:
        with span("lmi.search"):
            index.search(None, q, None, q, pred, n_buckets=3, k=10, store=store)
    names = {e["name"] for e in device_events(prof.trace_path)}
    # an f32 store at k_scan 16: the wgmma body over f32 rows
    assert any("scan_wgmma_f32" in n for n in names), sorted(names)[:20]


def test_split_and_launch_spans_hold_the_scan_launch(cuda, tmp_path):
    """The host call that launched the scan kernel (matched to the kernel
    by its correlation id) lies in ``lmi.launch``, inside ``lmi.split``,
    inside ``lmi.scan``, on one thread."""
    import json

    from learnedmetricindex_tpu_torch.utils.profiling import device_trace

    data, _ = _corpus(4000, 64, seed=8)
    cfg = lmi.BuildConfiguration("kmeans", 2, "MLP", 0.01, [8], seed=8, chunk_size=128)
    index, pred, *_ = lmi.LearnedIndexBuilder(data, cfg, device=cuda).build()
    store = index.get_bucket_store(data, pred)
    q = torch.as_tensor(data[:500], device=cuda)
    index.search(None, q, None, q, pred, n_buckets=3, k=10, store=store)  # warm
    with device_trace(str(tmp_path), device=cuda) as prof:
        index.search(None, q, None, q, pred, n_buckets=3, k=10, store=store)
    with open(prof.trace_path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    kernel = [e for e in events if e.get("cat") == "kernel" and "scan_wgmma" in e["name"]]
    assert len(kernel) == 1, [e["name"] for e in events if e.get("cat") == "kernel"]
    corr = kernel[0]["args"]["correlation"]
    calls = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and e.get("args", {}).get("correlation") == corr]
    assert calls, f"no host call with the scan kernel's correlation {corr}"
    call = calls[0]

    def holding(name):
        return [e for e in events if e.get("cat") == "user_annotation" and e["name"] == name
                and e["tid"] == call["tid"]
                and e["ts"] <= call["ts"] <= call["ts"] + call["dur"] <= e["ts"] + e["dur"]]

    (launch,), (split,), (scan,) = holding("lmi.launch"), holding("lmi.split"), holding("lmi.scan")
    assert scan["ts"] <= split["ts"] <= launch["ts"]
    assert launch["ts"] + launch["dur"] <= split["ts"] + split["dur"] <= scan["ts"] + scan["dur"]


def _virtual_case(dev, d, corpus, seed, shuffle):
    """A virtual store over a 3000×d corpus (f32, bf16, or int8 with row
    scales; 40 rows duplicated later in their own bucket), 6 buckets with
    one empty, chunk 96; ``shuffle`` moves its chunks out of physical
    order (each bucket's list keeps the scan order).  Returns the store,
    160 queries and their (160, 3) visits."""
    data, rng = _corpus(3000, d, seed=seed)
    bucket_ids = rng.integers(0, 6, 3000)
    bucket_ids[bucket_ids == 2] = 3
    src, dst = np.arange(0, 40), np.arange(1500, 1540)
    data[dst], bucket_ids[dst] = data[src], bucket_ids[src]
    x = torch.as_tensor(data, device=dev)
    scales = None
    if corpus == "int8":
        x, scales = quantize.quantize_rows(x)
    elif corpus == "bfloat16":
        x = x.bfloat16()
    store = BucketStore.build_virtual(x, bucket_ids, 6, chunk=96, row_scales=scales)
    if shuffle:
        perm = np.random.default_rng(seed).permutation(store.n_chunks)
        inv = torch.as_tensor(np.argsort(perm), device=dev)
        ptr, clist = store.chunk_list()
        store = store._replace(chunk_ids=store.chunk_ids[inv], bucket_chunk_ptr=ptr,
                               bucket_chunk_list=perm[clist].astype(np.int32))
    queries = torch.as_tensor(np.concatenate([data[src], data[40:160] + 0.05]), device=dev)
    order = np.stack([rng.choice(6, 3, replace=False) for _ in range(160)])
    order[:40, 0] = bucket_ids[src]
    order[:40, 1:] = [[b for b in rng.permutation(6) if b != bucket_ids[i]][:2] for i in src]
    order = torch.as_tensor(order, device=dev)
    order[-10:, 2] = -1
    return store, queries, order


def _kernel_vs_plain(args, k, qtile, chunk, mode, launches):
    """The kernel (``launches`` launches) against the plain version: int8
    bit-equal, f32/bf16 to the bars, slots differing only at ties, and no
    slot twice in a list."""
    before = scan_kernel.LAUNCHES
    kd, ks = scan_kernel.scan_pairs(*args, k=k, qtile=qtile, chunk=chunk, mode=mode)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES == before + launches
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=chunk, mode=mode)
    kd, ks, rd, rs = (t.cpu().numpy() for t in (kd, ks, rd, rs))
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(rd))
    if mode == "int8":
        np.testing.assert_array_equal(kd.view(np.uint32), rd.view(np.uint32))
        np.testing.assert_array_equal(ks, rs)
    else:
        np.testing.assert_allclose(kd, rd, rtol=1e-4, atol=1e-5)
        mism = ks != rs
        np.testing.assert_allclose(kd[mism], rd[mism], rtol=1e-6, atol=5e-6)
    for row in ks.reshape(-1, k):
        live = row[row >= 0]
        assert len(np.unique(live)) == len(live)
    return ks


@pytest.mark.parametrize("corpus,mode", [
    ("float32", "bf16"), ("float32", "f32"), ("bfloat16", "bf16"), ("bfloat16", "f32"),
    ("int8", "bf16"), ("int8", "f32"), ("int8", "int8")])
@pytest.mark.parametrize("k,qtile,shuffle", [(16, 128, False), (128, 8, True), (1024, 100, False)])
def test_row_map_kernel_matches_plain_version(cuda, corpus, mode, k, qtile, shuffle):
    """A virtual store (rows read through the id grid, scale 0 on padding,
    the row's scale for an int8 corpus, 1 otherwise): the kernel equals
    the plain version at list widths 32, 128 and 1024, also with the
    chunk lists out of physical order; exact ties go to the earlier row."""
    store, queries, order = _virtual_case(cuda, 768, corpus, seed=k, shuffle=shuffle)
    _, args = scan_inputs(store, queries, order, qtile, mode)
    assert args[8] is not None and args[5] is store.data_ref
    ks = _kernel_vs_plain(args, k, qtile, 96, mode, 1)
    slot_of_copy = {}
    flat = store.chunk_ids.reshape(-1).cpu().numpy()
    for slot in np.nonzero((flat >= 1501) & (flat <= 1540))[0]:
        slot_of_copy[flat[slot]] = slot
    orig = {flat[s]: s for s in np.nonzero((flat >= 1) & (flat <= 40))[0]}
    _, position = store.chunk_owner()
    pos = lambda s: position[s // 96] * 96 + s % 96  # noqa: E731
    lists = ks.reshape(-1, k)
    for i in range(40):
        a, b = orig[i + 1], slot_of_copy[1501 + i]
        first, later = (a, b) if pos(a) < pos(b) else (b, a)
        rows, cols = np.nonzero(lists == later)
        for r, j in zip(rows, cols):
            assert (lists[r, :j] == first).any()


#: the row-map bodies' launch counters by mode (bf16: body 10, f32: body 11)
ROWMAP_COUNTER = {"bf16": "WGMMA_INT8_ROWMAP_LAUNCHES", "f32": "WGMMA_F32MODE_ROWMAP_LAUNCHES"}


@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("qtile,shuffle", [(1, False), (8, True), (100, False), (128, True)])
def test_row_map_bodies_match_plain_version(cuda, mode, qtile, shuffle):
    """The row-map wgmma bodies (bf16: body 10, f32: body 11) over a virtual
    store of an int8 + row-scale corpus (padding slots, an empty bucket,
    chunks of 96 rows, so a chunk's second tile ends past it; chunk lists
    in and out of physical order) at qtile 1/8/100/128: one launch on the
    body, within the bar of the plain version, exact ties to the earlier
    row; forced segments of 1 and 2 chunks give the bits of whole buckets,
    each launch on the body."""
    store, queries, order = _virtual_case(cuda, 768, "int8", seed=50 + qtile, shuffle=shuffle)
    plan, args = scan_inputs(store, queries, order, qtile, mode)
    before = getattr(scan_kernel, ROWMAP_COUNTER[mode])
    ks = _kernel_vs_plain(args, 16, qtile, 96, mode, 1)
    assert getattr(scan_kernel, ROWMAP_COUNTER[mode]) == before + 1
    flat = store.chunk_ids.reshape(-1).cpu().numpy()
    _, position = store.chunk_owner()
    pos = {s: position[s // 96] * 96 + s % 96 for s in np.nonzero(flat > 0)[0]}
    slot_of = {flat[s]: s for s in pos}
    for row in ks.reshape(-1, 16):  # an exact copy (rows 1501..1540) after its original
        for j, s in enumerate(row):
            if s >= 0 and 1501 <= flat[s] <= 1540:
                first = slot_of[flat[s] - 1500]
                if pos[first] < pos[s]:
                    assert (row[:j] == first).any()
    whole = _split_kernel(args, plan, store, 16, qtile, mode, 10**6)
    for segment in (1, 2):
        got = _split_kernel(args, plan, store, 16, qtile, mode, segment)
        assert torch.equal(got[0].view(torch.int32), whole[0].view(torch.int32))
        assert torch.equal(got[1], whole[1])
    assert getattr(scan_kernel, ROWMAP_COUNTER[mode]) == before + 4


@pytest.mark.parametrize("mode", ["bf16", "f32"])
@pytest.mark.parametrize("d", [768, 96, 256])
def test_row_map_lists_are_the_packed_stores_bits(cuda, mode, d):
    """A virtual store of an int8 + row-scale corpus and the packed store
    ``build_packed_device`` makes of the same corpus (each slot's bytes and
    scale copied unchanged, the same slots) give the same lists bit for
    bit: the row-map bodies (10, 11) gather the bytes the packed bodies (1,
    3) read by TMA, and the same scales, at k 16 and 32 and qtile 8 and
    128."""
    data, rng = _corpus(4000, d, seed=d)
    bucket_ids = rng.integers(0, 5, 4000)
    x8, sc = quantize.quantize_rows(torch.as_tensor(data, device=cuda))
    virtual = BucketStore.build_virtual(x8, bucket_ids, 5, chunk=160, row_scales=sc)
    packed = BucketStore.build_packed_device(x8, bucket_ids, 5, chunk=160, row_scales=sc)
    queries = torch.as_tensor(data[:200] + 0.05 * rng.normal(size=(200, d)).astype(np.float32),
                              device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(5, 2, replace=False) for _ in range(200)]),
                            device=cuda)
    packed_counter = "WGMMA_F32MODE_LAUNCHES" if mode == "f32" else None
    for k in (16, 32):
        for qtile in (8, 128):
            _, va = scan_inputs(virtual, queries, order, qtile, mode)
            _, pa = scan_inputs(packed, queries, order, qtile, mode)
            kw = dict(k=k, qtile=qtile, chunk=160, mode=mode)
            before = (getattr(scan_kernel, ROWMAP_COUNTER[mode]), scan_kernel.WGMMA_LAUNCHES,
                      getattr(scan_kernel, packed_counter) if packed_counter else 0)
            vd, vs = scan_kernel.scan_pairs(*va, **kw)
            pd, ps = scan_kernel.scan_pairs(*pa, **kw)
            torch.cuda.synchronize()
            assert getattr(scan_kernel, ROWMAP_COUNTER[mode]) == before[0] + 1
            assert scan_kernel.WGMMA_LAUNCHES == before[1] + 2
            if packed_counter:
                assert getattr(scan_kernel, packed_counter) == before[2] + 1
            assert torch.equal(vd.view(torch.int32), pd.view(torch.int32))
            assert torch.equal(vs, ps)
            assert bool(torch.isfinite(vd).any())


def test_row_map_f32_body_is_no_less_exact_than_plain(cuda):
    """f32 queries over a virtual store of an int8 + row-scale corpus at d
    768 (the f32-mode row-map body): the kernel's distances of the
    candidates it returns are no farther from float64 than the plain
    version's (cuBLAS SGEMM in full f32) of its own candidates."""
    data, rng = _corpus(6000, 768, seed=17)
    x8, sc = quantize.quantize_rows(torch.as_tensor(data, device=cuda))
    store = BucketStore.build_virtual(x8, rng.integers(0, 4, 6000), 4, chunk=256, row_scales=sc)
    queries = torch.as_tensor(data[:400] + 0.05 * rng.normal(size=(400, 768)).astype(np.float32),
                              device=cuda)
    order = torch.as_tensor(np.stack([rng.choice(4, 2, replace=False) for _ in range(400)]),
                            device=cuda)
    _, args = scan_inputs(store, queries, order, 128, "f32")
    kw = dict(k=16, qtile=128, chunk=256, mode="f32")
    rows = args[1].reshape(-1, 128).long()
    ids = store.chunk_ids.reshape(-1).long()

    def error(dists, slots):
        ok = (slots >= 0) & (rows >= 0)[:, :, None]
        q = args[0][rows.clamp_min(0)].double()
        src = (ids[slots.long().clamp_min(0)] - 1).clamp_min(0)
        exact = 1.0 - torch.einsum("pqd,pqkd->pqk", q, x8[src].double()) * sc[src].double()
        return float((dists.double() - exact).abs()[ok].max())

    before = scan_kernel.WGMMA_F32MODE_ROWMAP_LAUNCHES
    k_err = error(*scan_kernel.scan_pairs(*args, **kw))
    assert scan_kernel.WGMMA_F32MODE_ROWMAP_LAUNCHES == before + 1
    p_err = error(*scan_kernel.scan_pairs_reference(*args, **kw))
    assert 0.0 < k_err <= p_err, (k_err, p_err)


def _wide_case(dev, store_kind, seed):
    """9000×768 rows in 3 buckets of ~3,000 (wider than two rounds),
    chunk 256: an int8 or f32 store after 600 inserts and 300 deletes with
    its chunks moved out of physical order, or a virtual store over a bf16
    (``virtual``) or f32 (``virtual_f32``) corpus with its chunk lists
    shuffled.  Returns (store, 100 queries,
    their (100, 2) visits)."""
    data, rng = _corpus(9000, 768, seed=seed)
    bucket_ids = rng.integers(0, 3, 9000)
    if store_kind.startswith("virtual"):
        corpus = torch.as_tensor(data, device=dev)
        store = BucketStore.build_virtual(corpus if store_kind == "virtual_f32" else corpus.bfloat16(),
                                          bucket_ids, 3, chunk=256)
        perm = rng.permutation(store.n_chunks)
        ptr, clist = store.chunk_list()
        store = store._replace(chunk_ids=store.chunk_ids[torch.as_tensor(np.argsort(perm),
                                                                         device=dev)],
                               bucket_chunk_ptr=ptr, bucket_chunk_list=perm[clist].astype(np.int32))
    else:
        if store_kind == "int8":
            store = BucketStore.build_packed_int8(data, bucket_ids, 3, chunk=256, device=dev)
        else:
            store = BucketStore.build(data, bucket_ids, 3, chunk=256, device=dev)
        more, _ = _corpus(600, 768, seed=seed + 1)
        store = mutation.insert_rows(store, more, rng.integers(0, 3, 600), np.arange(9001, 9601))
        store, _ = mutation.delete_ids(store, rng.choice(9600, 300, replace=False) + 1)
        store = _shuffled(store, seed)
    queries = torch.as_tensor(data[:100] + 0.05, device=dev)
    order = torch.as_tensor(np.stack([rng.choice(3, 2, replace=False) for _ in range(100)]),
                            device=dev)
    order[-10:, 1] = -1
    return store, queries, order


@pytest.mark.parametrize("store_kind,mode", [("int8", "int8"), ("int8", "bf16"),
                                             ("float32", "f32"), ("virtual", "bf16"),
                                             ("virtual_f32", "f32")])
@pytest.mark.parametrize("k", [1030, 1100, 2100])
def test_rounds_match_plain_version(cuda, store_kind, mode, k):
    """k past the widest list runs in rounds of at most 1024, one launch a
    round, and equals the plain version's one list, over a mutated store
    (chunk lists out of physical order) or a virtual one."""
    store, queries, order = _wide_case(cuda, store_kind, seed=k)
    _, args = scan_inputs(store, queries, order, 8, mode)
    _kernel_vs_plain(args, k, 8, 256, mode, -(-k // scan_kernel.MAX_K))


def test_virtual_and_sharded_searches_on_gpu(cuda):
    """On the card a virtual store's search equals the packed store's, its
    k=1100 search equals exact kNN over the visited buckets, and a store
    sharded over [cuda] * 3 (from the tensor corpus and from the packed
    store) launches the scan once a shard and equals the single store."""
    from learnedmetricindex_tpu_torch.ops.knn import recall, restricted_knn
    from learnedmetricindex_tpu_torch.parallel import shard_packed_store

    data, rng = _corpus(6000, 64, seed=31)
    nb = 8
    params = [{"w": rng.normal(size=(1, 64, 32)).astype(np.float32),
               "b": np.zeros((1, 32), np.float32)},
              {"w": rng.normal(size=(1, 32, nb)).astype(np.float32),
               "b": np.zeros((1, nb), np.float32)}]
    cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-6", 0.01, [nb], chunk_size=128)
    index = index_from_arrays(cfg, [params], [np.ones((1, nb), bool)], ["MLP-6"],
                              np.ones(nb, bool), cuda)
    pred = rng.integers(0, nb, (6000, 1))
    x8, sc = quantize.quantize_rows(torch.as_tensor(data, device=cuda))
    virtual = index.get_bucket_store((x8, sc), pred)
    packed = index.prepare_packed_store((x8, sc), pred)
    assert virtual.virtual and virtual.nbytes() * 4 < packed.nbytes()
    q = torch.as_tensor(data[:300] + 0.01, device=cuda)
    for precision in ("default", "highest"):
        vd, vi, _ = index.search(None, q, None, q, pred, n_buckets=3, k=10, store=virtual,
                                 precision=precision)
        pd, pi, _ = index.search(None, q, None, q, pred, n_buckets=3, k=10, store=packed,
                                 precision=precision)
        np.testing.assert_allclose(vd, pd, rtol=1e-4, atol=1e-5)
        mism = vi != pi
        np.testing.assert_allclose(vd[mism], pd[mism], rtol=1e-6, atol=5e-6)
    order, _ = index.compute_bucket_order(q[:64], 3, keep_on_device=True)
    wd, wi, _ = index.search(None, q[:64], None, q[:64], pred, n_buckets=3, k=1100,
                             store=virtual, precision="highest")
    _, ref = restricted_knn(virtual, q[:64], order, 1100)
    assert recall(wi, ref.cpu().numpy(), 1100) >= 0.999
    sd, si, _ = index.search(None, q, None, q, pred, n_buckets=3, k=10, store=packed)
    for sharded in (index.get_sharded_store((x8, sc), pred, [cuda] * 3, chunk=128),
                    shard_packed_store(packed, [cuda] * 3)):
        before = scan_kernel.LAUNCHES
        hd, hi, _ = index.search(None, q, None, q, pred, n_buckets=3, k=10, store=sharded)
        assert scan_kernel.LAUNCHES - before == 3
        np.testing.assert_allclose(hd, sd, rtol=1e-4, atol=1e-5)
        mism = hi != si
        np.testing.assert_allclose(hd[mism], sd[mism], rtol=1e-6, atol=5e-6)


@pytest.mark.parametrize("mode", ["bf16", "f32", "int8"])
def test_kernel_matches_plain_version_on_sharded_stores(cuda, mode):
    """Each shard of an int8 store sharded over [cuda] * 4, fresh and after
    a ShardedDynamicIndex's inserts (chunks from the pool, growth) and
    deletes (holes), scanned by the kernel equals the plain version, one
    launch a shard."""
    from learnedmetricindex_tpu_torch.parallel import ShardedDynamicIndex

    data, rng = _corpus(6000, 64, seed=41)
    nb = 8
    params = [{"w": rng.normal(size=(1, 64, 32)).astype(np.float32),
               "b": np.zeros((1, 32), np.float32)},
              {"w": rng.normal(size=(1, 32, nb)).astype(np.float32),
               "b": np.zeros((1, nb), np.float32)}]
    cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-6", 0.01, [nb], chunk_size=128)
    index = index_from_arrays(cfg, [params], [np.ones((1, nb), bool)], ["MLP-6"],
                              np.ones(nb, bool), cuda)
    pred = rng.integers(0, nb, (6000, 1))
    x8, sc = quantize.quantize_rows(torch.as_tensor(data, device=cuda))
    dyn = ShardedDynamicIndex.from_built(index, (x8, sc), pred, [cuda] * 4, chunk=128)
    q = torch.as_tensor(data[:300] + 0.01, device=cuda)
    order, _ = index.compute_bucket_order(q, nb, keep_on_device=True)
    for step in ("fresh", "mutated"):
        if step == "mutated":
            extra, _ = _corpus(3000, 64, seed=42)
            ids = dyn.insert(torch.as_tensor(extra, device=cuda))
            assert dyn.delete(np.concatenate([ids[::3], np.arange(1, 1500)])) == 1000 + 1499
        st = dyn.store
        at = order.clamp_min(0).long()
        owner = torch.as_tensor(st.bucket_device, device=cuda)[at]
        local = torch.as_tensor(st.bucket_local, device=cuda)[at]
        for i, shard in enumerate(st.shards):
            _, args = scan_inputs(shard, q, torch.where((order >= 0) & (owner == i), local, -1),
                                  128, mode)
            _kernel_vs_plain(args, 16, 128, shard.chunk, mode, 1)


def test_device_list_build_on_gpu(cuda):
    """A [4, 2] build over [cuda] * 4 (sharded k-means at the root, the
    trainer data parallel there and expert parallel below) searches a
    store sharded over the same list: exact at a full visit."""
    from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall

    data, _ = _corpus(6000, 32, seed=43)
    cfg = lmi.BuildConfiguration("kmeans", 20, "MLP", 0.02, [4, 2], seed=5, chunk_size=256)
    index, pred, n_buckets, _, _ = lmi.LearnedIndexBuilder(
        data, cfg, device=cuda, devices=[cuda] * 4).build()
    assert n_buckets >= 2 and (pred >= 0).all()
    sharded = index.get_sharded_store(data, pred, [cuda] * 4)
    q = data[:200] + 0.01
    before = scan_kernel.LAUNCHES
    _, nns, _ = index.search(None, q, None, q, pred, n_buckets=n_buckets, k=10, store=sharded)
    assert scan_kernel.LAUNCHES - before == 4
    _, gt = exact_knn(data, q, k=10, device=cuda)
    assert recall(nns, gt, 10) == 1.0


def _tied_case(dev, store_dtype, seed):
    """Rows that all tie: each of 4 buckets holds one vector over and over
    (~2,100 rows, chunk 96), then 300 deletes leave padding slots inside
    the lists and the chunks move out of physical order.  Every distance
    a query sees in a bucket is the same, so its list must be the
    bucket's first live rows in scan order.  Returns (store, 120 queries,
    their (120, 2) visits, each bucket's live slots in scan order)."""
    data, rng = _corpus(8400, 64, seed=seed)
    bucket_ids = rng.integers(0, 4, 8400)
    data = data[:4][bucket_ids]
    if store_dtype == "int8":
        store = BucketStore.build_packed_int8(data, bucket_ids, 4, chunk=96, device=dev)
    else:
        store = BucketStore.build(data, bucket_ids, 4, chunk=96, dtype=store_dtype, device=dev)
    store, _ = mutation.delete_ids(store, rng.choice(8400, 300, replace=False) + 1)
    store = _shuffled(store, seed)
    queries = torch.as_tensor(_corpus(120, 64, seed=seed + 1)[0], device=dev)
    order = torch.as_tensor(np.stack([rng.choice(4, 2, replace=False) for _ in range(120)]),
                            device=dev)
    order[-10:, 1] = -1
    ptr, clist = store.chunk_list()
    ids = store.chunk_ids.reshape(-1).cpu().numpy()
    in_order = []
    for b in range(4):
        slots = (clist[ptr[b]:ptr[b + 1], None] * 96 + np.arange(96)).reshape(-1)
        in_order.append(slots[ids[slots] > 0])
    return store, queries, order, in_order


def _in_scan_order(qidx, pair_bucket, slots, in_order):
    """Every live query's list is its bucket's first live slots in scan
    order, then -1."""
    n_pairs, qtile, k = slots.shape
    qidx = qidx.cpu().numpy().reshape(n_pairs, qtile)
    for p, b in enumerate(pair_bucket.cpu().numpy()):
        want = in_order[b][:k]
        for j in np.nonzero(qidx[p] >= 0)[0]:
            np.testing.assert_array_equal(slots[p, j, :len(want)], want)
            assert (slots[p, j, len(want):] == -1).all()


@pytest.mark.parametrize("mode,store_dtype", [
    ("bf16", "float32"), ("bf16", "bfloat16"), ("bf16", "int8"), ("int8", "int8"),
    ("f32", "float32"), ("f32", "bfloat16"), ("f32", "int8")])
@pytest.mark.parametrize("width,qtile", [(64, 1), (128, 100), (256, 128), (512, 1), (1024, 100)])
def test_wide_lists_keep_the_tie_rule(cuda, mode, store_dtype, width, qtile):
    """List widths 64 to 1024 over rows that all tie, with padding slots
    and chunk lists out of physical order: (1) one launch at k = width - 5
    equals the plain version and lists each bucket's first rows in scan
    order; (2) rounds of `width` up to 2·width + 5 (one launch a round,
    each past the first with the last round's floor, ties straddling
    every boundary) do too; (3) at qtile 128, a pair whose query slots
    are all padding but three in one later block (m-tile 7 where one
    block holds the pair), and a pair with no live slot at all, equal the
    plain version; (4) bf16 over the int8 store at widths 64 and 128 (the
    wide-list wgmma body) with integer queries, bit-equal to the plain
    version.  int8 at widths 64 and 128 runs (1) and (3) on the int8 wgmma
    body with wide lists, f32 over the int8 store on the f32-mode wgmma
    body with wide lists and bf16 over the f32 store on the wgmma body over
    f32 rows with wide lists.  A round under a floor takes the mma.sync
    body (``wgmma_scope``); the library's rounds are 1024 wide, past every
    wgmma body, so all of them sum a row alike.  Rounds of 64 or 128 in f32
    over the int8 store or in bf16 over the f32 store would start on a
    wgmma body whose sums are not the mma.sync body's bits (the f32-mode
    body folds every 128 depths, that body every 16; the body over f32
    rows sums its k-steps in another order), so in (2) their first round
    runs under a floor that admits every row, and takes the body of the
    rounds after it."""
    store, queries, order, in_order = _tied_case(cuda, store_dtype, seed=width)
    plan, args = scan_inputs(store, queries, order, qtile, mode)
    s8_wide = mode == "int8" and width <= 128
    f32_wide = mode == "f32" and store_dtype == "int8" and width <= 128
    f32_rows_wide = mode == "bf16" and store_dtype == "float32" and width <= 128
    counts = ("WGMMA_S8_WIDE_LAUNCHES", "WGMMA_F32MODE_WIDE_LAUNCHES", "WGMMA_F32_WIDE_LAUNCHES")
    before = [getattr(scan_kernel, c) for c in counts]
    ks = _kernel_vs_plain(args, width - 5, qtile, 96, mode, 1)
    assert [getattr(scan_kernel, c) - b for c, b in zip(counts, before)] == [
        s8_wide, f32_wide, f32_rows_wide]
    _in_scan_order(plan.qidx, plan.pair_bucket, ks, in_order)

    k = 2 * width + 5
    launch = scan_kernel._kernel_round(args[0], *args[3:7], args[7], args[8], qtile=qtile,
                                       chunk=96, mode=mode)
    floors = []

    def scan_round(q_idx, p_bucket, w, floor):
        if floor is None and (f32_wide or f32_rows_wide):  # (−inf, −1): every row is above it
            floor = (torch.full(q_idx.shape, -torch.inf, device=cuda),
                     torch.full(q_idx.shape, -1, dtype=torch.int32, device=cuda))
        floors.append(floor is not None)
        return launch(q_idx, p_bucket, w, floor)

    before = scan_kernel.LAUNCHES
    positions = scan_kernel.chunk_positions(args[3], args[4], store.n_chunks)
    kd, ks = scan_kernel.scan_in_rounds(scan_round, plan.qidx, plan.pair_bucket, positions,
                                        k=k, qtile=qtile, chunk=96, width=width)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES - before == len(floors) and floors[:2] == [
        f32_wide or f32_rows_wide, True]
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=96, mode=mode)
    kd, ks, rd, rs = (t.cpu().numpy() for t in (kd, ks, rd, rs))
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(rd))
    np.testing.assert_allclose(kd, rd, rtol=1e-4, atol=1e-5)
    if mode == "int8":
        np.testing.assert_array_equal(kd.view(np.uint32), rd.view(np.uint32))
    _in_scan_order(plan.qidx, plan.pair_bucket, ks, in_order)

    plan, args = scan_inputs(store, queries, order, 128, mode)
    qidx = args[1].clone().reshape(-1, 128)
    assert qidx.shape[0] >= 2 and bool((qidx[0, :3] >= 0).all())
    per_block = 128 if width <= 128 else 128 * 128 // width
    at = 112 if per_block == 128 else per_block
    rows = qidx[0, :3].clone()
    qidx[0] = -1
    qidx[0, at:at + 3] = rows
    qidx[1] = -1
    args = (args[0], qidx.reshape(-1), *args[2:])
    before = [getattr(scan_kernel, c) for c in counts]
    ks = _kernel_vs_plain(args, width - 5, 128, 96, mode, 1)
    assert [getattr(scan_kernel, c) - b for c, b in zip(counts, before)] == [
        s8_wide, f32_wide, f32_rows_wide]
    _in_scan_order(qidx, plan.pair_bucket, ks, in_order)
    assert (ks[1] == -1).all() and (ks[0, :at] == -1).all() and (ks[0, at + 3:] == -1).all()

    if (mode, store_dtype) != ("bf16", "int8") or width > 128:
        return
    # (4) the wide-list wgmma body over exact integer ties: queries of small
    # integers (exact in bf16) against the int8 rows sum exactly, so the
    # kernel's distances are the plain version's bits, and its lists too
    q_int = np.random.default_rng(width).integers(-3, 4, tuple(queries.shape))
    plan, args = scan_inputs(store, torch.as_tensor(q_int, dtype=torch.float32, device=cuda),
                             order, qtile, mode)
    kw = dict(k=width - 5, qtile=qtile, chunk=96, mode=mode)
    before = scan_kernel.WGMMA_WIDE_LAUNCHES
    kd, ks = scan_kernel.scan_pairs(*args, **kw)
    torch.cuda.synchronize()
    assert scan_kernel.WGMMA_WIDE_LAUNCHES == before + 1
    rd, rs = scan_kernel.scan_pairs_reference(*args, **kw)
    assert torch.equal(kd.view(torch.int32), rd.view(torch.int32)) and torch.equal(ks, rs)
    _in_scan_order(plan.qidx, plan.pair_bucket, ks.cpu().numpy(), in_order)


def _split_kernel(args, plan, store, k, qtile, mode, segment):
    """The scan and merge kernels over ``args``'s plan with ``segment``
    chunks a segment (None: the wrapper's choice), in rounds past 1024;
    checks one scan launch a round and one merge a round that split a pair
    (none over whole buckets, segment 10**6)."""
    launch = scan_kernel._kernel_round(args[0], *args[3:7], args[7], args[8], qtile=qtile,
                                       chunk=store.chunk, mode=mode, segment=segment)
    rounds = []

    def scan_round(q_idx, p_bucket, w, floor):
        rounds.append(w)
        return launch(q_idx, p_bucket, w, floor)

    counts = ("LAUNCHES", "MERGE_LAUNCHES", "SPLIT_LAUNCHES")
    before = [getattr(scan_kernel, c) for c in counts]
    if k <= scan_kernel.MAX_K:
        out = scan_round(plan.qidx, plan.pair_bucket, k, None)
    else:
        positions = scan_kernel.chunk_positions(args[3], args[4], store.n_chunks)
        out = scan_kernel.scan_in_rounds(scan_round, plan.qidx, plan.pair_bucket, positions,
                                         k=k, qtile=qtile, chunk=store.chunk)
    torch.cuda.synchronize()
    scans, merges, splits = (getattr(scan_kernel, c) - b for c, b in zip(counts, before))
    assert scans == len(rounds) and merges == splits
    if segment == 10**6:
        assert merges == 0
    return out


@pytest.mark.parametrize("mode,store_dtype", [
    ("bf16", "float32"), ("bf16", "bfloat16"), ("bf16", "int8"), ("int8", "int8"),
    ("f32", "float32"), ("f32", "bfloat16"), ("f32", "int8")])
@pytest.mark.parametrize("k,qtile", [(16, 128), (100, 8), (300, 100), (1024, 1), (1100, 128)])
def test_split_kernel_equals_unsplit_kernel(cuda, mode, store_dtype, k, qtile):
    """Segments of 1 and 2 chunks and the wrapper's own choice: the scan
    kernel over the items and the merge kernel give the bits of the
    kernel over whole buckets (a segment longer than any bucket), over
    rows that all tie (ties straddle every segment boundary; each list
    its bucket's first live rows in scan order) and over a mutated store
    with exact copies of rows, at every list width and past 1024 in
    rounds under floors."""
    store, queries, order, in_order = _tied_case(cuda, store_dtype, seed=k)
    mutated, mq, morder, _, _ = _mutated_store(cuda, 96, store_dtype, seed=k)
    for st, q, o in ((store, queries, order), (mutated, mq, morder)):
        plan, args = scan_inputs(st, q, o, qtile, mode)
        whole = _split_kernel(args, plan, st, k, qtile, mode, 10**6)
        for segment in (1, 2, None):
            got = _split_kernel(args, plan, st, k, qtile, mode, segment)
            assert torch.equal(got[0].view(torch.int32), whole[0].view(torch.int32))
            assert torch.equal(got[1], whole[1])
            if st is store:
                _in_scan_order(plan.qidx, plan.pair_bucket, got[1].cpu().numpy(), in_order)


def _merge_lists(rng, per_pair, qtile, k):
    """Sorted item lists with many exact ties (values in sevenths), ~20%
    +inf, one item of the second pair all +inf; ``per_pair`` items a pair."""
    pair_items = np.concatenate([[0], np.cumsum(per_pair)]).astype(np.int32)
    n_items = int(pair_items[-1])
    vals = rng.integers(0, 50, (n_items, qtile, k)).astype(np.float32) / 7
    vals[rng.random((n_items, qtile, k)) < 0.2] = np.inf
    vals[pair_items[1]] = np.inf  # an empty item inside a split pair
    vals.sort(axis=2)
    slots = np.where(np.isinf(vals), -1, rng.integers(0, 2**30, vals.shape)).astype(np.int32)
    return vals, slots, pair_items


@pytest.mark.parametrize("qtile", [1, 3, 8, 100, 128])
@pytest.mark.parametrize("k", [16, 32, 106, 128, 1024])
def test_merge_kernel_matches_plain_version(cuda, k, qtile):
    """Sorted lists with many exact ties, 1 to 80 items a pair (one-item
    pairs among split ones, an all-+inf item): the merge kernel equals its
    plain version bit for bit (distance, item order, place in list), one
    launch a call.  Lists of at most 32 merge in a warp's lanes: under the
    wrapper's plan and groups of 3 and of the whole query tile.  Wider:
    under the plan for the most items a pair has (staged in shared memory,
    or past its budget streamed: k 1024 at 24 items and more), for an
    unknown count (pairs past the default cap streamed) and for a count
    that every split pair passes (all streamed)."""
    rng = np.random.default_rng(k * 1000 + qtile)
    budget = max(6, 2**24 // (qtile * k))  # items, so that the lists stay ~128 MB
    per_pair = [1, min(80, budget - 5), 1, 2, 3]
    while sum(per_pair) < budget and len(per_pair) < 40:
        per_pair.append(int(rng.integers(1, min(81, budget - sum(per_pair) + 1))))
    vals, slots, pair_items = _merge_lists(rng, np.asarray(per_pair), qtile, k)
    args = tuple(torch.as_tensor(a, device=cuda) for a in (vals, slots, pair_items))
    rd, rs = scan_kernel.merge_split_lists_reference(*args)
    most = max(per_pair)
    plans = {m: scan_kernel.merge_plan(k, qtile, m) for m in (most, None, 2)}
    if k <= scan_kernel.MERGE_WARP_MAX_K:
        plans = {most: plans[most], "group 3": scan_kernel.MergePlan(min(3, qtile), 0, 0),
                 "whole tile": scan_kernel.MergePlan(qtile, 0, 0)}
    else:
        assert plans[2].cap == 2 and (plans[most].cap == 0) == (
            scan_kernel.merge_smem_bytes(1, most, k) > scan_kernel.MERGE_SMEM_MAX)
    for name, plan in plans.items():
        before = scan_kernel.MERGE_LAUNCHES
        kd, ks = scan_kernel.merge_split_lists(*args, most, plan=plan)
        torch.cuda.synchronize()
        assert scan_kernel.MERGE_LAUNCHES == before + 1
        assert torch.equal(kd.view(torch.int32), rd.view(torch.int32)) and torch.equal(ks, rs), (
            f"{name}: plan {plan}")


def test_scan_merges_only_where_a_pair_splits(cuda):
    """A scan over whole buckets (segment 10**6: one item a pair) launches
    no merge, and its lists are the scan's; at segment 1 every bucket of
    several chunks splits, one merge; the same bits."""
    store, queries, order, _ = _tied_case(cuda, "int8", seed=3)
    plan, args = scan_inputs(store, queries, order, 128, "bf16")
    assert int((args[3][1:] - args[3][:-1]).max()) > 1
    out = {}
    for segment, merges in ((10**6, 0), (1, 1)):
        before = scan_kernel.LAUNCHES, scan_kernel.MERGE_LAUNCHES, scan_kernel.SPLIT_LAUNCHES
        out[segment] = _split_kernel(args, plan, store, 16, 128, "bf16", segment)
        assert (scan_kernel.LAUNCHES - before[0], scan_kernel.MERGE_LAUNCHES - before[1],
                scan_kernel.SPLIT_LAUNCHES - before[2]) == (1, merges, merges)
    assert torch.equal(out[1][0].view(torch.int32), out[10**6][0].view(torch.int32))
    assert torch.equal(out[1][1], out[10**6][1])
