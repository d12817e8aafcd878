"""The CUDA kernels (bucket scan, row gather) against their plain
PyTorch versions, and the port's search and build on the GPU.

These need an NVIDIA GPU (sm_90a) and nvcc and skip elsewhere.  The file
imports no jax, so on a machine with a GPU and no jax it runs alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, build_plan, scan_inputs
from learnedmetricindex_tpu_torch.index.serialization import index_from_arrays
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.ops import gather_kernel, quantize, scan_kernel

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
    """bf16 over every store type and int8, at k 16/36/64/256 (every list
    width) with qtile 1/8/100/128 in turn, at d 768, 96 and 100 (rows not
    16-byte aligned and a depth tail)."""
    combos = [("bf16", "float32"), ("bf16", "bfloat16"), ("bf16", "int8"), ("int8", "int8")]
    qtiles = (1, 8, 100, 128)
    return [(mode, store, k, qtiles[(ki + ci) % 4], d)
            for d in (768, 96, 100)
            for ki, k in enumerate((16, 36, 64, 256))
            for ci, (mode, store) in enumerate(combos)]


@pytest.mark.parametrize(
    "mode,store_dtype,k,qtile,d",
    [(m, s, k, q, 64) for m, s, k, q in [
        ("f32", "float32", 12, 128), ("f32", "int8", 24, 8), ("bf16", "bfloat16", 16, 16),
        ("bf16", "int8", 10, 128), ("int8", "int8", 24, 16), ("int8", "int8", 16, 128),
        # list widths past 32; k 256 splits a pair's queries over two blocks
        ("f32", "float32", 36, 128), ("bf16", "int8", 36, 16), ("int8", "int8", 36, 8),
        ("f32", "bfloat16", 64, 16), ("bf16", "bfloat16", 64, 128), ("int8", "int8", 64, 128),
        ("f32", "float32", 256, 100), ("bf16", "int8", 256, 128), ("int8", "int8", 256, 16)]]
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


def test_kernel_rejects_what_it_does_not_take(cuda):
    store = BucketStore.build(np.ones((64, 6), np.float32), np.zeros(64, int), 1, chunk=32,
                              device=cuda)
    plan = build_plan(torch.zeros((4, 1), dtype=torch.int64, device=cuda), 1, 8)
    q8, qs = quantize.quantize_rows(torch.ones((4, 6), device=cuda))
    args = (q8, plan.qidx, plan.pair_bucket,
            torch.as_tensor(store.bucket_chunk_start, dtype=torch.int32, device=cuda),
            torch.arange(store.n_chunks, dtype=torch.int32, device=cuda),
            store.chunk_data.to(torch.int8), store.scales_flat(), qs)
    with pytest.raises(ValueError, match="d % 4"):
        scan_kernel.scan_pairs(*args, k=4, qtile=8, chunk=32, mode="int8")
    with pytest.raises(ValueError, match="device"):
        scan_kernel.scan_pairs(*(a.cpu() if i == 0 else a for i, a in enumerate(args)),
                               k=4, qtile=8, chunk=32, mode="int8")


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
        before = gather_kernel.LAUNCHES
        out[mode] = index.search(None, data[:300], None, data[:300], pred, n_buckets=3, k=30,
                                 store=store, precision=precision)[:2]
        launched = gather_kernel.LAUNCHES - before
        assert launched == (3 if mode == "kernel" else 0)
    np.testing.assert_array_equal(out["auto"][0].view(np.uint32), out["kernel"][0].view(np.uint32))
    np.testing.assert_array_equal(out["auto"][1], out["kernel"][1])


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
