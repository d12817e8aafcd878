"""The port's search against the JAX package's on indices the JAX package
built and saved: same neighbors to the reference's parity bars, in every
precision, across .npz round trips in both directions."""

import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
from learnedmetricindex_tpu.index.serialization import load_index as jax_load_index
from learnedmetricindex_tpu.index.serialization import save_index as jax_save_index
from learnedmetricindex_tpu.ops.knn import exact_knn as jax_exact_knn
from learnedmetricindex_tpu.ops.knn import recall as jax_recall
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall, restricted_knn

torch.set_num_threads(2)

KEYS = {"inference", "search", "search_within_buckets", "seq_search", "sort"}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """1-level [10] and 2-level [3, 2] indices built by the JAX package,
    saved with its save_index and loaded by the port."""
    data, queries = synthetic_blobs(2600, 24, 80, n_clusters=16, seed=11)
    out = {"data": data, "queries": queries}
    for name, cats in (("one", [10]), ("two", [3, 2])):
        cfg = jlmi.BuildConfiguration("kmeans", 10, "MLP-2", 0.01, cats, seed=11, chunk_size=64)
        jidx, pred, _, _, _ = jlmi.LearnedIndexBuilder(data, cfg).build()
        path = str(tmp_path_factory.mktemp(name) / "index.npz")
        jax_save_index(jidx, path, pred)
        pidx, ppred = lmi.load_index(path, "cpu")
        np.testing.assert_array_equal(ppred, np.asarray(pred))
        out[name] = (jidx, pidx, ppred)
    return out


def _search(idx, data, queries, pred, **kw):
    return idx.search(None, queries, data, queries, pred, **kw)


def _assert_parity(pd, pi, jd, ji):
    """The reference's bar (tests/test_scan_kernel.py:22-30)."""
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    mism = pi != ji
    if mism.any():
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n_buckets", [3, 10])
def test_highest_precision_matches_jax(built, n_buckets):
    jidx, pidx, pred = built["one"]
    data, queries = built["data"], built["queries"]
    jd, ji, _ = _search(jidx, data, queries, pred, n_buckets=n_buckets, k=10, precision="highest")
    pd, pi, t = _search(pidx, data, queries, pred, n_buckets=n_buckets, k=10, precision="highest")
    assert pd.dtype == np.float32 and pi.dtype == np.uint32 and pd.shape == (80, 10)
    _assert_parity(pd, pi, np.asarray(jd), np.asarray(ji))
    _, gt = jax_exact_knn(data, queries, k=10)
    assert recall(pi, gt, 10) == jax_recall(np.asarray(ji), gt, 10)
    if n_buckets == 10:
        assert recall(pi, gt, 10) == 1.0
    assert set(t) == KEYS


def test_default_precision_matches_jax(built):
    """bf16 bulk scan + exact rerank: the bar of tests/test_device_plan.py:71-88."""
    jidx, pidx, pred = built["one"]
    data, queries = built["data"], built["queries"]
    jd, ji, _ = _search(jidx, data, queries, pred, n_buckets=4, k=10)
    pd, pi, _ = _search(pidx, data, queries, pred, n_buckets=4, k=10)
    np.testing.assert_allclose(pd, np.asarray(jd), atol=3e-3)
    same = (np.sort(pi, axis=1) == np.sort(np.asarray(ji), axis=1)).mean()
    assert same > 0.99


def test_int8_precision_matches_dequantized_oracle(built):
    """precision='int8' (int8 x int8 bulk + exact rerank) returns the exact
    top-k over the dequantized corpus at full visit, and the JAX
    package's int8 search neighbors."""
    jidx, pidx, pred = built["one"]
    data, queries = built["data"], built["queries"]
    bucket_ids = pidx.bucket_ids_from_prediction(pred)
    store = BucketStore.build_packed_int8(data, bucket_ids, 10, chunk=64, device="cpu")
    jstore = JaxStore.build_packed_int8(data, bucket_ids, 10, chunk=64)
    deq = store.chunk_data.float() * store.chunk_scales[:, None]
    ids = store.chunk_ids.reshape(-1).numpy()
    corpus = np.zeros_like(data)
    corpus[ids[ids > 0] - 1] = deq.numpy()[ids > 0]
    ref_d, gt = exact_knn(corpus, queries, k=10, device="cpu")

    pd, pi, _ = _search(pidx, None, queries, pred, n_buckets=10, k=10, store=store, precision="int8")
    assert recall(pi, gt, 10) == 1.0
    np.testing.assert_allclose(pd, ref_d, rtol=1e-5, atol=1e-6)
    jd, ji, _ = _search(jidx, None, queries, pred, n_buckets=4, k=10, store=jstore, precision="int8")
    pd, pi, _ = _search(pidx, None, queries, pred, n_buckets=4, k=10, store=store, precision="int8")
    _assert_parity(pd, pi, np.asarray(jd), np.asarray(ji))


def test_int8_precision_requires_int8_store(built):
    _, pidx, pred = built["one"]
    with pytest.raises(ValueError, match="int8"):
        _search(pidx, built["data"], built["queries"][:5], pred, n_buckets=2, precision="int8")


def test_empty_batch_and_measured_keys(built):
    _, pidx, pred = built["one"]
    d, i, t = _search(pidx, built["data"], built["queries"][:0], pred, n_buckets=3, k=7)
    assert d.shape == (0, 7) and d.dtype == np.float32
    assert i.shape == (0, 7) and i.dtype == np.uint32
    assert set(t) == KEYS and all(v == 0.0 for v in t.values())
    d, i, t = _search(pidx, built["data"], built["queries"][:1], pred, n_buckets=3, k=7)
    assert d.shape == (1, 7) and set(t) == KEYS and t["search"] > 0


def test_two_level_joint_search_matches_jax(built):
    jidx, pidx, pred = built["two"]
    data, queries = built["data"], built["queries"]
    jd, ji, _ = _search(jidx, data, queries, pred, n_buckets=3, k=10,
                        policy="joint", precision="highest")
    pd, pi, _ = _search(pidx, data, queries, pred, n_buckets=3, k=10,
                        policy="joint", precision="highest")
    _assert_parity(pd, pi, np.asarray(jd), np.asarray(ji))


def test_npz_round_trip_port_to_jax(built, tmp_path):
    """An index the port saves loads in the JAX package and searches the
    same; reloaded into the port it is unchanged."""
    jidx, pidx, pred = built["one"]
    data, queries = built["data"], built["queries"]
    path = str(tmp_path / "port.npz")
    lmi.save_index(pidx, path, pred)
    jidx2, jpred2 = jax_load_index(path)
    np.testing.assert_array_equal(np.asarray(jpred2), pred)
    assert jidx2.config.to_dict() == jidx.config.to_dict()
    jd, ji, _ = _search(jidx2, data, queries, pred, n_buckets=3, k=10, precision="highest")
    pd, pi, _ = _search(pidx, data, queries, pred, n_buckets=3, k=10, precision="highest")
    _assert_parity(pd, pi, np.asarray(jd), np.asarray(ji))
    pidx2, _ = lmi.LearnedIndex.load(path, "cpu")
    for a, b in zip(pidx.levels[0].mlp.parameters(), pidx2.levels[0].mlp.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(pidx.levels[0].class_mask, pidx2.levels[0].class_mask)


@pytest.mark.parametrize("metric", ["inner_product", "l2"])
def test_exact_knn_matches_jax(built, metric):
    data, queries = built["data"], built["queries"]
    jd, ji = jax_exact_knn(data, queries, k=10, metric=metric, tile_rows=500)
    pd, pi = exact_knn(data, queries, k=10, metric=metric, tile_rows=700, device="cpu")
    assert pi.dtype == np.uint32
    _assert_parity(pd, pi, jd, ji)
    assert recall(pi, ji, 10) == jax_recall(pi, ji, 10) == 1.0
    assert recall(pi[:, ::-1], ji, 5) == jax_recall(pi[:, ::-1], ji, 5)


def test_exact_knn_needs_a_device_for_host_data(built):
    """Host data does not pick a device; a tensor stays on its own."""
    data, queries = built["data"], built["queries"]
    with pytest.raises(ValueError, match="device"):
        exact_knn(data, queries, k=10)
    td, ti = exact_knn(torch.as_tensor(data), queries, k=10)
    hd, hi = exact_knn(data, queries, k=10, device="cpu")
    np.testing.assert_array_equal(td, hd)
    np.testing.assert_array_equal(ti, hi)


def test_restricted_knn_is_the_visited_bucket_ceiling(built):
    _, pidx, pred = built["one"]
    data, queries = built["data"], built["queries"]
    store = pidx.get_bucket_store(data, pred)
    order, _ = pidx.compute_bucket_order(queries, 3, keep_on_device=True)
    rd, ri = restricted_knn(store, torch.as_tensor(queries), order, 10, slab_rows=500)
    pd, pi, _ = _search(pidx, data, queries, pred, n_buckets=3, k=10, precision="highest")
    _assert_parity(pd, pi, rd.numpy(), ri.numpy())
    full = torch.arange(10).repeat(len(queries), 1)
    fd, fi = restricted_knn(store, torch.as_tensor(queries), full, 10)
    gd, gi = exact_knn(data, queries, k=10, device="cpu")
    _assert_parity(fd.numpy(), fi.numpy(), gd, gi)


@pytest.mark.parametrize("k", [30, 100, 300])
def test_wide_k_matches_jax(built, k):
    """k=30 (SISAP 2024), k=100 and k=300 scan k + 6 candidates per pair,
    past the old 32- and 256-wide kernel lists (k_scan 306 takes list
    width 512); the port equals the JAX package."""
    jidx, pidx, pred = built["one"]
    data, queries = built["data"], built["queries"]
    jd, ji, _ = _search(jidx, data, queries, pred, n_buckets=3, k=k, precision="highest")
    pd, pi, _ = _search(pidx, data, queries, pred, n_buckets=3, k=k, precision="highest")
    assert pd.shape == (len(queries), k)
    _assert_parity(pd, pi, np.asarray(jd), np.asarray(ji))
    _, gt = jax_exact_knn(data, queries, k=k)
    assert recall(pi, gt, k) == jax_recall(np.asarray(ji), gt, k)
    dd, di, _ = _search(pidx, data, queries, pred, n_buckets=3, k=k)  # default precision
    assert (np.sort(di, axis=1) == np.sort(pi, axis=1)).mean() > 0.99
