"""Bucket-sharded search against the JAX package's (the cases of
tests/test_sharded_index.py): the same bucket assignment and sub-store
layouts at 2, 4 and 8 devices, the same neighbours as the JAX package's
``sharded_search`` on its 4-device CPU mesh, as the single store and as
exact kNN.  The port's shards are a device list; here every shard is on
``"cpu"``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index import mutation as jmut
from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
from learnedmetricindex_tpu.index.serialization import save_index as jax_save_index
from learnedmetricindex_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from learnedmetricindex_tpu.parallel import mesh as jmesh
from learnedmetricindex_tpu.parallel import sharded_index as jsh
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.index import mutation as pmut
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_buckets_device
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall
from learnedmetricindex_tpu_torch.parallel import (
    ShardedStore,
    create_mesh,
    data_model_axes,
    shard_packed_store,
    shard_store,
    sharded_search,
)
from learnedmetricindex_tpu_torch.serve import SearchServer
from test_torch_cuda import _shuffled  # a store with its chunks moved

torch.set_num_threads(2)
pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

NB, CHUNK = 13, 32


@pytest.fixture(scope="module")
def setup():
    """tests/test_sharded_index.py's fixture: 1200×16 blobs in 13 random
    buckets, chunk 32."""
    data, queries = synthetic_blobs(1200, 16, 50, n_clusters=10, seed=7)
    bucket_ids = np.random.default_rng(1).integers(0, NB, size=1200)
    return data, queries, bucket_ids


def _cpus(n):
    return [torch.device("cpu")] * n


def _parity(pd, pi, jd, ji):
    """The reference's bar (tests/test_scan_kernel.py:22-30)."""
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    mism = pi != ji
    if mism.any():
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)


def _partial_order(seed, Q=50, V=4):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(NB, size=V, replace=False) for _ in range(Q)]).astype(np.int64)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_assignment_and_layout_bit_equal_to_jax(setup, n_dev):
    """bucket_device and bucket_local equal the JAX shard_store's; each
    shard's id grid, CSR and slabs are the JAX store's device slice
    without its padding to the widest device."""
    data, _, bucket_ids = setup
    jstore = jsh.shard_store(data, bucket_ids, NB, jmesh.create_mesh(n_dev), chunk=CHUNK)
    store = shard_store(data, bucket_ids, NB, _cpus(n_dev), chunk=CHUNK)
    assert isinstance(store, ShardedStore) and len(store.shards) == n_dev
    np.testing.assert_array_equal(store.bucket_device, jstore.bucket_device)
    np.testing.assert_array_equal(store.bucket_local, jstore.bucket_local)
    j_ids, j_data = np.asarray(jstore.chunk_ids), np.asarray(jstore.chunk_data)
    for i, (shard, sub) in enumerate(zip(store.shards, jstore.sub_stores)):
        np.testing.assert_array_equal(shard.bucket_chunk_start, sub.bucket_chunk_start)
        np.testing.assert_array_equal(shard.bucket_sizes, sub.bucket_sizes)
        c = shard.n_chunks
        np.testing.assert_array_equal(shard.chunk_ids.numpy(), j_ids[i, :c])
        assert (j_ids[i, c:] == 0).all()
        np.testing.assert_array_equal(shard.chunk_data.numpy(), j_data[i, : c * CHUNK])
    assert store.n_chunks == max(s.n_chunks for s in store.shards) and store.dim == 16
    ids = np.concatenate([s.chunk_ids.numpy().reshape(-1) for s in store.shards])
    np.testing.assert_array_equal(np.sort(ids[ids > 0]), np.arange(1, 1201))


@pytest.mark.parametrize("precision,rerank,k", [("highest", False, 6), ("default", True, 10)])
def test_sharded_search_matches_jax_on_a_4_device_mesh(setup, precision, rerank, k):
    """The port's sharded_search over 4 shards against the JAX package's
    on its 4-device CPU mesh, at a partial visit with some queries
    visiting nothing: "highest" without rerank to the parity bar;
    "default" with rerank (bf16 scan, exact rerank a shard) to the bf16
    bar, atol 3e-3 and 99% of the ids."""
    data, queries, bucket_ids = setup
    order = _partial_order(5)
    order[5:9] = -1
    jstore = jsh.shard_store(data, bucket_ids, NB, jmesh.create_mesh(4), chunk=CHUNK)
    store = shard_store(data, bucket_ids, NB, _cpus(4), chunk=CHUNK)
    kw = dict(k=k, precision=precision, rerank=rerank)
    jd, ji = jsh.sharded_search(jstore, queries, order, **kw)
    pd, pi = sharded_search(store, queries, order, **kw)
    assert pd.dtype == np.float32 and pi.dtype == np.uint32 and pd.shape == (50, k)
    assert np.isinf(pd[5:9]).all() and (pi[5:9] == 0).all()
    if precision == "highest":
        _parity(pd, pi, jd, ji)
    else:
        np.testing.assert_allclose(pd, jd, atol=3e-3)
        assert (np.sort(pi, axis=1) == np.sort(ji, axis=1)).mean() >= 0.99


@pytest.mark.parametrize("precision,rerank", [("highest", False), ("default", True)])
def test_sharded_full_visit_equals_exact(setup, precision, rerank):
    data, queries, bucket_ids = setup
    store = shard_store(data, bucket_ids, NB, _cpus(8), chunk=CHUNK)
    order = np.tile(np.arange(NB, dtype=np.int64), (50, 1))
    dists, ids = sharded_search(store, queries, order, k=10, precision=precision, rerank=rerank)
    ref_d, ref_i = exact_knn(data, queries, k=10, device="cpu")
    np.testing.assert_allclose(dists, ref_d, rtol=1e-4, atol=1e-5)
    assert recall(ids, ref_i, 10) == 1.0


@pytest.mark.parametrize("n_dev", [1, 3])
def test_sharded_equals_the_single_store(setup, n_dev):
    data, queries, bucket_ids = setup
    order = _partial_order(6)
    store = shard_store(data, bucket_ids, NB, _cpus(n_dev), chunk=CHUNK)
    dists, ids = sharded_search(store, queries, order, k=6)
    single = BucketStore.build(data, bucket_ids, NB, chunk=CHUNK, device="cpu")
    ref_d, ref_i = scan_buckets_device(single, torch.as_tensor(queries), torch.as_tensor(order),
                                       k=6, qtile=16, precision="highest", rerank=False)
    _parity(dists, ids, ref_d.numpy(), ref_i.numpy().astype(np.uint32))


def test_sharded_search_with_invalid_slots(setup):
    data, queries, bucket_ids = setup
    store = shard_store(data, bucket_ids, NB, _cpus(8), chunk=CHUNK)
    order = np.full((50, 3), -1, dtype=np.int64)
    order[0, 0] = 2
    dists, ids = sharded_search(store, queries, order, k=5)
    assert np.isfinite(dists[0]).all()
    assert np.isinf(dists[1:]).all() and (ids[1:] == 0).all()


def test_sharded_int8_stays_int8_and_matches_the_dequantized_oracle():
    """An int8 corpus stays int8 a shard (slab bytes within one chunk a
    shard of the single store's) and, with rerank, finds the exact top-10
    over the dequantized corpus, as in the JAX package."""
    data, queries = synthetic_blobs(2048, 16, 40, n_clusters=10, seed=9)
    n_buckets, chunk = 16, 32
    bucket_ids = np.arange(2048) % n_buckets
    q_data, row_scales = (np.array(a) for a in jax_quantize_rows(data))
    store = shard_store(q_data, bucket_ids, n_buckets, _cpus(8), chunk=chunk,
                        row_scales=row_scales)
    assert all(s.chunk_data.dtype == torch.int8 for s in store.shards)
    single = BucketStore.build(q_data.astype(np.float32), bucket_ids, n_buckets, chunk=chunk,
                               dtype="int8", device="cpu")
    slab = sum(s.chunk_data.numel() for s in store.shards)
    assert slab <= single.chunk_data.numel() + 8 * chunk * 16
    deq = q_data.astype(np.float32) * row_scales[:, None]
    order = np.tile(np.arange(n_buckets, dtype=np.int64), (len(queries), 1))
    ref_d, ref_i = exact_knn(deq, queries, k=10, device="cpu")
    for precision, rerank in (("highest", False), ("default", True)):
        dists, ids = sharded_search(store, queries, order, k=10, precision=precision,
                                    rerank=rerank)
        np.testing.assert_allclose(dists, ref_d, rtol=1e-4, atol=1e-5)
        assert recall(ids, ref_i, 10) >= 0.999
    jstore = jsh.shard_store(q_data, bucket_ids, n_buckets, jmesh.create_mesh(8), chunk=chunk,
                             row_scales=row_scales)
    jd, ji = jsh.sharded_search(jstore, queries, order, k=10)
    pd, pi = sharded_search(store, queries, order, k=10)
    _parity(pd, pi, jd, ji)


def test_sharded_store_from_a_tensor_corpus(setup):
    """A tensor corpus builds the same shards as a host one (gathered where
    it lies) and searches identically."""
    data, queries, bucket_ids = setup
    host = shard_store(data, bucket_ids, NB, _cpus(4), chunk=CHUNK)
    dev = shard_store(torch.as_tensor(data), bucket_ids, NB, _cpus(4), chunk=CHUNK)
    for a, b in zip(host.shards, dev.shards):
        assert torch.equal(a.chunk_ids, b.chunk_ids) and torch.equal(a.chunk_data, b.chunk_data)
    order = np.tile(np.arange(NB, dtype=np.int64), (50, 1))
    d1, i1 = sharded_search(dev, queries, order, k=8)
    d2, i2 = sharded_search(host, queries, order, k=8)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)


def test_shard_packed_store_of_a_mutated_store(setup):
    """A store after inserts and deletes (the same in both packages), its
    chunks moved out of physical order in the port's copy: its sharded
    form finds the same neighbours as the store itself and as the JAX
    package's shard_packed_store of its store; the fill travels."""
    data, queries, bucket_ids = setup
    extra, _ = synthetic_blobs(300, 16, 1, n_clusters=10, seed=8)
    extra_b = np.random.default_rng(2).integers(0, NB, 300)
    gone = np.random.default_rng(3).choice(np.arange(1, 1501), 200, replace=False)
    jstore = JaxStore.build(data, bucket_ids, NB, chunk=CHUNK)
    jstore = jmut.insert_rows(jstore, extra, extra_b, np.arange(1201, 1501))
    jstore, _ = jmut.delete_ids(jstore, gone)
    store = BucketStore.build(data, bucket_ids, NB, chunk=CHUNK, device="cpu")
    store = pmut.insert_rows(store, extra, extra_b, np.arange(1201, 1501))
    store, n_del = pmut.delete_ids(store, gone)
    assert n_del == 200
    store = _shuffled(store, 4)
    sharded = shard_packed_store(store, _cpus(4))
    jsharded = jsh.shard_packed_store(jstore, jmesh.create_mesh(4))
    np.testing.assert_array_equal(sharded.bucket_device, jsharded.bucket_device)
    for shard, sub in zip(sharded.shards, jsharded.sub_stores):
        np.testing.assert_array_equal(shard.bucket_fill, sub.bucket_fill)
    order = _partial_order(7)
    pd, pi = sharded_search(sharded, queries, order, k=10)
    sd, si = scan_buckets_device(store, torch.as_tensor(queries), torch.as_tensor(order), k=10,
                                 qtile=16, precision="highest", rerank=False)
    _parity(pd, pi, sd.numpy(), si.numpy().astype(np.uint32))
    jd, ji = jsh.sharded_search(jsharded, queries, order, k=10)
    _parity(pd, pi, jd, ji)
    assert not set(pi[pi > 0].tolist()) & set(gone.tolist())
    with pytest.raises(ValueError, match="packed"):
        shard_packed_store(BucketStore.build_virtual(torch.as_tensor(data), bucket_ids, NB,
                                                     chunk=CHUNK), _cpus(2))


def test_sharded_search_rejects_int8_precision(setup):
    data, queries, bucket_ids = setup
    store = shard_store(data, bucket_ids, NB, _cpus(2), chunk=CHUNK)
    order = np.tile(np.arange(4, dtype=np.int64), (50, 1))
    with pytest.raises(ValueError, match="precision"):
        sharded_search(store, queries, order, k=5, precision="int8")


@pytest.fixture(scope="module")
def built(tmp_path_factory, setup):
    data, queries, _ = setup
    cfg = jlmi.BuildConfiguration("kmeans", 10, "MLP-2", 0.01, [8], seed=3, chunk_size=64)
    jidx, pred, _, _, _ = jlmi.LearnedIndexBuilder(data, cfg).build()
    path = str(tmp_path_factory.mktemp("sharded") / "index.npz")
    jax_save_index(jidx, path, pred)
    pidx, ppred = lmi.load_index(path, "cpu")
    return jidx, pidx, np.asarray(ppred)


def test_index_search_routes_a_sharded_store(setup, built):
    """LearnedIndex.get_sharded_store + search(store=...) against the JAX
    package's (chunk min(64, 256) = 64 off the TPU, default precision with
    rerank); the one-entry cache keeps sharded, virtual and packed stores
    apart."""
    data, queries, _ = setup
    jidx, pidx, pred = built
    jstore = jidx.get_sharded_store(data, pred, jmesh.create_mesh(4))
    store = pidx.get_sharded_store(data, pred, _cpus(4))
    assert store.chunk == jstore.chunk == 64
    np.testing.assert_array_equal(store.bucket_device, jstore.bucket_device)
    jd, ji, _ = jidx.search(None, queries, data, queries, pred, n_buckets=3, k=10, store=jstore)
    pd, pi, measured = pidx.search(None, queries, data, queries, pred, n_buckets=3, k=10,
                                   store=store)
    np.testing.assert_allclose(pd, np.asarray(jd), atol=3e-3)
    assert (np.sort(pi, axis=1) == np.sort(np.asarray(ji), axis=1)).mean() >= 0.99
    sd, si, _ = pidx.search(None, queries, data, queries, pred, n_buckets=3, k=10,
                            precision="highest")
    hd, hi, _ = pidx.search(None, queries, data, queries, pred, n_buckets=3, k=10,
                            precision="highest", store=store)
    _parity(hd, hi, sd, si)
    corpus = torch.as_tensor(data)
    sharded = pidx.get_sharded_store(corpus, pred, _cpus(4))
    assert pidx.get_sharded_store(corpus, pred, _cpus(4)) is sharded
    virtual = pidx.get_bucket_store(corpus, pred)
    assert isinstance(virtual, BucketStore) and virtual.virtual
    assert pidx.get_bucket_store(corpus, pred) is virtual
    two = pidx.get_sharded_store(corpus, pred, _cpus(2))
    assert isinstance(two, ShardedStore) and len(two.shards) == 2


def test_search_server_serves_a_sharded_store(setup, built):
    data, queries, _ = setup
    _, pidx, pred = built
    store = pidx.get_sharded_store(data, pred, _cpus(3))
    with SearchServer(pidx, store, k=10, n_buckets=3, warmup=False) as server:
        assert server.d == 16
        sd, si = server.search(queries[:20])
        assert server.stats()["engine"] == "plain"
        with pytest.raises(ValueError, match="immutable"):
            server.delete([1])
    d, i, _ = pidx.search(None, queries[:20], None, queries[:20], pred, n_buckets=3, k=10,
                          store=store)
    np.testing.assert_array_equal(si, i)
    np.testing.assert_array_equal(sd, d)


def test_create_mesh_and_axes():
    """create_mesh lists the first n devices of a type and raises if there
    are fewer; data_model_axes is the JAX package's arithmetic."""
    assert create_mesh(device_type="cpu") == [torch.device("cpu")]
    assert create_mesh(1, "cpu") == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="need 2 cpu devices"):
        create_mesh(2, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            create_mesh(1)
    with pytest.raises(ValueError, match="device_type"):
        create_mesh(1, "tpu")
    for n in range(1, 17):
        assert data_model_axes(n) == jmesh.data_model_axes(n)
    assert data_model_axes(8, 2) == jmesh.data_model_axes(8, 2) == (4, 2)


def test_sharded_search_takes_the_engine_keyword(setup):
    """``engine`` in the JAX signature's place (after ``precision``),
    accepted and changing nothing."""
    data, queries, bucket_ids = setup
    order = _partial_order(6)
    store = shard_store(data, bucket_ids, NB, _cpus(2), chunk=CHUNK)
    d0, i0 = sharded_search(store, queries, order, 6)
    d1, i1 = sharded_search(store, queries, order, 6, 128, "highest", "auto", False, 6)
    d2, i2 = sharded_search(store, queries, order, k=6, engine="pallas")
    for d, i in ((d1, i1), (d2, i2)):
        np.testing.assert_array_equal(d0, d)
        np.testing.assert_array_equal(i0, i)
