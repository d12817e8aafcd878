"""Mutation over a store sharded by bucket over a device list, against the
JAX package's (the cases of tests/test_sharded_mutation.py): the same
index (the JAX build, loaded into the port through ``.npz``, so the
routers are the same), the same inserts, deletes and compactions, and
after every step each global bucket holds the same live (id, row bytes,
scale) set in both packages, on the same shard, and searches agree to
the reference's bar.  Physical slots may differ: the JAX package grows
one chunk axis common to its shards, the port grows each shard on its
own.  Then the server over a ``ShardedDynamicIndex``, in process and as
``serve.main --shard-devices 4 --dynamic`` over real sockets."""

import jax
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index.serialization import save_index as jax_save_index
from learnedmetricindex_tpu.parallel.mesh import create_mesh as jax_create_mesh
from learnedmetricindex_tpu.parallel.sharded_index import shard_packed_store as jax_shard_packed
from learnedmetricindex_tpu.parallel.sharded_mutation import (
    ShardedDynamicIndex as JaxShardedDynamicIndex,
)
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall
from learnedmetricindex_tpu_torch.parallel import ShardedDynamicIndex, shard_packed_store
from learnedmetricindex_tpu_torch.serve import SearchServer
from test_torch_serve import _post, _serve_main

torch.set_num_threads(2)
pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

CPUS = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """tests/test_sharded_mutation.py's fixture (3000×24, 12 buckets,
    MLP-2, chunk 64), built by the JAX package and loaded into the port."""
    data, queries = synthetic_blobs(3000, 24, 60, n_clusters=16, seed=2023)
    extra, _ = synthetic_blobs(400, 24, 1, n_clusters=16, seed=77)
    cfg = jlmi.BuildConfiguration("kmeans", 40, "MLP-2", 0.01, [12], seed=2023, chunk_size=64)
    jidx, pred, n_buckets, _, _ = jlmi.LearnedIndexBuilder(data, cfg).build()
    path = str(tmp_path_factory.mktemp("shmut") / "index.npz")
    jax_save_index(jidx, path, pred)
    pidx, ppred = lmi.load_index(path, "cpu")
    return data, queries, extra, jidx, pidx, np.asarray(ppred), n_buckets


def _pair(b):
    data, _, _, jidx, pidx, pred, _ = b
    j = JaxShardedDynamicIndex.from_built(jidx, data, pred, mesh=jax_create_mesh(8), chunk=64)
    p = ShardedDynamicIndex.from_built(pidx, data, pred, CPUS, chunk=64)
    return j, p


def _live(ids, data, scales, ptr, clist, chunk, local):
    """The live (ids, rows, scales) of one local bucket, by id."""
    slots = (np.asarray(clist[ptr[local]:ptr[local + 1]], np.int64)[:, None] * chunk
             + np.arange(chunk)).reshape(-1)
    slots = slots[ids[slots] > 0]
    order = np.argsort(ids[slots])
    slots = slots[order]
    return ids[slots], data[slots], scales[slots]


def _assert_same_contents(jdyn, pdyn):
    """Each global bucket's live (id, row bytes, scale) set is equal, on
    the same shard; the id → shard maps agree."""
    js, ps = jdyn.sharded, pdyn.sharded
    np.testing.assert_array_equal(ps.bucket_device, js.bucket_device)
    np.testing.assert_array_equal(ps.bucket_local, js.bucket_local)
    j_ids, j_data, j_sc = (np.asarray(a) for a in (js.chunk_ids, js.chunk_data, js.chunk_scales))
    chunk = ps.chunk
    total = 0
    for dev, (shard, sub) in enumerate(zip(ps.shards, js.sub_stores)):
        p_ptr, p_list = shard.chunk_list()
        p_ids = shard.chunk_ids.reshape(-1).numpy()
        p_data = shard.chunk_data.numpy()
        p_sc = (np.ones(len(p_ids), np.float32) if shard.chunk_scales is None
                else shard.chunk_scales.numpy())
        j_ptr, j_list = sub.bucket_chunk_ptr, sub.bucket_chunk_list
        for local in range(shard.n_buckets):
            a = _live(p_ids, p_data, p_sc, p_ptr, p_list, chunk, local)
            b = _live(j_ids[dev].reshape(-1), j_data[dev], j_sc[dev], j_ptr, j_list, chunk, local)
            for x, y, what in zip(a, b, ("ids", "rows", "scales")):
                np.testing.assert_array_equal(x, y, err_msg=f"shard {dev} bucket {local}: {what}")
            total += len(a[0])
        np.testing.assert_array_equal(shard.bucket_sizes, sub.bucket_sizes)
    assert total == pdyn.n_rows == jdyn.n_rows
    live = np.nonzero(pdyn._id_shard >= 0)[0] + 1
    shard, slot = pdyn.locate(live)
    np.testing.assert_array_equal(shard, jdyn._id_dev[live - 1])
    for i, st in enumerate(pdyn.sharded.shards):
        np.testing.assert_array_equal(st.chunk_ids.reshape(-1).numpy()[slot[shard == i]],
                                      live[shard == i])


def _parity(pd, pi, jd, ji):
    """The reference's bar (tests/test_scan_kernel.py:22-30)."""
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    mism = pi != ji
    if mism.any():
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)


def _same(jdyn, pdyn, queries, n_buckets):
    """Contents equal and searches at the parity bar; returns the port's."""
    _assert_same_contents(jdyn, pdyn)
    kw = dict(n_buckets=n_buckets, k=10, precision="highest", rerank=False)
    pd, pi, _ = pdyn.search(queries, **kw)
    jd, ji, _ = jdyn.search(queries, **kw)
    _parity(pd, pi, np.asarray(jd), np.asarray(ji))
    return pd, pi


def _oracle_ids(corpus, queries, k=10):
    return exact_knn(corpus, queries, k=k, device="cpu")[1]


def test_insert_then_full_visit_is_exact(built):
    data, queries, extra, _, pidx, _, _ = built
    jdyn, dyn = _pair(built)
    assert dyn.n_rows == len(data) and len(dyn.sharded.shards) == 8
    _same(jdyn, dyn, queries, pidx.n_buckets)
    ids = dyn.insert(extra)
    np.testing.assert_array_equal(jdyn.insert(extra), ids)
    np.testing.assert_array_equal(ids, np.arange(len(data) + 1, len(data) + len(extra) + 1))
    assert dyn.n_rows == len(data) + len(extra)
    dists, nns = _same(jdyn, dyn, queries, pidx.n_buckets)
    corpus = np.concatenate([data, extra])
    assert recall(nns, _oracle_ids(corpus, queries), 10) == 1.0
    ref_d, _ = exact_knn(corpus, queries, k=10, device="cpu")
    np.testing.assert_allclose(dists, ref_d, rtol=1e-4, atol=1e-5)
    d2, n2, _ = dyn.search(extra[:16], n_buckets=pidx.n_buckets, k=1)
    np.testing.assert_array_equal(n2[:, 0], ids[:16])
    np.testing.assert_allclose(d2[:, 0], 0.0, atol=1e-4)
    # a tensor batch routes and lands like a host one
    more = dyn.insert(torch.as_tensor(extra[:5]))
    np.testing.assert_array_equal(jdyn.insert(extra[:5]), more)
    _same(jdyn, dyn, queries, 3)


def test_delete_then_compact_is_bit_identical(built):
    data, queries, extra, _, pidx, _, _ = built
    jdyn, dyn = _pair(built)
    ids = dyn.insert(extra)
    jdyn.insert(extra)
    victims = np.concatenate([ids[::3], np.arange(1, 301)])
    n_del = dyn.delete(victims)
    assert n_del == jdyn.delete(victims) == len(ids[::3]) + 300
    assert dyn.delete(victims) == 0  # idempotent
    d1, n1 = _same(jdyn, dyn, queries, pidx.n_buckets)
    keep = np.ones(len(data) + len(extra), bool)
    keep[victims - 1] = False
    live_ids = np.nonzero(keep)[0] + 1
    gt = live_ids[_oracle_ids(np.concatenate([data, extra])[keep], queries) - 1]
    assert recall(n1, gt, 10) == 1.0
    assert not np.isin(n1, victims).any()

    stats = dyn.compact()
    jdyn.compact()
    assert stats["chunks_after"] < stats["chunks_before"]
    d2, n2 = _same(jdyn, dyn, queries, pidx.n_buckets)
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(d1.view(np.uint32), d2.view(np.uint32))
    for shard in dyn.sharded.shards:  # every shard repacked: the identity list, no holes
        ptr, clist = shard.chunk_list()
        np.testing.assert_array_equal(clist, np.arange(len(clist)))

    more = dyn.insert(extra[:10])
    np.testing.assert_array_equal(jdyn.insert(extra[:10]), more)
    assert more.min() > ids.max()
    d3, n3, _ = dyn.search(extra[:10], n_buckets=pidx.n_buckets, k=1)
    assert np.isin(n3[:, 0], np.concatenate([ids[:10], more])).all()
    np.testing.assert_allclose(d3[:, 0], 0.0, atol=1e-4)
    _same(jdyn, dyn, queries, 4)


def test_overflow_grows_the_shards(built):
    """Inserting far past the initial capacity grows the shards that run
    out (each on its own; the JAX package grows its common axis) and
    stays exact."""
    data, queries, _, _, pidx, _, _ = built
    jdyn, dyn = _pair(built)
    before = [s.n_chunks for s in dyn.sharded.shards]
    rng = np.random.default_rng(5)
    big = data[rng.integers(0, len(data), 4000)] + rng.normal(
        0, 0.01, (4000, data.shape[1])).astype(np.float32)
    ids = dyn.insert(big)
    jdyn.insert(big)
    after = [s.n_chunks for s in dyn.sharded.shards]
    assert all(a >= b for a, b in zip(after, before)) and sum(after) > sum(before)
    _, nns = _same(jdyn, dyn, queries[:20], pidx.n_buckets)
    corpus = np.concatenate([data, big])
    assert recall(nns, _oracle_ids(corpus, queries[:20]), 10) == 1.0
    assert ids.max() == len(corpus)


def test_insert_validation_surface(built):
    """The JAX package's errors, raised by both packages."""
    _, _, extra, _, _, _, _ = built
    jdyn, dyn = _pair(built)
    cases = [
        ("1-based", dict(vectors=extra[:2], object_ids=[0, 1])),
        ("length mismatch", dict(vectors=extra[:2], object_ids=[10**6])),
        ("duplicate", dict(vectors=extra[:2], object_ids=[10**6, 10**6])),
        ("already live", dict(vectors=extra[:1], object_ids=[1])),
        ("id-space cap", dict(vectors=extra[:1], object_ids=[1 << 29])),
        ("int32 range", dict(vectors=extra[:1], object_ids=[1 << 31])),
    ]
    for match, kw in cases:
        for which in (dyn, jdyn):
            with pytest.raises(ValueError, match=match):
                which.insert(**kw)
    with pytest.raises(ValueError, match="vectors must be"):
        dyn.insert(extra[:2, :8])
    assert len(dyn.insert(extra[:0])) == 0
    assert dyn.delete([0, -3, 10**7]) == 0
    _assert_same_contents(jdyn, dyn)


def test_randomized_interleaving_matches_model_and_jax(built):
    """Insert / delete / compact interleavings against a dict model and
    the JAX package, step by step (test_sharded_mutation.py's fuzz)."""
    data, queries, _, _, pidx, _, _ = built
    rng = np.random.default_rng(17)
    jdyn, dyn = _pair(built)
    model = {i + 1: data[i] for i in range(len(data))}
    for step in range(6):
        op = rng.choice(["insert", "delete", "compact"])
        if op == "insert":
            m = int(rng.integers(1, 200))
            rows = data[rng.integers(0, len(data), m)] + rng.normal(
                0, 0.02, (m, data.shape[1])).astype(np.float32)
            ids = dyn.insert(rows)
            np.testing.assert_array_equal(jdyn.insert(rows), ids)
            model.update({int(i): r for i, r in zip(ids, rows)})
        elif op == "delete" and len(model) > 400:
            keys = np.fromiter(model.keys(), np.int64)
            victims = rng.choice(keys, int(rng.integers(1, 150)), replace=False)
            assert dyn.delete(victims) == jdyn.delete(victims) == len(set(victims.tolist()))
            for v in victims:
                del model[int(v)]
        else:
            dyn.compact()
            jdyn.compact()
        _, nns = _same(jdyn, dyn, queries[:16], pidx.n_buckets)
        corpus = np.stack(list(model.values()))
        ids = np.fromiter(model.keys(), np.int64)
        assert recall(nns, ids[_oracle_ids(corpus, queries[:16]) - 1], 10) == 1.0
        assert dyn.n_rows == len(model)


def test_shard_packed_store_promotion(built):
    """A mutated single store (pool chunks and delete holes) promoted with
    ``shard_packed_store`` and its ``next_id`` searches as it did, and
    keeps mutating as the JAX package's promoted store does."""
    data, queries, extra, jidx, pidx, pred, _ = built
    dyn1 = lmi.DynamicIndex.from_built(pidx, data, pred, chunk=64)
    jdyn1 = jlmi.DynamicIndex.from_built(jidx, data, pred, chunk=64)
    ids = dyn1.insert(extra)
    jdyn1.insert(extra)
    for victims in (ids[::3], np.arange(1, 200)):
        dyn1.delete(victims)
        jdyn1.delete(victims)
    d1, n1, _ = dyn1.search(queries, n_buckets=pidx.n_buckets, k=10)

    dyn2 = ShardedDynamicIndex(pidx, shard_packed_store(dyn1.store, CPUS), next_id=dyn1.next_id)
    jdyn2 = JaxShardedDynamicIndex(jidx, jax_shard_packed(jdyn1.store, jax_create_mesh(8)),
                                   next_id=jdyn1.next_id)
    assert dyn2.n_rows == dyn1.n_rows and dyn2.next_id == dyn1.next_id
    d2, n2, _ = dyn2.search(queries, n_buckets=pidx.n_buckets, k=10)
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_allclose(d1, d2, atol=1e-6)
    _same(jdyn2, dyn2, queries, pidx.n_buckets)

    fresh, _ = synthetic_blobs(50, 24, 1, n_clusters=16, seed=123)
    new_ids = dyn2.insert(fresh)
    np.testing.assert_array_equal(jdyn2.insert(fresh), new_ids)
    assert new_ids.min() > ids.max()
    _, n3 = _same(jdyn2, dyn2, queries[:20], pidx.n_buckets)
    corpus = np.concatenate([data, extra, fresh])
    keep = np.ones(len(corpus), bool)
    keep[np.concatenate([ids[::3], np.arange(1, 200)]) - 1] = False
    live_ids = np.nonzero(keep)[0] + 1
    assert recall(n3, live_ids[_oracle_ids(corpus[keep], queries[:20]) - 1], 10) == 1.0
    stats = dyn2.compact()
    assert stats["chunks_after"] <= stats["chunks_before"]
    jdyn2.compact()
    _same(jdyn2, dyn2, queries[:20], 4)


def test_donate_is_kept_and_changes_no_result(built):
    """``ShardedDynamicIndex(index, sharded, donate=...)`` takes the JAX
    package's keyword and keeps it as ``self.donate``, as the JAX
    package's does; the port's mutations write in place either way, so
    the same inserts, deletes, compaction and searches give identical
    results (ids, distance bits, store contents) under both values."""
    data, queries, extra, jidx, pidx, pred, _ = built
    dyns = {}
    for donate in (False, True):
        sharded = lmi.shard_store(data, pidx.bucket_ids_from_prediction(pred), pidx.n_buckets,
                                  CPUS[:4], chunk=64)
        dyns[donate] = ShardedDynamicIndex(pidx, sharded, donate=donate)
        assert dyns[donate].donate is donate
    jsharded = JaxShardedDynamicIndex.from_built(jidx, data, pred, mesh=jax_create_mesh(8),
                                                 chunk=64).sharded
    assert JaxShardedDynamicIndex(jidx, jsharded, donate=True).donate is True
    outs = {}
    for donate, dyn in dyns.items():
        ids = dyn.insert(extra)
        assert dyn.delete(np.concatenate([ids[::4], np.arange(1, 151)])) == len(ids[::4]) + 150
        before = dyn.search(queries, n_buckets=4, k=10)[:2]
        stats = dyn.compact()
        after = dyn.search(queries, n_buckets=pidx.n_buckets, k=10, precision="highest")[:2]
        outs[donate] = [ids, *before, np.array([stats["chunks_before"], stats["chunks_after"]]),
                        *after, *(st.chunk_ids.numpy() for st in dyn.sharded.shards)]
    assert len(outs[False]) == len(outs[True])
    for a, b in zip(outs[False], outs[True]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_search_server_over_a_sharded_dynamic_index(built):
    """``SearchServer(ShardedDynamicIndex)``: searches, inserts seen by
    the next search, deletes, compaction, the stats."""
    data, queries, extra, _, pidx, pred, _ = built
    dyn = ShardedDynamicIndex.from_built(pidx, data, pred, CPUS[:4], chunk=64)
    with SearchServer(dyn, k=10, n_buckets=pidx.n_buckets, warmup=False) as server:
        sd, si = server.search(queries[:20])
        d, i, _ = dyn.search(queries[:20], n_buckets=pidx.n_buckets, k=10, precision="default",
                             rerank=True)
        np.testing.assert_array_equal(si, i)
        ids = server.insert(extra[:8])
        _, got = server.search(extra[:8], k=1)
        np.testing.assert_array_equal(got[:, 0], ids)
        assert server.delete(ids[:4]) == 4
        _, got = server.search(extra[:4], k=10)
        assert not np.isin(got, ids[:4]).any()
        rep = server.compact()
        assert rep["chunks_after"] == dyn.store.n_chunks <= rep["chunks_before"]
        st = server.stats()
        assert st["mutable"] and st["engine"] == "plain" and st["rows"] == len(data) + 4
        assert st["inserts"] == 8 and st["deletes"] == 4


def test_main_serves_a_sharded_dynamic_index():
    """``python -m learnedmetricindex_tpu_torch.serve --device cpu
    --synthetic N --shard-devices 4 --dynamic`` over real sockets:
    /insert, /search, /delete, /compact and /stats."""
    with _serve_main(["--synthetic", "2000", "--d", "16", "--buckets", "8", "--dynamic",
                      "--shard-devices", "4", "--n-buckets", "8", "--max-batch", "64"]) as base:
        v = np.eye(16, dtype=np.float32)[:3]
        ids = _post(f"{base}/insert", {"vectors": v.tolist()})["ids"]
        out = _post(f"{base}/search", {"queries": v.tolist(), "k": 1})
        assert [row[0] for row in out["ids"]] == ids
        assert _post(f"{base}/delete", {"ids": ids[:2]}) == {"deleted": 2}
        out = _post(f"{base}/search", {"queries": v[:2].tolist(), "k": 5})
        assert not set(ids[:2]) & {i for row in out["ids"] for i in row}
        rep = _post(f"{base}/compact", {})
        assert rep["chunks_after"] <= rep["chunks_before"]
        import json
        import urllib.request

        with urllib.request.urlopen(f"{base}/stats", timeout=30) as r:
            stats = json.loads(r.read())
        assert stats["mutable"] and stats["rows"] == 2001 and stats["inserts"] == 3
