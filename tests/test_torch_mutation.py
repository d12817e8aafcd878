"""The port's mutation layer against the JAX package's: the same insert,
delete and compact sequences on the same index leave bit-equal store
layouts and search to the reference's parity bars, for f32, bf16 and
int8 stores; the same validation errors; checkpoints that cross between
the two packages; and searches over stores whose chunk lists are out of
physical order."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index import mutation as jmut
from learnedmetricindex_tpu.index.serialization import load_dynamic_index as jax_load_dynamic
from learnedmetricindex_tpu.index.serialization import save_index as jax_save_index
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.index import mutation as pmut
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs
from learnedmetricindex_tpu_torch.index.serialization import load_dynamic_index
from learnedmetricindex_tpu_torch.ops import scan_kernel
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall, restricted_knn
from test_torch_cuda import _shuffled  # the GPU tests' store with its chunks moved

torch.set_num_threads(2)

DTYPES = ["float32", "bfloat16", "int8"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The fixture of tests/test_mutation.py (3000×24, [3, 3], MLP-2,
    chunk 64), built by the JAX package and loaded into the port through
    ``.npz``."""
    data, queries = synthetic_blobs(3000, 24, 100, n_clusters=16, seed=2023)
    extra, _ = synthetic_blobs(400, 24, 1, n_clusters=16, seed=77)
    cfg = jlmi.BuildConfiguration("kmeans", 40, "MLP-2", 0.01, [3, 3], seed=2023, chunk_size=64)
    jidx, pred, _, _, _ = jlmi.LearnedIndexBuilder(data, cfg).build()
    path = str(tmp_path_factory.mktemp("mut") / "index.npz")
    jax_save_index(jidx, path, pred)
    pidx, ppred = lmi.load_index(path, "cpu")
    return {"data": data, "queries": queries, "extra": extra, "jidx": jidx, "pidx": pidx,
            "pred": np.asarray(pred)}


def _dynamic_pair(b, dtype):
    jdt = None if dtype == "float32" else jnp.dtype(dtype)
    j = jmut.DynamicIndex.from_built(b["jidx"], b["data"], b["pred"], chunk=64, dtype=jdt)
    p = lmi.DynamicIndex.from_built(b["pidx"], b["data"], b["pred"], chunk=64, dtype=dtype)
    return j, p


def _assert_same_store(js, ps, what):
    for f in ("bucket_chunk_ptr", "bucket_chunk_list", "bucket_fill", "bucket_sizes",
              "bucket_chunk_start"):
        np.testing.assert_array_equal(getattr(ps, f), getattr(js, f), err_msg=f"{what}: {f}")
    ids = np.asarray(js.chunk_ids)
    np.testing.assert_array_equal(ps.chunk_ids.numpy(), ids, err_msg=f"{what}: chunk_ids")
    live = ids[ids > 0]
    assert ps.row_slot.shape == js.row_slot.shape, what
    np.testing.assert_array_equal(ps.row_slot.numpy()[live - 1], np.asarray(js.row_slot)[live - 1],
                                  err_msg=f"{what}: row_slot")
    jd = np.asarray(js.chunk_data.astype(jnp.float32))
    assert ps.chunk_data.dtype == getattr(torch, str(js.chunk_data.dtype)), what
    np.testing.assert_array_equal(ps.chunk_data.float().numpy(), jd, err_msg=f"{what}: chunk_data")
    assert (js.chunk_scales is None) == (ps.chunk_scales is None), what
    if ps.chunk_scales is not None:
        np.testing.assert_array_equal(ps.chunk_scales.numpy(), np.asarray(js.chunk_scales),
                                      err_msg=f"{what}: chunk_scales")


def _assert_parity(pd, pi, jd, ji):
    """The reference's bar (tests/test_scan_kernel.py:22-30)."""
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    mism = pi != ji
    if mism.any():
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)


def _assert_same_search(j, p, queries, what):
    for precision in ("highest", "default"):
        jd, ji, _ = j.search(queries, n_buckets=4, k=10, precision=precision)
        pd, pi, _ = p.search(queries, n_buckets=4, k=10, precision=precision)
        jd, ji = np.asarray(jd), np.asarray(ji)
        if precision == "highest":
            _assert_parity(pd, pi, jd, ji)
        else:  # the bf16 bar of tests/test_device_plan.py:71-88
            np.testing.assert_allclose(pd, jd, atol=3e-3, err_msg=what)
            assert (np.sort(pi, axis=1) == np.sort(ji, axis=1)).mean() >= 0.99, what


def test_classify_matches_jax_and_the_builders(built):
    """The port's classify gives the JAX builder's partition of the corpus
    and the JAX classify of new rows; over a port-built index, the port
    builder's partition."""
    data, extra, pidx = built["data"], built["extra"], built["pidx"]
    np.testing.assert_array_equal(pidx.classify(data), built["pred"])
    np.testing.assert_array_equal(pidx.classify(extra), built["jidx"].classify(extra))
    assert pidx.classify(data[:0]).shape == (0, 2)
    with pytest.MonkeyPatch.context() as mp:  # in slices
        mp.setattr("learnedmetricindex_tpu_torch.index.index.CLASSIFY_ROWS", 700)
        np.testing.assert_array_equal(pidx.classify(data), built["pred"])
    cfg = lmi.BuildConfiguration("kmeans", 5, "MLP-2", 0.01, [3, 2], seed=3, chunk_size=64,
                                 batch_size=128)
    index, pred, *_ = lmi.LearnedIndexBuilder(data[:1500], cfg, device="cpu").build()
    np.testing.assert_array_equal(index.classify(data[:1500]), pred)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mutation_sequence_matches_jax(built, dtype):
    """Inserts that take pool chunks and grow the store, serving-size
    inserts, deletes of inserted and original rows, re-inserts of deleted
    ids and compaction, in both packages: after every step the store
    arrays are bit-equal, and after each group of steps (inserts, deletes
    and re-inserts, compaction and an insert) the searches meet the
    parity bars (the JAX package compiles its search anew for every store
    shape, about 1.3 s a precision on the CPU)."""
    data, queries, extra = built["data"], built["queries"], built["extra"]
    j, p = _dynamic_pair(built, dtype)
    _assert_same_store(j.store, p.store, "fresh")
    n0 = p.store.n_chunks
    ids = j.insert(extra)
    np.testing.assert_array_equal(p.insert(extra), ids)
    assert p.store.n_chunks > n0  # grew
    assert not np.array_equal(p.store.bucket_chunk_list, np.arange(len(p.store.bucket_chunk_list)))
    _assert_same_store(j.store, p.store, "insert 400")
    for s0 in range(0, 192, 64):  # serving-size batches
        rows = extra[s0 : s0 + 64] + 0.01
        np.testing.assert_array_equal(p.insert(rows), j.insert(rows))
    _assert_same_store(j.store, p.store, "inserts of 64")
    _assert_same_search(j, p, queries, "inserts")
    victims = np.concatenate([ids[::3], np.arange(1, 301, 2)])
    assert p.delete(victims) == j.delete(victims) == len(victims)
    _assert_same_store(j.store, p.store, "delete")
    back = np.arange(1, 21, 2)
    np.testing.assert_array_equal(p.insert(data[:20:2], object_ids=back),
                                  j.insert(data[:20:2], object_ids=back))
    _assert_same_store(j.store, p.store, "re-insert")
    _assert_same_search(j, p, queries, "deletes and re-inserts")
    j.compact()
    p.compact()
    _assert_same_store(j.store, p.store, "compact")
    np.testing.assert_array_equal(p.insert(extra[:100]), j.insert(extra[:100]))
    _assert_same_store(j.store, p.store, "insert after compact")
    _assert_same_search(j, p, queries, "insert after compact")
    assert p.n_rows == j.n_rows and p.next_id == j.next_id


def _validation_cases(data):
    v = data[:2]
    big = 2_000_000_000
    return {
        "1-based": (v, [0, 1], [0, 5]),
        "mismatch": (v, [0], [4001, 4002]),
        "out of range": (v, [-1, 2], [4001, 4002]),
        "int32": (v, [0, 1], [1, 2**31 + 5]),
        "LMI_MAX_OBJECT_ID": (v, [0, 1], [1, big]),
        "duplicate": (v, [0, 1], [9001, 9001]),
        "already live": (v, [0, 1], [9002, 5]),
    }


@pytest.mark.parametrize("case", list(_validation_cases(np.zeros((2, 1)))))
def test_insert_validation_matches_jax(built, case):
    """Every refusal of the JAX package's low-level insert, with the same
    message, and nothing changed by it."""
    j, p = _dynamic_pair(built, "float32")
    vectors, buckets, ids = _validation_cases(built["data"])[case]
    with pytest.raises(ValueError, match=case) as pe:
        pmut.insert_rows(p.store, vectors, np.array(buckets), np.array(ids))
    with pytest.raises(ValueError) as je:
        jmut.insert_rows(j.store, vectors, np.array(buckets), np.array(ids))
    assert str(pe.value) == str(je.value)
    _assert_same_store(j.store, p.store, case)


def test_insert_edge_cases(built, monkeypatch):
    """Zero-row edits are no-ops, the id cap is a knob, a virtual store is
    refused, ids already live or repeated in the batch are refused through
    DynamicIndex.insert and change nothing."""
    data, extra = built["data"], built["extra"]
    _, p = _dynamic_pair(built, "float32")
    st = p.store
    assert pmut.insert_rows(st, data[:0], np.array([]), np.array([])) is st
    assert pmut.delete_ids(st, np.array([]))[0] is st
    with pytest.raises(ValueError, match="packed"):
        pmut.ensure_mutable(st._replace(chunk_data=None))
    with pytest.raises(ValueError, match=r"vectors must be \(m, 24\)"):
        p.insert(data[:2, :5])
    with pytest.raises(ValueError, match="already live"):
        p.insert(extra[:1], object_ids=np.array([5]))
    with pytest.raises(ValueError, match="duplicate"):
        p.insert(extra[:2], object_ids=np.array([9001, 9001]))
    assert p.n_rows == len(data) and p.insert(extra[:0]).shape == (0,)
    monkeypatch.setenv("LMI_MAX_OBJECT_ID", str(2_000_000))
    st2 = pmut.insert_rows(p.store, data[:2], np.array([0, 1]), np.array([1_999_999, 2_000_000]))
    assert st2.row_slot.shape[0] >= 2_000_000


def test_delete_duplicates_count_once_and_skip_absent(built):
    j, p = _dynamic_pair(built, "int8")
    sizes = p.store.bucket_sizes.copy()
    assert p.delete(np.array([7, 7, 7, 7])) == j.delete(np.array([7, 7, 7, 7])) == 1
    assert (sizes - p.store.bucket_sizes).sum() == 1
    assert p.delete(np.array([7, 0, 10**9])) == 0
    _assert_same_store(j.store, p.store, "deletes")


def test_delete_all_then_compact_twice(built):
    """A store compacted empty keeps one padding chunk in the free pool;
    a second compact works, and the next insert draws the chunk from the
    pool, as in the JAX package."""
    data = built["data"]
    j, p = _dynamic_pair(built, "float32")
    all_ids = np.arange(1, len(data) + 1)
    assert p.delete(all_ids) == j.delete(all_ids) == len(data)
    assert p.n_rows == 0
    p.compact()
    j.compact()
    assert p.store.n_chunks == 1 and len(p.store.bucket_chunk_list) == 0
    assert int(p.store.bucket_chunk_ptr[-1]) == 0
    p.compact()
    j.compact()
    assert p.store.n_chunks == 1
    ids = np.arange(1, 9)
    p.insert(data[:8], object_ids=ids)
    j.insert(data[:8], object_ids=ids)
    _assert_same_store(j.store, p.store, "after delete-all and compacts")
    np.testing.assert_array_equal(np.sort(p.store.bucket_chunk_list), np.arange(p.store.n_chunks))
    _, nns, _ = p.search(data[:8], n_buckets=9, k=1)
    np.testing.assert_array_equal(nns[:, 0], ids)


def test_randomized_interleaving_matches_model(built):
    """Random inserts, deletes and compactions agree with a dict model of
    id → vector under full-visit search (exact kNN of the live rows)."""
    data, queries = built["data"], built["queries"]
    rng = np.random.default_rng(17)
    p = lmi.DynamicIndex.from_built(built["pidx"], data, built["pred"], chunk=64)
    model = {i + 1: data[i] for i in range(len(data))}

    def check():
        corpus = np.stack(list(model.values()))
        ids = np.fromiter(model.keys(), np.int64)
        _, gt_rows = exact_knn(corpus, queries[:20], k=10, device="cpu")
        _, nns, _ = p.search(queries[:20], n_buckets=9, k=10, precision="highest")
        assert recall(nns, ids[gt_rows.astype(np.int64) - 1], 10) == 1.0
        assert p.n_rows == len(model)

    for step in range(12):
        op = rng.choice(["insert", "delete", "compact"])
        if op == "insert":
            vecs = rng.normal(size=(int(rng.integers(1, 80)), data.shape[1])).astype(np.float32)
            vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
            model.update(zip(p.insert(vecs).tolist(), vecs))
        elif op == "delete" and len(model) > 100:
            live = np.fromiter(model.keys(), np.int64)
            victims = rng.choice(live, size=int(rng.integers(1, 60)), replace=False)
            assert p.delete(victims) == len(victims)
            for v in victims:
                del model[int(v)]
        else:
            p.compact()
        if step % 3 == 2:
            check()
    check()


@pytest.mark.parametrize("dtype", DTYPES)
def test_checkpoints_cross_both_ways(built, tmp_path, dtype):
    """A mutated deployment saved by either package loads in the other
    (paths without .npz too): the same store arrays, the same searches,
    and id allocation resumes where it stopped."""
    queries, extra = built["queries"], built["extra"]
    j, p = _dynamic_pair(built, dtype)
    ids = j.insert(extra)
    p.insert(extra)
    j.delete(ids[::3])
    p.delete(ids[::3])
    pd, pi, _ = p.search(queries, n_buckets=9, k=10, precision="highest")
    p.save(str(tmp_path / "port.ckpt"))
    j.save(str(tmp_path / "jax.ckpt"))
    assert not os.path.exists(tmp_path / "port.ckpt.npz")
    from_jax = lmi.DynamicIndex.load(str(tmp_path / "jax.ckpt"), "cpu")
    from_port = jax_load_dynamic(str(tmp_path / "port.ckpt"))
    again = load_dynamic_index(str(tmp_path / "port.ckpt"), "cpu")
    _assert_same_store(j.store, from_jax.store, "jax → port")
    _assert_same_store(from_port.store, p.store, "port → jax")
    _assert_same_store(from_port.store, again.store, "port → port")
    assert from_jax.next_id == from_port.next_id == p.next_id
    for back in (from_jax, again):
        d, i, _ = back.search(queries, n_buckets=9, k=10, precision="highest")
        np.testing.assert_array_equal(i, pi)
        np.testing.assert_array_equal(d.view(np.uint32), pd.view(np.uint32))
    jd, ji, _ = from_port.search(queries, n_buckets=9, k=10, precision="highest")
    _assert_parity(pd, pi, np.asarray(jd), np.asarray(ji))
    assert from_jax.insert(extra[:5]).min() > ids.max()


def test_plain_checkpoint_is_refused_with_a_pointer(built, tmp_path):
    plain = str(tmp_path / "plain.npz")
    jax_save_index(built["jidx"], plain, built["pred"])
    with pytest.raises(ValueError, match="load_index"):
        load_dynamic_index(plain, "cpu")
    lmi.save_index(built["pidx"], plain, built["pred"])
    with pytest.raises(ValueError, match="load_index"):
        lmi.DynamicIndex.load(plain, "cpu")


def test_inserts_write_in_place_and_wrapping_makes_no_copy(built):
    """DynamicIndex(index, store) keeps the store's tensors; an insert that
    fits writes into them; only growth and compaction allocate."""
    pidx, data, pred = built["pidx"], built["data"], built["pred"]
    store = BucketStore.build_packed_int8(data, pidx.bucket_ids_from_prediction(pred), 9,
                                          chunk=64, device="cpu")
    dyn = lmi.DynamicIndex(pidx, store)
    assert dyn.store.chunk_data is store.chunk_data and dyn.next_id == len(data) + 1
    room = np.diff(dyn.store.bucket_chunk_ptr) * 64 - dyn.store.bucket_fill
    row = int(np.nonzero(room[pidx.bucket_ids_from_prediction(pred)] > 0)[0][0])
    ids = dyn.insert(data[row : row + 1])  # into a bucket with room: no growth
    assert dyn.store.chunk_data is store.chunk_data
    assert store.chunk_ids.reshape(-1)[dyn.store.row_slot[ids[0] - 1]] == ids[0]
    dyn.insert(built["extra"])
    assert dyn.store.chunk_data.shape[0] > store.chunk_data.shape[0]
    grown = dyn.store.chunk_data
    dyn.compact()
    assert dyn.store.chunk_data is not grown


def test_from_built_packs_tensors_like_host_arrays(built):
    """A tensor corpus (f32, or int8 with row scales) packs on the
    index's device into the store the host path builds."""
    from learnedmetricindex_tpu_torch.ops import quantize

    pidx, data, pred = built["pidx"], built["data"], built["pred"]
    host = lmi.DynamicIndex.from_built(pidx, data, pred, dtype="int8").store
    t = torch.from_numpy(data)
    q8, sc = quantize.quantize_rows(t)
    for got in (lmi.DynamicIndex.from_built(pidx, t, pred, dtype=torch.int8).store,
                lmi.DynamicIndex.from_built(pidx, (q8, sc), pred).store):
        assert torch.equal(got.chunk_data, host.chunk_data)
        assert torch.equal(got.chunk_scales, host.chunk_scales)
        assert torch.equal(got.chunk_ids, host.chunk_ids)
    with pytest.raises(ValueError, match="row scales"):
        lmi.DynamicIndex.from_built(pidx, q8, pred)


@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_lists_out_of_physical_order(built, dtype):
    """A mutated store with its chunks shuffled physically: the plain scan
    reads buckets through their lists, so search output is bit-identical
    to the unshuffled store's; restricted_knn maps pool chunks to their
    buckets and equals the search at highest; exact duplicates tie toward
    the earlier scan position; compaction restores the same output."""
    data, queries, extra = built["data"], built["queries"], built["extra"]
    _, p = _dynamic_pair(built, dtype)
    ids = p.insert(extra)
    dup = p.insert(data[:30])  # exact copies of rows 1..30, later in their buckets' scan
    p.delete(ids[1::4])
    shuffled = lmi.DynamicIndex(built["pidx"], _shuffled(p.store, 3), next_id=p.next_id)
    for precision in ("highest", "default"):
        a = p.search(queries, n_buckets=4, k=10, precision=precision)
        b = shuffled.search(queries, n_buckets=4, k=10, precision=precision)
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_array_equal(a[0].view(np.uint32), b[0].view(np.uint32))
    q = torch.as_tensor(queries)
    order, _ = p.index.compute_bucket_order(q, 4, keep_on_device=True)
    _, ref = restricted_knn(shuffled.store, q, order, 10)
    d, i, _ = shuffled.search(queries, n_buckets=4, k=10, precision="highest")
    assert recall(i, ref.numpy(), 10) == 1.0
    # the plain scan on the shuffled store: a row's exact copy comes after it
    st = shuffled.store
    bucket, position = st.chunk_owner()
    slot = st.row_slot.long()
    scan_pos = lambda s: position[s // st.chunk] * st.chunk + s % st.chunk  # noqa: E731
    orig, copy = slot[np.arange(30)].numpy(), slot[dup - 1].numpy()
    assert (bucket[orig // st.chunk] == bucket[copy // st.chunk]).all()
    assert (scan_pos(orig) < scan_pos(copy)).all() and (orig > copy).any()
    mode = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}[dtype]
    qs = torch.as_tensor(data[:30])
    plan, args = scan_inputs(st, qs, torch.as_tensor(bucket[orig // st.chunk])[:, None], 8,
                             "int8" if mode == "int8" else "f32")
    _, cand = scan_kernel.scan_pairs(*args, k=4, qtile=8, chunk=st.chunk,
                                     mode="int8" if mode == "int8" else "f32")
    lists = cand.reshape(-1, 4)[plan.pair_rows]
    np.testing.assert_array_equal(lists[:, 0].numpy(), orig)
    np.testing.assert_array_equal(lists[:, 1].numpy(), copy)
    shuffled.compact()
    c = shuffled.search(queries, n_buckets=4, k=10, precision="highest")
    np.testing.assert_array_equal(c[1], i)
    np.testing.assert_array_equal(c[0].view(np.uint32), d.view(np.uint32))
