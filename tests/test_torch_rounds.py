"""``k`` past the scan kernel's widest list (1024): the plain version
against the JAX package's Pallas kernel (interpret mode) at ``k_scan``
1025 and 2100, over fresh stores and stores mutated the same way in both
packages, and at ``k_scan`` 106 over exact ties (the tie rule of the
kernel's wide lists); the rounds of at most 1024 that the CUDA wrapper runs, held
here against one wide list with the plain version as each round; and
``search(k=1100)`` and the CLI's ``--k 1019`` against the JAX package
and exact kNN."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index import mutation as jmut
from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
from learnedmetricindex_tpu.index.bucket_store import build_scan_plan
from learnedmetricindex_tpu.index.serialization import save_index as jax_save_index
from learnedmetricindex_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch import cli
from learnedmetricindex_tpu_torch.index import mutation as pmut
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs
from learnedmetricindex_tpu_torch.ops import scan_kernel
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall
from test_torch_cuda import _shuffled  # a store with its chunks moved

torch.set_num_threads(2)

N, D, NB, CHUNK, QTILE = 5000, 16, 3, 256, 8


def _small_integers(n, seed):
    """(n, D) f32 rows of integers in [-2, 2]: every product and sum of two
    such rows is exact in f32 and bf16, so both packages compute the same
    distances bit for bit, and many of them tie exactly."""
    return np.random.default_rng(seed).integers(-2, 3, (n, D)).astype(np.float32)


def _stores(mode, mutated, integers=False):
    """The same store in both packages (f32, or int8 for mode "int8"):
    5000×16 rows in 3 buckets of ~1,700, chunk 256; ``mutated``: then 600
    inserts (pool chunks and growth) and 400 deletes in each package's
    mutation layer; ``integers``: rows, queries and inserts from
    :func:`_small_integers`.  Returns (JAX store, port store, queries,
    visits)."""
    data, queries = synthetic_blobs(N, D, 24, seed=3)
    if integers:
        data, queries = _small_integers(N, 3), _small_integers(24, 5)
    rng = np.random.default_rng(3)
    bucket_ids = rng.integers(0, NB, N)
    if mode == "int8":
        jstore = JaxStore.build_packed_int8(data, bucket_ids, NB, chunk=CHUNK)
        store = BucketStore.build_packed_int8(data, bucket_ids, NB, chunk=CHUNK, device="cpu")
    else:
        jstore = JaxStore.build(data, bucket_ids, NB, chunk=CHUNK)
        store = BucketStore.build(data, bucket_ids, NB, chunk=CHUNK, device="cpu")
    if mutated:
        extra = _small_integers(600, 4) if integers else synthetic_blobs(600, D, 1, seed=4)[0]
        extra_b = rng.integers(0, NB, 600)
        ids = np.arange(N + 1, N + 601)
        gone = rng.choice(np.arange(1, N + 601), 400, replace=False)
        jstore, _ = jmut.delete_ids(jmut.insert_rows(jstore, extra, extra_b, ids), gone)
        store, _ = pmut.delete_ids(pmut.insert_rows(store, extra, extra_b, ids), gone)
        np.testing.assert_array_equal(store.chunk_ids.numpy(), np.asarray(jstore.chunk_ids))
        ptr, clist = store.chunk_list()
        assert len(clist) > len(np.unique(bucket_ids)) and store.n_chunks > jstore.n_chunks - 1
    order = np.stack([rng.choice(NB, 2, replace=False) for _ in range(24)]).astype(np.int64)
    order[-4:, 1] = -1
    return jstore, store, queries, order


def _jax_pairs(jstore, queries, order, k, mode):
    plan = build_scan_plan(jstore, order, qtile=QTILE)
    n_pairs = len(plan.qidx) // QTILE
    im, ic, wr, sf, _ = pallas_host_args(jstore, plan, QTILE, n_pairs)
    qidx = jnp.asarray(plan.qidx)
    g = jnp.maximum(qidx, 0)
    qs = None
    if mode == "int8":
        q_int, q_sc = jax_quantize_rows(jnp.asarray(queries))
        wq = jnp.where((qidx >= 0)[:, None], q_int[g], 0)
        qs = jnp.where(qidx >= 0, q_sc[g], 0.0).reshape(n_pairs, QTILE)
    else:
        wq = jnp.where((qidx >= 0)[:, None], jnp.asarray(queries)[g], 0.0)
    cd, cs = pallas_scan_pairs(
        wq, jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), jstore.chunk_data,
        jnp.asarray(sf), qs, k=k, qtile=QTILE, chunk=CHUNK, n_pairs=n_pairs,
        compute=mode, interpret=True,
    )
    return plan, np.asarray(cd)[:n_pairs], np.asarray(cs)[:n_pairs]


@pytest.mark.parametrize("mutated", [False, True])
@pytest.mark.parametrize("mode", ["f32", "int8"])
@pytest.mark.parametrize("k", [1025, 2100])
def test_plain_scan_matches_pallas_past_the_widest_list(k, mode, mutated):
    """Per pair and real query, the plain version's k_scan 1025 / 2100
    candidates equal the Pallas kernel's, sorted by (distance, slot) (the
    parity bar; slots differ
    only at exact ties), also where mutation left the chunk lists out of
    physical order; buckets of ~1,700–1,900 rows leave the tail of a
    2100-wide list as fill in both."""
    jstore, store, queries, order = _stores(mode, mutated)
    jplan, jd, js = _jax_pairs(jstore, queries, order, k, mode)
    o = np.lexsort((js, jd), axis=-1)  # the Pallas kernel's lists are unordered
    jd, js = np.take_along_axis(jd, o, -1), np.take_along_axis(js, o, -1)
    plan, args = scan_inputs(store, torch.as_tensor(queries), torch.as_tensor(order), QTILE, mode)
    assert plan.n_pairs == jd.shape[0]
    td, ts = scan_kernel.scan_pairs_reference(*args, k=k, qtile=QTILE, chunk=CHUNK, mode=mode)
    td, ts = td.numpy(), ts.numpy()
    real = (jplan.qidx >= 0).reshape(-1, QTILE)
    assert np.isinf(td[~real]).all() and (ts[~real] == -1).all()
    np.testing.assert_array_equal(np.isinf(td[real]), np.isinf(jd[real]))
    fin = np.isfinite(jd[real])
    assert fin.any() and (~fin).any() if k == 2100 else fin.all()
    np.testing.assert_allclose(td[real], jd[real], rtol=1e-4, atol=1e-5)
    mism = ts[real] != js[real]
    if mism.any():
        np.testing.assert_allclose(td[real][mism], jd[real][mism], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mutated", [False, True])
@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_plain_scan_keeps_the_tie_rule_at_k_scan_106(mode, mutated):
    """k_scan 106 (``search(k=100)``, list width 128 on CUDA) over rows and
    queries of small integers, where distances are exact in both packages
    and tie in large groups that the 106th entry splits.  Per pair and
    real query: the plain version's distances equal the Pallas kernel's
    bit for bit, and so do its rows below the 106th distance; at that
    distance both keep the same number of rows of the tie group, the plain
    version the group's first in the bucket's scan order (also where
    mutation left chunk lists out of physical order).  The Pallas kernel
    may keep later ones there: its insert evicts the first of the tied
    entries in its accumulator's storage order."""
    jstore, store, queries, order = _stores(mode, mutated, integers=True)
    jplan, jd, js = _jax_pairs(jstore, queries, order, 106, mode)
    plan, args = scan_inputs(store, torch.as_tensor(queries), torch.as_tensor(order), QTILE, mode)
    kw = dict(qtile=QTILE, chunk=CHUNK, mode=mode)
    td, ts = (t.numpy() for t in scan_kernel.scan_pairs_reference(*args, k=106, **kw))
    # every row of the visited bucket, in (distance, scan position) order
    ad, as_ = (t.numpy() for t in scan_kernel.scan_pairs_reference(*args, k=3000, **kw))
    real = (jplan.qidx >= 0).reshape(-1, QTILE)
    o = np.lexsort((js, jd), axis=-1)
    jd, js = np.take_along_axis(jd, o, -1)[real], np.take_along_axis(js, o, -1)[real]
    td, ts, ad, as_ = td[real], ts[real], ad[real], as_[real]
    assert np.isfinite(td).all()
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(td, ad[:, :106])
    np.testing.assert_array_equal(ts, as_[:, :106])
    kth = td[:, -1:]
    split = (ad[:, 106:107] == kth)[:, 0]
    assert split.sum() >= 10  # the tie group at the 106th distance runs past the list
    below = td < kth
    np.testing.assert_array_equal(np.where(below, ts, -1), np.where(below, js, -1))
    for q in range(len(td)):
        group = as_[q][ad[q] == kth[q]]
        assert set(js[q][~below[q]]) <= set(group)
    _, position = store.chunk_owner()
    pos = position[ts // CHUNK] * CHUNK + ts % CHUNK
    tied = td[:, 1:] == td[:, :-1]
    assert ((td[:, 1:] > td[:, :-1]) | (tied & (pos[:, 1:] > pos[:, :-1]))).all()


def _tied_store(virtual):
    """600×12 rows in 4 buckets, every row present three times in its
    bucket (exact ties that round boundaries split), chunk 32."""
    rng = np.random.default_rng(8)
    base = rng.normal(size=(200, 12)).astype(np.float32)
    data = np.concatenate([base, base, base])
    bucket_ids = np.tile(rng.integers(0, 4, 200), 3)
    if virtual:
        return BucketStore.build_virtual(torch.as_tensor(data), bucket_ids, 4, chunk=32), data
    return BucketStore.build(data, bucket_ids, 4, chunk=32, device="cpu"), data


@pytest.mark.parametrize("layout", ["packed", "shuffled", "virtual"])
@pytest.mark.parametrize("width,k", [(7, 300), (64, 300), (100, 1025)])
def test_rounds_equal_one_wide_list(layout, width, k):
    """scan_in_rounds, each round the plain version with its floor, equals
    the plain version's one list of width k bit for bit: exact ties that
    straddle a round boundary, a chunk order out of physical order, a
    virtual store's row map, padding queries and pairs that run out of
    rows before k."""
    store, data = _tied_store(layout == "virtual")
    if layout == "shuffled":
        store = _shuffled(pmut.ensure_mutable(store), 5)
    rng = np.random.default_rng(9)
    queries = torch.as_tensor(data[rng.choice(600, 40)] + 0.01)
    order = torch.as_tensor(np.stack([rng.choice(4, 2, replace=False) for _ in range(40)]))
    order[-5:, 1] = -1
    for mode in ("f32", "bf16"):
        plan, args = scan_inputs(store, queries, order, 16, mode)
        kw = dict(qtile=16, chunk=32, mode=mode)
        wide = scan_kernel.scan_pairs_reference(*args, k=k, **kw)
        n_chunks = store.n_chunks
        positions = scan_kernel.chunk_positions(args[3], args[4], n_chunks)
        rounds = []

        def one_round(qidx, pair_bucket, w, floor):
            rounds.append(pair_bucket.shape[0])
            return scan_kernel.scan_pairs_reference(
                args[0], qidx, pair_bucket, *args[3:], k=w, floor=floor, **kw)

        got = scan_kernel.scan_in_rounds(one_round, plan.qidx, plan.pair_bucket, positions,
                                         k=k, chunk=32, qtile=16, width=width)
        assert torch.equal(got[0], wide[0]) and torch.equal(got[1], wide[1])
        assert len(rounds) >= 2 and rounds[-1] <= rounds[0]
        if width == 7:  # pairs left the rounds once their lists ran short
            assert rounds[-1] < rounds[0] and len(rounds) < -(-k // width)
        slots = got[1].reshape(-1, k)
        for row in slots[:, : min(k, 150)]:
            live = row[row >= 0]
            assert len(torch.unique(live)) == len(live)


def test_chunk_positions_follow_the_chunk_lists():
    store, _ = _tied_store(False)
    store = _shuffled(pmut.ensure_mutable(store), 6)
    ptr, clist = store.chunk_list()
    got = scan_kernel.chunk_positions(torch.as_tensor(ptr.astype(np.int32)),
                                      torch.as_tensor(clist), store.n_chunks)
    np.testing.assert_array_equal(got.numpy(), store.chunk_owner()[1])


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    data, queries = synthetic_blobs(3000, 16, 16, n_clusters=8, seed=12)
    cfg = jlmi.BuildConfiguration("kmeans", 10, "MLP-2", 0.01, [3], seed=12, chunk_size=256)
    jidx, pred, _, _, _ = jlmi.LearnedIndexBuilder(data, cfg).build()
    path = str(tmp_path_factory.mktemp("wide") / "index.npz")
    jax_save_index(jidx, path, pred)
    pidx, ppred = lmi.load_index(path, "cpu")
    return data, queries, jidx, pidx, np.asarray(ppred)


def _parity(pd, pi, jd, ji):
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    mism = pi != ji
    if mism.any():
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)


def test_search_at_k_1100_matches_jax(built):
    """search(k=1100) (k_scan 1106 with the rerank margin) over a packed
    store equals the JAX package's, and over a virtual store equals the
    packed one; at every bucket it is exact kNN."""
    data, queries, jidx, pidx, pred = built
    kw = dict(n_buckets=2, k=1100, precision="highest")
    jd, ji, _ = jidx.search(None, queries, data, queries, pred, **kw)
    pd, pi, _ = pidx.search(None, queries, data, queries, pred, **kw)
    assert pd.shape == (16, 1100)
    _parity(pd, pi, np.asarray(jd), np.asarray(ji))
    corpus = torch.as_tensor(data)
    vd, vi, _ = pidx.search(None, queries, corpus, queries, pred, **kw)
    np.testing.assert_array_equal(vd, pd)
    np.testing.assert_array_equal(vi, pi)
    fd, fi, _ = pidx.search(None, queries, data, queries, pred, n_buckets=3, k=1100,
                            precision="highest")
    ref_d, ref_i = exact_knn(data, queries, k=1100, device="cpu")
    np.testing.assert_allclose(fd, ref_d, rtol=1e-4, atol=1e-5)
    assert recall(fi, ref_i, 1100) >= 0.999


def test_search_at_k_1100_over_a_mutated_store_matches_jax(built):
    """The same after inserts and deletes, in each package's DynamicIndex."""
    data, queries, jidx, pidx, pred = built
    extra, _ = synthetic_blobs(500, 16, 1, n_clusters=8, seed=13)
    j = jmut.DynamicIndex.from_built(jidx, data, pred)
    p = lmi.DynamicIndex.from_built(pidx, data, pred)
    for dyn in (j, p):
        dyn.insert(extra)
        dyn.delete(np.arange(1, 3500, 7))
    jd, ji, _ = j.search(queries, n_buckets=2, k=1100, precision="highest")
    pd, pi, _ = p.search(queries, n_buckets=2, k=1100, precision="highest")
    _parity(pd, pi, np.asarray(jd), np.asarray(ji))
    assert not np.isin(pi, np.arange(1, 3500, 7)).any()


def test_cli_answers_k_1019():
    """The CLI's --k 1019 (k_scan 1025) answers: at every bucket it is each
    query's top-1019 to the bf16 bar."""
    args = cli.parse_args(["--synthetic", "2500", "--synthetic-dim", "8", "--n-categories", "3",
                           "--epochs", "2", "--model-type", "MLP-8", "-b", "3",
                           "--chunk-size", "256", "--k", "1019", "--no-save", "--device", "cpu"])
    result = cli.sweep(**cli.sweep_arguments(args))
    (n_buckets, dists, nns, _, _), = result.searches
    assert n_buckets == 3 and nns.shape == (len(result.queries), 1019)
    data, _ = synthetic_blobs(2500, 8, 100, seed=2023)  # the CLI's --synthetic draw
    np.testing.assert_array_equal(result.queries, _)
    ref_d, ref_i = exact_knn(data, result.queries, k=1019, device="cpu")
    # the CLI searches at the default precision: bf16 operands, then the exact
    # rerank of a k + 6 shortlist (the bf16 bar of tests/test_device_plan.py:71-88)
    np.testing.assert_allclose(dists, ref_d, atol=3e-3)
    assert recall(nns, ref_i, 1019) >= 0.99
