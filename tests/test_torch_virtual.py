"""Virtual stores (the id grid over an unmoved corpus tensor) against the
JAX package's virtual stores and the port's packed stores: the same id
grid, the same searches at the reference's parity bars for f32, bf16
and int8 + row-scale corpora, no copy of the rows, and the refusals
(int8 precision, every mutation entry point) the JAX package gives."""

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
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.index import mutation as pmut
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore
from learnedmetricindex_tpu_torch.ops.knn import restricted_knn
from learnedmetricindex_tpu_torch.serve import SearchServer

torch.set_num_threads(2)

NB, CHUNK = 7, 64


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A 1-level [7] index built by the JAX package over 1800×24 blobs,
    saved and loaded by the port, and the corpus in each type: f32,
    bf16, and int8 rows with their f32 row scales (``ops.quantize``)."""
    data, queries = synthetic_blobs(1800, 24, 60, n_clusters=12, seed=5)
    cfg = jlmi.BuildConfiguration("kmeans", 10, "MLP-2", 0.01, [NB], seed=5, chunk_size=CHUNK)
    jidx, pred, _, _, _ = jlmi.LearnedIndexBuilder(data, cfg).build()
    path = str(tmp_path_factory.mktemp("virtual") / "index.npz")
    jax_save_index(jidx, path, pred)
    pidx, ppred = lmi.load_index(path, "cpu")
    q8, sc = jax_quantize_rows(jnp.asarray(data))
    corpora = {
        "float32": (torch.as_tensor(data), jnp.asarray(data)),
        "bfloat16": (torch.as_tensor(data).bfloat16(), jnp.asarray(data, jnp.bfloat16)),
        "int8": ((torch.as_tensor(np.array(q8)), torch.as_tensor(np.array(sc))), (q8, sc)),
    }
    return {"data": data, "queries": queries, "jidx": jidx, "pidx": pidx,
            "pred": np.asarray(ppred), "corpora": corpora}


def _parity(pd, pi, jd, ji):
    """The reference's bar (tests/test_scan_kernel.py:22-30)."""
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    mism = pi != ji
    if mism.any():
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)


def test_build_virtual_grid_matches_jax(built):
    """The id grid, CSR and bucket sizes are bit-equal to the JAX package's
    build_virtual; the store holds the corpus tensor itself and only the
    grid's bytes."""
    data = built["data"]
    bucket_ids = built["pidx"].bucket_ids_from_prediction(built["pred"])
    jstore = JaxStore.build_virtual(jnp.asarray(data), bucket_ids, NB, chunk=CHUNK)
    corpus = torch.as_tensor(data)
    store = BucketStore.build_virtual(corpus, bucket_ids, NB, chunk=CHUNK)
    assert store.virtual and store.chunk_data is None and store.data_ref is corpus
    np.testing.assert_array_equal(store.chunk_ids.numpy(), np.asarray(jstore.chunk_ids))
    np.testing.assert_array_equal(store.bucket_chunk_start, jstore.bucket_chunk_start)
    np.testing.assert_array_equal(store.bucket_sizes, jstore.bucket_sizes)
    assert store.nbytes() == jstore.nbytes() == store.chunk_ids.numel() * 4
    assert store.dim == 24 and store.device == torch.device("cpu")
    with pytest.raises(ValueError, match="row scales"):
        BucketStore.build_virtual(corpus.to(torch.int8), bucket_ids, NB, chunk=CHUNK)
    with pytest.raises(ValueError, match="rows"):
        BucketStore.build_virtual(corpus[:100], bucket_ids, NB, chunk=CHUNK)


@pytest.mark.parametrize("n_buckets", [1, 3])
@pytest.mark.parametrize("corpus", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("precision", ["highest", "default"])
def test_virtual_search_matches_jax_and_packed(built, corpus, n_buckets, precision):
    """The port's search over a virtual store equals the JAX package's over
    its virtual store (precision "highest": the parity bar; "default",
    bf16 operands then an exact rerank: the bf16 bar, atol 3e-3 and 99%
    of the ids) and equals the port's packed store of the same corpus
    bit for bit."""
    pidx, jidx, queries, pred = built["pidx"], built["jidx"], built["queries"], built["pred"]
    p_corpus, j_corpus = built["corpora"][corpus]
    store = pidx.get_bucket_store(p_corpus, pred)
    assert store.virtual
    kw = dict(n_buckets=n_buckets, k=10, precision=precision)
    pd, pi, _ = pidx.search(None, queries, p_corpus, queries, pred, store=store, **kw)
    jd, ji, _ = jidx.search(None, queries, j_corpus, queries, pred, **kw)
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert jidx.get_bucket_store(j_corpus, pred).chunk_data is None  # JAX's virtual store
    if precision == "highest":
        _parity(pd, pi, jd, ji)
    else:
        np.testing.assert_allclose(pd, jd, atol=3e-3)
        assert (np.sort(pi, axis=1) == np.sort(ji, axis=1)).mean() >= 0.99
    packed = pidx.prepare_packed_store(p_corpus, pred)
    assert not packed.virtual
    kd, ki, _ = pidx.search(None, queries, None, queries, pred, store=packed, **kw)
    np.testing.assert_array_equal(pd, kd)
    np.testing.assert_array_equal(pi, ki)


def test_virtual_store_is_a_quarter_of_packed_and_exact_at_full_visit(built):
    """JAX test_virtual_store_matches_packed: the grid is under a quarter of
    the packed bytes; a full visit equals exact kNN over the store
    (restricted_knn reads a virtual store's rows through its grid, and
    gives what it gives over the packed store)."""
    pidx, queries, pred = built["pidx"], built["queries"], built["pred"]
    corpus = built["corpora"]["float32"][0]
    store = pidx.get_bucket_store(corpus, pred)
    packed = pidx.prepare_packed_store(corpus, pred)
    assert store.nbytes() < packed.nbytes() / 4
    q = torch.as_tensor(queries)
    order = torch.arange(NB).repeat(len(queries), 1)
    vd, vi = restricted_knn(store, q, order, 10)
    kd, ki = restricted_knn(packed, q, order, 10)
    assert torch.equal(vd, kd) and torch.equal(vi, ki)
    pd, pi, _ = pidx.search(None, queries, corpus, queries, pred, n_buckets=NB, k=10,
                            store=store, precision="highest")
    _parity(pd, pi, vd.numpy(), vi.numpy().astype(np.uint32))


def test_int8_precision_over_a_virtual_store_raises(built):
    """precision='int8' needs a packed int8 store, in both packages, also
    over an int8 corpus."""
    pidx, jidx, queries, pred = built["pidx"], built["jidx"], built["queries"], built["pred"]
    p_corpus, j_corpus = built["corpora"]["int8"]
    with pytest.raises(ValueError, match="packed int8 store.*virtual"):
        pidx.search(None, queries, p_corpus, queries, pred, n_buckets=2, precision="int8")
    with pytest.raises(ValueError, match="packed int8 store.*virtual"):
        jidx.search(None, queries, j_corpus, queries, pred, n_buckets=2, precision="int8")


@pytest.mark.parametrize("entry", ["ensure_mutable", "insert_rows", "delete_ids",
                                   "compact_store", "DynamicIndex"])
def test_mutation_refuses_a_virtual_store(built, entry):
    """Every mutation entry point refuses a virtual store (it holds no rows
    to write), with the JAX package's message (tests/test_mutation.py::
    test_mutation_rejects_virtual_store); DynamicIndex.from_built of a
    tensor packs it."""
    pidx, pred, data = built["pidx"], built["pred"], built["data"]
    corpus = built["corpora"]["float32"][0]
    store = pidx.get_bucket_store(corpus, pred)
    calls = {
        "ensure_mutable": lambda: pmut.ensure_mutable(store),
        "insert_rows": lambda: pmut.insert_rows(store, data[:2], np.array([0, 1]),
                                                np.array([5001, 5002])),
        "delete_ids": lambda: pmut.delete_ids(store, np.array([1, 2])),
        "compact_store": lambda: pmut.compact_store(store),
        "DynamicIndex": lambda: pmut.DynamicIndex(pidx, store),
    }
    with pytest.raises(ValueError, match="packed") as caught:
        calls[entry]()
    jstore = built["jidx"].get_bucket_store(jnp.asarray(data), pred)
    with pytest.raises(ValueError, match="packed") as jcaught:
        jmut.ensure_mutable(jstore)
    assert str(caught.value).split(" needs ", 1)[1] == str(jcaught.value).split(" needs ", 1)[1]
    assert not lmi.DynamicIndex.from_built(pidx, corpus, pred).store.virtual


def test_get_bucket_store_of_a_tensor_keeps_no_copy(built):
    """A tensor (or an (int8 tensor, row scales) pair) gets a virtual store
    over the tensor itself, cached by identity; host rows still get a
    packed store; prepare_packed_store packs and leaves the cache alone."""
    pidx, pred, data = built["pidx"], built["pred"], built["data"]
    corpus = torch.as_tensor(data)
    store = pidx.get_bucket_store(corpus, pred)
    assert store.virtual and store.data_ref.data_ptr() == corpus.data_ptr()
    assert pidx.get_bucket_store(corpus, pred) is store
    packed = pidx.prepare_packed_store(corpus, pred)
    assert not packed.virtual and pidx.get_bucket_store(corpus, pred) is store
    q8, sc = built["corpora"]["int8"][0]
    v8 = pidx.get_bucket_store((q8, sc), pred)
    assert v8.virtual and v8.data_ref is q8 and torch.equal(v8.row_scales, sc)
    host = pidx.get_bucket_store(data, pred)
    assert not host.virtual and host.chunk_data.dtype == torch.float32


def test_search_server_serves_a_virtual_store(built):
    """SearchServer reads the width from the corpus and answers as a search
    of the same store; mutation requests are refused as over any plain
    (index, store) pair."""
    pidx, pred, queries = built["pidx"], built["pred"], built["queries"]
    corpus = built["corpora"]["bfloat16"][0]
    store = pidx.get_bucket_store(corpus, pred)
    with SearchServer(pidx, store, k=10, n_buckets=3, warmup=False) as server:
        assert server.d == 24
        sd, si = server.search(queries[:20])
        with pytest.raises(ValueError, match="immutable"):
            server.insert(queries[:1])
    d, i, _ = pidx.search(None, queries[:20], None, queries[:20], pred, n_buckets=3, k=10,
                          store=store)
    np.testing.assert_array_equal(si, i)
    np.testing.assert_array_equal(sd, d)
