"""The port's host-facing ``scan_buckets`` against the JAX package's: the
five scan cases of tests/test_bucket_store.py on the same seeded stores,
at the JAX default ``precision="highest"``, to the reference's parity bar
(``rtol=1e-4, atol=1e-5``; ids differ only where the distances tie
exactly), ids ``uint32`` 1-based with 0 = none.  The port's store lies on
the CPU, so its scan is the kernel's plain version."""

import numpy as np
import pytest
import torch

from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
from learnedmetricindex_tpu.index.bucket_store import scan_buckets as jax_scan_buckets
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_buckets

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _stores(n=600, d=16, n_buckets=7, chunk=64, seed=0):
    """tests/test_bucket_store.py::_make_store, in both packages."""
    data, queries = synthetic_blobs(n, d, 50, seed=seed)
    bucket_ids = np.random.default_rng(seed).integers(0, n_buckets, size=n)
    return (queries, JaxStore.build(data, bucket_ids, n_buckets, chunk=chunk),
            BucketStore.build(data, bucket_ids, n_buckets, chunk=chunk, device=CPU))


def _parity(queries, jstore, store, order, k):
    jd, ji = jax_scan_buckets(jstore, queries, order, k=k)
    pd, pi = scan_buckets(store, queries, order, k=k)
    assert pd.dtype == np.float32 and pi.dtype == np.uint32 and pd.shape == (len(queries), k)
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    assert ((pi == 0) == np.isinf(pd)).all()
    mism = pi != ji
    if mism.any():  # only at exact ties
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)
    return pd, pi


def _full_visit(n_queries):
    return np.tile(np.arange(7, dtype=np.int64), (n_queries, 1))


def _subset(n_queries):
    return np.tile(np.array([0, 3], dtype=np.int64), (n_queries, 1))


def _per_query(n_queries):
    rng = np.random.default_rng(42)
    return np.stack([rng.choice(7, size=2, replace=False)
                     for _ in range(n_queries)]).astype(np.int64)


def _invalid(n_queries):
    order = np.full((n_queries, 3), -1, dtype=np.int64)
    order[0, 0] = 2
    return order


@pytest.mark.parametrize("order_of,k", [(_full_visit, 10), (_subset, 5), (_per_query, 3),
                                        (_invalid, 4)],
                         ids=["full_visit", "subset_of_buckets", "per_query_buckets",
                              "invalid_and_empty_visits"])
def test_scan_buckets_matches_jax(order_of, k):
    queries, jstore, store = _stores()
    pd, pi = _parity(queries, jstore, store, order_of(len(queries)), k)
    if order_of is _invalid:
        assert np.isfinite(pd[0]).all() and np.isinf(pd[1:]).all() and (pi[1:] == 0).all()


def test_scan_buckets_empty_bucket_zero_chunks():
    data, queries = synthetic_blobs(100, 8, 5, seed=1)
    bucket_ids = np.zeros(100, dtype=np.int64)  # everything in bucket 0 of 4
    jstore = JaxStore.build(data, bucket_ids, 4, chunk=32)
    store = BucketStore.build(data, bucket_ids, 4, chunk=32, device=CPU)
    order = np.tile(np.array([1, 0, 3], dtype=np.int64), (5, 1))
    _parity(queries, jstore, store, order, 3)


def test_scan_buckets_takes_the_jax_signature():
    """The JAX signature's arguments in its positions; ``items_per_step``,
    ``approx_recall`` and ``engine`` change nothing, and the defaults are
    ``precision="highest"`` without rerank."""
    queries, _, store = _stores()
    order = _per_query(len(queries))
    d0, i0 = scan_buckets(store, queries, order, 4)
    d1, i1 = scan_buckets(store, queries, order, 4, 128, 3, "highest", 0.9, False, 6, "auto")
    np.testing.assert_array_equal(d0, d1)
    np.testing.assert_array_equal(i0, i1)
    d2, i2 = scan_buckets(store, torch.as_tensor(queries), order, 4, engine="xla",
                          precision="highest", rerank=False)
    np.testing.assert_array_equal(d0, d2)
    np.testing.assert_array_equal(i0, i2)
