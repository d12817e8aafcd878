"""The port's bucket scan against the JAX package: the plain version of
the scan kernel against the Pallas kernel (interpret mode on the CPU),
the scan plan, the dense merge and the exact rerank.  The CUDA kernel
itself is held against the plain version in test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index.bucket_store import BucketStore as JaxStore
from learnedmetricindex_tpu.index.bucket_store import (
    _build_plan_device,
    _merge_pairs_dense,
    _rerank_exact_slots,
    build_scan_plan,
)
from learnedmetricindex_tpu.ops.quantize import quantize_rows as jax_quantize_rows
from learnedmetricindex_tpu.ops.scan_kernel import pallas_host_args, pallas_scan_pairs
from learnedmetricindex_tpu_torch.index.bucket_store import (
    build_plan,
    merge_pairs,
    rerank_exact_slots,
)
from learnedmetricindex_tpu_torch.ops import scan_kernel
from learnedmetricindex_tpu_torch.ops.quantize import quantize_rows
from learnedmetricindex_tpu_torch.ops.select import largest_k, smallest_k

torch.set_num_threads(2)

# (n, d, n_buckets, chunk, n_queries, visits, qtile, k, empty bucket)
CASES = {
    "multichunk": (900, 16, 6, 64, 40, 3, 16, 10, 4),
    "k24_qtile16": (700, 32, 5, 64, 30, 5, 16, 24, None),
    "qtile8_empty": (400, 24, 6, 32, 20, 2, 8, 5, 2),
}


def _setup(case, mode, seed=3):
    n, d, nb, chunk, nq, v, qtile, k, empty = CASES[case]
    data, queries = synthetic_blobs(n, d, nq, seed=seed)
    rng = np.random.default_rng(seed)
    bucket_ids = rng.integers(0, nb, size=n)
    if empty is not None:
        bucket_ids[bucket_ids == empty] = (empty + 1) % nb
    if mode == "int8":
        store = JaxStore.build_packed_int8(data, bucket_ids, nb, chunk=chunk)
    else:
        store = JaxStore.build(data, bucket_ids, nb, chunk=chunk)
    order = np.stack([rng.choice(nb, size=v, replace=False) for _ in range(nq)]).astype(np.int64)
    order[rng.random(nq) < 0.3, -1] = -1  # unused visit slots
    return store, queries, order, qtile, k, chunk


def _jax_pairs(store, queries, order, qtile, k, chunk, mode):
    plan = build_scan_plan(store, order, qtile=qtile)
    n_pairs = len(plan.qidx) // qtile
    im, ic, wr, sf, written = pallas_host_args(store, plan, qtile, n_pairs)
    qidx = jnp.asarray(plan.qidx)
    valid = qidx >= 0
    g = jnp.maximum(qidx, 0)
    qs2 = None
    if mode == "int8":
        q_int, q_sc = jax_quantize_rows(jnp.asarray(queries))
        wq = jnp.where(valid[:, None], q_int[g], 0)
        qs2 = jnp.where(valid, q_sc[g], 0.0).reshape(n_pairs, qtile)
    else:
        wq = jnp.where(valid[:, None], jnp.asarray(queries)[g], 0.0)
    cd, cs = pallas_scan_pairs(
        wq, jnp.asarray(im), jnp.asarray(ic), jnp.asarray(wr), store.chunk_data,
        jnp.asarray(sf), qs2, k=k, qtile=qtile, chunk=chunk, n_pairs=n_pairs,
        compute=mode, interpret=True,
    )
    return plan, np.asarray(sf), written, np.asarray(cd)[:n_pairs], np.asarray(cs)[:n_pairs]


def _torch_inputs(store, scales_flat, queries, order, qtile, mode):
    plan = build_plan(torch.as_tensor(order), store.n_buckets, qtile)
    q = torch.as_tensor(queries)
    qs = None
    if mode == "int8":
        q, qs = quantize_rows(q)
    args = (
        q, plan.qidx, plan.pair_bucket,
        torch.as_tensor(store.bucket_chunk_start, dtype=torch.int32),
        torch.arange(store.n_chunks, dtype=torch.int32),
        torch.as_tensor(np.array(store.chunk_data)),
        torch.as_tensor(np.array(scales_flat)),
        qs,
    )
    return plan, args


@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_scan_matches_pallas_kernel(case, mode):
    """Per pair and real query, the plain version's candidates equal the
    Pallas kernel's after sorting both by (distance, slot); slots may
    differ only at exact distance ties.  Pairs of empty buckets are
    never written by the Pallas kernel and are all fill here."""
    store, queries, order, qtile, k, chunk = _setup(case, mode)
    jplan, sf, written, jd, js = _jax_pairs(store, queries, order, qtile, k, chunk, mode)
    plan, args = _torch_inputs(store, sf, queries, order, qtile, mode)
    assert plan.n_pairs == len(jplan.qidx) // qtile
    td, ts = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=chunk, mode=mode)
    td, ts = td.numpy(), ts.numpy()
    real = (jplan.qidx >= 0).reshape(-1, qtile)
    checked = 0
    for p in range(plan.n_pairs):
        for q in np.nonzero(real[p])[0]:
            if not written[p]:
                assert np.isinf(td[p, q]).all() and (ts[p, q] == -1).all()
                continue
            o = np.lexsort((js[p, q], jd[p, q]))
            np.testing.assert_allclose(td[p, q], jd[p, q][o], rtol=1e-4, atol=1e-5)
            mism = ts[p, q] != js[p, q][o]
            if mism.any():
                np.testing.assert_allclose(td[p, q][mism], jd[p, q][o][mism], rtol=1e-6, atol=1e-7)
            checked += 1
    assert checked > 0
    # padding query slots are all fill
    assert np.isinf(td[~real]).all() and (ts[~real] == -1).all()


@pytest.mark.parametrize("v,seed", [(1, 0), (3, 4), (5, 9)])
def test_plan_matches_device_plan(v, seed):
    """qidx and pair_rows equal the JAX package's device-built plan."""
    data, _ = synthetic_blobs(1500, 8, 1, seed=seed)
    rng = np.random.default_rng(seed)
    nb, qtile = 9, 16
    bucket_ids = rng.integers(0, nb, size=1500)
    bucket_ids[bucket_ids == 5] = 6  # an empty bucket still owns visits
    store = JaxStore.build(data, bucket_ids, nb, chunk=64)
    order = np.stack([rng.choice(nb, v, replace=False) for _ in range(70)]).astype(np.int32)
    if v > 1:
        order[rng.random(70) < 0.3, -1] = -1
    QP_env = -(-(70 * v) // qtile) * qtile + nb * qtile
    qd, _, _, _, prd, _, _ = _build_plan_device(
        jnp.asarray(order),
        jnp.asarray(store.bucket_chunk_start.astype(np.int32)),
        jnp.asarray(np.arange(int(store.bucket_chunk_start[-1]), dtype=np.int32)),
        qtile=qtile, G=8, QP_env=QP_env, W_env=4096,
    )
    plan = build_plan(torch.as_tensor(order), nb, qtile)
    qidx = plan.qidx.numpy()
    np.testing.assert_array_equal(qidx, np.asarray(qd)[: len(qidx)])
    assert (np.asarray(qd)[len(qidx):] == -1).all()
    ok = order.reshape(-1) >= 0
    rows = plan.pair_rows.numpy()
    np.testing.assert_array_equal(rows[ok], np.asarray(prd)[ok])
    assert (rows[~ok] == -1).all()
    # each pair's bucket is the bucket of the visits it holds
    pb = plan.pair_bucket.numpy()
    np.testing.assert_array_equal(pb[rows[ok] // qtile], order.reshape(-1)[ok])


def test_merge_matches_dense_merge():
    rng = np.random.default_rng(2)
    Q, V, k, R = 30, 4, 7, 400
    cand_d = rng.random((R, k)).astype(np.float32)
    cand_d[rng.random((R, k)) < 0.1] = np.inf
    cand_d[5:9] = cand_d[0]  # exact ties across rows
    cand_s = np.where(np.isinf(cand_d), -1, rng.integers(0, 10_000, (R, k))).astype(np.int32)
    pair_rows = rng.integers(0, R, Q * V).astype(np.int64)
    pair_rows[rng.random(Q * V) < 0.2] = -1
    ok = pair_rows >= 0
    jd, js = _merge_pairs_dense(
        jnp.asarray(cand_d), jnp.asarray(cand_s),
        jnp.asarray(np.where(ok, pair_rows, 0).astype(np.int32)), jnp.asarray(ok), k=k, V=V,
    )
    td, ts = merge_pairs(torch.as_tensor(cand_d), torch.as_tensor(cand_s),
                         torch.as_tensor(pair_rows), k=k, V=V)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("store_kind", ["f32", "int8"])
def test_rerank_matches_exact_slot_rerank(store_kind):
    data, queries = synthetic_blobs(600, 32, 25, seed=8)
    rng = np.random.default_rng(8)
    if store_kind == "int8":
        store = JaxStore.build_packed_int8(data, rng.integers(0, 4, 600), 4, chunk=64)
        scales = np.array(store.chunk_scales)
    else:
        store = JaxStore.build(data, rng.integers(0, 4, 600), 4, chunk=64)
        scales = (np.asarray(store.chunk_ids).reshape(-1) > 0).astype(np.float32)
    n_slots = store.chunk_data.shape[0]
    cand_s = rng.integers(0, n_slots, (25, 12)).astype(np.int32)
    cand_s[rng.random((25, 12)) < 0.2] = -1
    cand_d = np.zeros((25, 12), np.float32)
    jd, js = _rerank_exact_slots(
        jnp.asarray(cand_d), jnp.asarray(cand_s), jnp.asarray(queries),
        store.chunk_data, jnp.asarray(scales), k=6,
    )
    td, ts = rerank_exact_slots(
        torch.as_tensor(cand_s), torch.as_tensor(queries),
        torch.as_tensor(np.array(store.chunk_data)), torch.as_tensor(scales), k=6,
    )
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)
    mism = ts.numpy() != np.asarray(js)
    if mism.any():
        np.testing.assert_allclose(td.numpy()[mism], np.asarray(jd)[mism], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [0, 1])
def test_smallest_k_is_stable_topk(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (50, 40)).astype(np.float32) / 2  # many ties
    x[rng.random(x.shape) < 0.1] = np.inf
    x[:, 0] = -0.0
    x[:, 1] = 0.0
    vals, idx = smallest_k(torch.as_tensor(x), 9)
    ref = np.argsort(x, axis=1, kind="stable")[:, :9]
    np.testing.assert_array_equal(idx.numpy(), ref)
    np.testing.assert_array_equal(vals.numpy(), np.take_along_axis(x, ref, 1))
    lv, li = largest_k(torch.as_tensor(x), 5)
    ref = np.argsort(-x, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(li.numpy(), ref)


def test_wrapper_runs_plain_version_on_cpu_and_validates():
    store, queries, order, qtile, k, chunk = _setup("multichunk", "f32")
    scales = (np.asarray(store.chunk_ids).reshape(-1) > 0).astype(np.float32)
    _, args = _torch_inputs(store, scales, queries, order, qtile, "f32")
    before = scan_kernel.LAUNCHES
    out = scan_kernel.scan_pairs(*args, k=k, qtile=qtile, chunk=chunk, mode="f32")
    ref = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=chunk, mode="f32")
    assert scan_kernel.LAUNCHES == before  # the plain version is not a launch
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="int8"):
        scan_kernel.scan_pairs(*args, k=k, qtile=qtile, chunk=chunk, mode="int8")
    # the widest list is 256: k = 250 + a rerank margin of 6 fits, 257 does not
    scan_kernel.scan_pairs(*args, k=256, qtile=qtile, chunk=chunk, mode="f32")
    with pytest.raises(ValueError, match="k <= 256"):
        scan_kernel.scan_pairs(*args, k=257, qtile=qtile, chunk=chunk, mode="f32")
    with pytest.raises(ValueError, match="mode"):
        scan_kernel.scan_pairs(*args, k=k, qtile=qtile, chunk=chunk, mode="fp8")


@pytest.mark.parametrize(
    "mode,store_dtype,d",
    [("bf16", torch.int8, 768), ("bf16", torch.int8, 100), ("bf16", torch.bfloat16, 100),
     ("bf16", torch.float32, 7), ("int8", torch.int8, 96), ("int8", torch.int8, 100)],
)
def test_operand_queries_layout(mode, store_dtype, d):
    """The query rows of the tensor-core modes: bf16 rounded to nearest
    even (or the int8 rows), zero-padded to whole 16-value groups, 16-byte
    aligned, and over an int8 store in WIDEN_ORDER within each group."""
    q = torch.as_tensor(np.random.default_rng(d).normal(size=(5, d)).astype(np.float32))
    if mode == "int8":
        q, _ = quantize_rows(q)
    out = scan_kernel.operand_queries(q, mode, store_dtype)
    dq = -(-d // 16) * 16
    assert out.dtype == (torch.bfloat16 if mode == "bf16" else torch.int8)
    assert out.shape == (5, dq) and out.is_contiguous() and out.data_ptr() % 16 == 0
    expect = torch.zeros((5, dq), dtype=out.dtype)
    expect[:, :d] = q.to(out.dtype)
    if mode == "bf16" and store_dtype == torch.int8:
        expect = expect.reshape(5, -1, 16)[:, :, list(scan_kernel.WIDEN_ORDER)].reshape(5, dq)
    assert torch.equal(out, expect)


def test_widen_order_pairs_each_query_value_with_its_store_value():
    """One 16-deep m16n8k16 step of the bf16-over-int8 body, from the PTX
    fragment layouts: ldmatrix hands lane t of a quad the int8 values
    4t..4t+3 of the row slice, widened into the B registers of depths
    (2t, 2t+1) and (2t+8, 2t+9).  Depth k' of the A fragment holds query
    value WIDEN_ORDER[k'], so it must meet store value WIDEN_ORDER[k']."""
    placed = np.full(16, -1)
    for t in range(4):
        placed[[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = [4 * t, 4 * t + 1, 4 * t + 2, 4 * t + 3]
    np.testing.assert_array_equal(placed, scan_kernel.WIDEN_ORDER)


def test_int8_to_bf16_widening_is_exact():
    """The kernel widens int8 v through the f32 with bits 0x4B0000uu
    (2^23 + uu, uu = byte ^ 0x80) minus 2^23 + 128: exactly v for all 256
    values, and exact again in bf16."""
    v = np.arange(-128, 128)
    bits = np.uint32(0x4B000000) | ((v.astype(np.int8).view(np.uint8) ^ 0x80).astype(np.uint32))
    f = bits.view(np.float32) - np.float32(8388736.0)
    np.testing.assert_array_equal(f, v.astype(np.float32))
    assert torch.equal(torch.as_tensor(f).bfloat16().float(), torch.as_tensor(f))
