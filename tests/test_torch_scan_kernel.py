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
    # the widest list is 1024: k = 1018 + a rerank margin of 6 fits, 1025 does not
    scan_kernel.scan_pairs(*args, k=1024, qtile=qtile, chunk=chunk, mode="f32")
    with pytest.raises(ValueError, match="k <= 1024"):
        scan_kernel.scan_pairs(*args, k=1025, qtile=qtile, chunk=chunk, mode="f32")
    with pytest.raises(ValueError, match="mode"):
        scan_kernel.scan_pairs(*args, k=k, qtile=qtile, chunk=chunk, mode="fp8")


@pytest.mark.parametrize(
    "mode,store_dtype,d",
    [("bf16", torch.int8, 768), ("bf16", torch.int8, 100), ("bf16", torch.bfloat16, 100),
     ("bf16", torch.float32, 7), ("int8", torch.int8, 96), ("int8", torch.int8, 100),
     ("f32", torch.int8, 768), ("f32", torch.int8, 100), ("f32", torch.bfloat16, 96),
     ("f32", torch.bfloat16, 100)],
)
def test_operand_queries_layout(mode, store_dtype, d):
    """The query rows of the tensor-core bodies, 16-byte aligned: bf16
    rounded to nearest even (or the int8 rows) zero-padded to whole
    16-value groups; in mode f32 the three terms of split_f32, each
    zero-padded to whole 32-value slices, hi, mid and lo of each slice
    side by side.  Over an int8 store every bf16 group of 16 is in
    WIDEN_ORDER, over a bf16 store it is not."""
    q = torch.as_tensor(np.random.default_rng(d).normal(size=(5, d)).astype(np.float32))
    if mode == "int8":
        q, _ = quantize_rows(q)
    out = scan_kernel.operand_queries(q, mode, store_dtype)
    group = 32 if mode == "f32" else 16
    dq = -(-d // group) * group
    terms = scan_kernel.split_f32(q) if mode == "f32" else (q,)
    assert out.dtype == (torch.int8 if mode == "int8" else torch.bfloat16)
    assert out.shape == (5, len(terms) * dq) and out.is_contiguous() and out.data_ptr() % 16 == 0
    padded = []
    for t in terms:
        e = torch.zeros((5, dq), dtype=out.dtype)
        e[:, :d] = t.to(out.dtype)
        if mode != "int8" and store_dtype == torch.int8:
            e = e.reshape(5, -1, 16)[:, :, list(scan_kernel.WIDEN_ORDER)].reshape(5, dq)
        padded.append(e)
    expect = torch.empty_like(out)
    for s0 in range(0, dq, group):
        for j, e in enumerate(padded):
            col = len(terms) * s0 + j * group
            expect[:, col : col + group] = e[:, s0 : s0 + group]
    assert torch.equal(out, expect)


def _split_values(kind):
    rng = np.random.default_rng(11)
    if kind.startswith("unit"):
        x = rng.normal(size=(64, int(kind[4:])))
        return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32).ravel()
    if kind == "binade_edges":  # 2^e, its neighbours, and the top of the binade
        p = np.float32(2.0) ** np.arange(-109, 127, 3).astype(np.float32)
        v = np.concatenate([p, np.nextafter(p, np.float32(0)), np.nextafter(p, np.float32(np.inf)),
                            p * np.float32(1.5), p * (np.float32(2) - np.float32(2.0**-23))])
    elif kind == "tiny":  # from 2^-122 (normal, split not exact below 2^-110) up
        m = rng.integers(2**23, 2**24, 500).astype(np.float64)
        v = np.concatenate([m * 2.0 ** rng.integers(-145, -90, 500),
                            [2.0**-110 * (1 + 2.0**-23), 1e-30, 1e-33, 2.0**-126]]).astype(np.float32)
    else:  # large, below bf16's overflow edge (0x7F7F8000 rounds up to inf)
        edge = np.array([0x7F7F7FFF, 0x7F7F0000, 0x7F000001], np.uint32).view(np.float32)
        m = rng.integers(2**23, 2**24, 500).astype(np.float64)
        v = np.concatenate([m * 2.0 ** rng.integers(80, 104, 500), edge, [3.3e38, 1e38]]).astype(np.float32)
    return np.concatenate([v, -v, [0.0]]).astype(np.float32)


@pytest.mark.parametrize("kind", ["unit768", "unit96", "unit100", "binade_edges", "tiny", "large"])
def test_split_f32_is_exact(kind):
    """hi + mid + lo reproduces every tested f32 exactly (float64 sums of
    the three bf16 terms), with each term what rounding to nearest even
    leaves; below 2^-110 the part under bf16's smallest subnormal is lost,
    less than 2^-133."""
    v = _split_values(kind)
    q = torch.as_tensor(v)
    hi, mid, lo = scan_kernel.split_f32(q)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    exact = q.abs() >= 2.0**-110
    assert torch.equal(total[exact | (q == 0)], q.double()[exact | (q == 0)])
    assert ((total - q.double()).abs()[~exact] < 2.0**-133).all()
    assert torch.equal(hi, q.to(torch.bfloat16))
    assert torch.equal(mid, (q - hi.float()).to(torch.bfloat16))
    assert torch.isfinite(hi).all()


@pytest.mark.parametrize("store_kind", ["int8", "bf16"])
def test_three_term_product_matches_plain_f32(store_kind):
    """The three-term product read from the operand rows the kernel's f32
    body takes over an int8 or bf16 store: the three terms of each
    32-value slice, each bf16 depth k' paired with store value
    WIDEN_ORDER[k'] of its 16-group over int8, every product exact and
    summed in float64, the distance folded in f32.  It equals the plain
    f32 version's distances within 1e-6, at every candidate the plain
    version returns and over every (query, slot).  This checks the
    operand layout and the split end to end, not the kernel's rounding:
    its truncating tensor-core sums and rounded per-step adds are not
    modelled (tests/test_torch_cuda.py holds the kernel itself to the
    plain version)."""
    store, queries, order, qtile, k, chunk = _setup("multichunk", "int8" if store_kind == "int8" else "f32")
    if store_kind == "int8":
        scales = np.array(store.chunk_scales)
    else:
        scales = (np.asarray(store.chunk_ids).reshape(-1) > 0).astype(np.float32)
    _, args = _torch_inputs(store, scales, queries, order, qtile, "f32")
    args = list(args)
    if store_kind == "bf16":
        args[5] = args[5].to(torch.bfloat16)
    q, x, sc = args[0], args[5], args[6]
    op = scan_kernel.operand_queries(q, "f32", x.dtype)
    n, d = q.shape
    qd = op.shape[1] // 3
    terms = op.reshape(n, qd // 32, 3, 32).permute(2, 0, 1, 3).reshape(3, n, qd).double()
    xp = torch.zeros((x.shape[0], qd), dtype=torch.float64)
    xp[:, :d] = x.double()
    if x.dtype == torch.int8:
        xp = xp.reshape(-1, qd // 16, 16)[:, :, list(scan_kernel.WIDEN_ORDER)].reshape(-1, qd)
    raw = (terms @ xp.T).sum(0).float()
    emul = raw * (-sc) + torch.where(sc == 0.0, torch.inf, 1.0)
    plain = (q @ x.float().T) * (-sc) + torch.where(sc == 0.0, torch.inf, 1.0)
    fin = torch.isfinite(plain)
    assert torch.equal(fin, torch.isfinite(emul))
    assert (emul[fin] - plain[fin]).abs().max() <= 1e-6
    rd, rs = scan_kernel.scan_pairs_reference(*args, k=k, qtile=qtile, chunk=chunk, mode="f32")
    rows = args[1].reshape(-1, qtile)
    hit = rs >= 0
    got = emul[rows[:, :, None].expand_as(rs).long().clamp_min(0), rs.long().clamp_min(0)]
    assert hit.sum() > 0
    assert (got[hit] - rd[hit]).abs().max() <= 1e-6


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
