"""The row gathers against the JAX package's Pallas gather kernel and its
merge, and the search's gather-kernel mode: bit-identical to the default
mode and equal to the JAX package's search."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.index.bucket_store import _merge_pairs_dense as jax_merge_pairs
from learnedmetricindex_tpu.ops.gather_kernel import gather_rows as jax_gather_rows
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, merge_pairs
from learnedmetricindex_tpu_torch.ops import gather_kernel
from learnedmetricindex_tpu_torch.ops.gather_kernel import (
    gather_pairs,
    gather_pairs_reference,
    gather_rows,
    gather_rows_ok,
    gather_rows_reference,
)

torch.set_num_threads(2)

TABLES = {
    "float32": (np.float32, torch.float32, 128),
    "int32": (np.int32, torch.int32, 128),
    "int8": (np.int8, torch.int8, 256),
    "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 128),
}


def _table(rng, name, n):
    np_dtype, torch_dtype, d = TABLES[name]
    vals = rng.integers(-100, 100, (n, d))
    if name == "bfloat16":
        host = (vals / 7.0).astype(np.float32)
        return host.astype(np_dtype), torch.as_tensor(host).to(torch.bfloat16)
    host = vals.astype(np_dtype)
    return host, torch.as_tensor(host)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_plain_gather_matches_pallas_kernel(name):
    """Bit-equal to the JAX kernel in interpret mode, out-of-range indices
    clamped to the first and last rows."""
    rng = np.random.default_rng(3)
    host, table = _table(rng, name, 300)
    idx = rng.integers(0, 300, 200).astype(np.int32)
    idx[:4] = [-5, -1, 300, 10_000]
    ref = np.asarray(jax_gather_rows(jnp.asarray(host), jnp.asarray(idx), block_rows=64,
                                     interpret=True))
    for index_dtype in (torch.int32, torch.int64):
        got = gather_rows_reference(table, torch.as_tensor(idx).to(index_dtype))
        assert got.dtype == table.dtype and got.shape == (200, table.shape[1])
        np.testing.assert_array_equal(got.view(torch.uint8).numpy(), ref.view(np.uint8))
        # the wrapper on a CPU tensor is the plain version, no launch
        before = gather_kernel.LAUNCHES
        assert torch.equal(gather_rows(table, torch.as_tensor(idx).to(index_dtype)), got)
        assert gather_kernel.LAUNCHES == before
    np.testing.assert_array_equal(ref[:4], host[[0, 0, 299, 299]])


def test_gather_gate_and_validation():
    assert gather_rows_ok(torch.zeros((4, 768), dtype=torch.int8))
    assert gather_rows_ok(torch.zeros((4, 6), dtype=torch.bfloat16))
    assert not gather_rows_ok(torch.zeros((4, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="multiple of 4 bytes"):
        gather_rows(torch.zeros((4, 3), dtype=torch.int8), torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32 or int64"):
        gather_rows(torch.zeros((4, 4)), torch.zeros(2))
    with pytest.raises(ValueError, match="table rows"):
        gather_rows(torch.zeros((0, 4)), torch.zeros(2, dtype=torch.int32))
    d, s, rows = torch.zeros((6, 4)), torch.zeros((6, 4), dtype=torch.int32), torch.zeros(6)
    with pytest.raises(ValueError, match="int32 or int64"):
        gather_pairs(d, s, rows, 2)
    with pytest.raises(ValueError, match="f32 distances"):
        gather_pairs(d.double(), s, rows.long(), 2)
    with pytest.raises(ValueError, match="match in shape"):
        gather_pairs(d, s[:, :3], rows.long(), 2)
    with pytest.raises(ValueError, match="Q·V"):
        gather_pairs(d, s, rows.long(), 4)


def _candidates(rng, R, k):
    """A scan's (R, k) candidate tables: ascending distances with ties and
    an unfilled tail (+inf, slot -1) in some rows."""
    d = np.sort(rng.integers(0, 40, (R, k)) / 64.0, axis=1).astype(np.float32)
    s = rng.integers(0, 10_000, (R, k)).astype(np.int32)
    tail = rng.integers(0, k + 1, R)
    for r in range(R):
        d[r, tail[r]:], s[r, tail[r]:] = np.inf, -1
    return torch.as_tensor(d), torch.as_tensor(s)


@pytest.mark.parametrize("k", [1, 3, 10, 16])
def test_gather_pairs_reference_is_the_old_merge_gather(k):
    """Bit-equal to the merge's gather and mask as the search ran it:
    torch indexing (rows clamped below) or two ``gather_rows`` (clamped
    both sides), then ``+inf`` / ``-1`` where the row is -1; with rows -1,
    0, the last and beyond the end.  On a CPU tensor the wrapper is the
    plain version and launches nothing."""
    rng = np.random.default_rng(k)
    R, V = 50, 3
    cand_d, cand_s = _candidates(rng, R, k)
    rows = rng.integers(0, R, 3 * 40)
    rows[:4] = [-1, 0, R - 1, R + 7]
    rows[rng.choice(np.arange(4, len(rows)), 10, replace=False)] = -1
    for dtype in (torch.int64, torch.int32):
        pair_rows = torch.as_tensor(rows).to(dtype)
        ok = (pair_rows >= 0)[:, None]
        # LMI_GATHER_MODE=kernel: two gather_rows, both clamps
        old_d = torch.where(ok, gather_rows_reference(cand_d, pair_rows), torch.inf)
        old_s = torch.where(ok, gather_rows_reference(cand_s, pair_rows), -1)
        gd, gs = gather_pairs_reference(cand_d, cand_s, pair_rows, V)
        assert gd.shape == gs.shape == (40, V * k) and gs.dtype == torch.int32
        assert torch.equal(gd.view(torch.int32), old_d.reshape(40, V * k).view(torch.int32))
        assert torch.equal(gs, old_s.reshape(40, V * k))
        # the default mode: torch indexing on rows clamped below (in range here)
        inside = pair_rows < R
        at = torch.clamp_min(pair_rows[inside], 0).long()
        auto_d = torch.where(ok[inside], cand_d[at], torch.inf)
        assert torch.equal(gd.reshape(-1, k)[inside].view(torch.int32), auto_d.view(torch.int32))
        assert torch.equal(gs.reshape(-1, k)[inside], torch.where(ok[inside], cand_s[at], -1))
        before = (gather_kernel.LAUNCHES, gather_kernel.PAIR_LAUNCHES)
        wd, ws = gather_pairs(cand_d, cand_s, pair_rows, V)
        assert torch.equal(wd.view(torch.int32), gd.view(torch.int32)) and torch.equal(ws, gs)
        assert (gather_kernel.LAUNCHES, gather_kernel.PAIR_LAUNCHES) == before


@pytest.mark.parametrize("k,V", [(16, 4), (3, 2), (1, 5)])
def test_merge_pairs_matches_jax_merge(k, V):
    """The port's merge in both gather modes against the JAX package's
    ``_merge_pairs_dense`` on the same candidates: the same distances,
    bit for bit, and the same slots (ties to the earlier visit, then
    the earlier candidate; -1 past the last candidate)."""
    rng = np.random.default_rng(10 * k + V)
    R, Q = 64, 30
    cand_d, cand_s = _candidates(rng, R, k)
    rows = rng.integers(0, R, Q * V)
    rows[rng.choice(Q * V, Q, replace=False)] = -1
    rows[:V] = -1  # a query with no candidate at all
    jd, js = jax_merge_pairs(
        jnp.asarray(cand_d.numpy()), jnp.asarray(cand_s.numpy()),
        jnp.asarray(np.maximum(rows, 0).astype(np.int32)), jnp.asarray(rows >= 0), k=k, V=V)
    jd, js = np.asarray(jd), np.asarray(js)
    for kernel in (False, True):
        pd, ps = merge_pairs(cand_d, cand_s, torch.as_tensor(rows), k=k, V=V,
                             gather_kernel=kernel)
        np.testing.assert_array_equal(pd.numpy().view(np.uint32), jd.view(np.uint32))
        np.testing.assert_array_equal(ps.numpy(), js)
    assert np.isinf(jd[0]).all() and (js[0] == -1).all()


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A 1-level index built by the JAX package and loaded by the port."""
    data, queries = synthetic_blobs(2400, 32, 90, n_clusters=14, seed=5)
    cfg = jlmi.BuildConfiguration("kmeans", 8, "MLP-2", 0.01, [8], seed=5, chunk_size=64)
    jidx, pred, _, _, _ = jlmi.LearnedIndexBuilder(data, cfg).build()
    path = str(tmp_path_factory.mktemp("gather") / "index.npz")
    jidx.save(path, pred)
    pidx, ppred = lmi.load_index(path, "cpu")
    return data, queries, jidx, pidx, ppred


@pytest.mark.parametrize("precision", ["default", "highest", "int8"])
def test_kernel_mode_is_bit_identical_to_auto(built, monkeypatch, precision):
    data, queries, _, pidx, pred = built
    if precision == "int8":
        store = BucketStore.build_packed_int8(
            data, pidx.bucket_ids_from_prediction(pred), 8, chunk=64, device="cpu")
    else:
        store = pidx.get_bucket_store(data, pred)
    out = {}
    for mode in ("auto", "kernel"):
        monkeypatch.setenv("LMI_GATHER_MODE", mode)
        d, i, _ = pidx.search(None, queries, data, queries, pred, n_buckets=3, k=10,
                              store=store, precision=precision)
        out[mode] = (d, i)
    np.testing.assert_array_equal(out["auto"][0].view(np.uint32), out["kernel"][0].view(np.uint32))
    np.testing.assert_array_equal(out["auto"][1], out["kernel"][1])


def test_kernel_mode_matches_jax_search(built, monkeypatch):
    """The port in gather-kernel mode against the JAX package's default
    mode (its kernel mode calls the Pallas gather without interpret and
    so cannot run on a CPU), to the parity bar of ROADMAP.md."""
    data, queries, jidx, pidx, pred = built
    jd, ji, _ = jidx.search(None, queries, data, queries, pred, n_buckets=3, k=10,
                            precision="highest")
    monkeypatch.setenv("LMI_GATHER_MODE", "kernel")
    pd, pi, _ = pidx.search(None, queries, data, queries, pred, n_buckets=3, k=10,
                            precision="highest")
    jd, ji = np.asarray(jd), np.asarray(ji)
    np.testing.assert_allclose(pd, jd, rtol=1e-4, atol=1e-5)
    mism = pi != ji
    if mism.any():
        np.testing.assert_allclose(pd[mism], jd[mism], rtol=1e-6, atol=1e-7)
