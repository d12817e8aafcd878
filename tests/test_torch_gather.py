"""The row gather against the JAX package's Pallas gather kernel, and the
search's gather-kernel mode: bit-identical to the default mode and equal
to the JAX package's search."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.ops.gather_kernel import gather_rows as jax_gather_rows
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore
from learnedmetricindex_tpu_torch.ops import gather_kernel
from learnedmetricindex_tpu_torch.ops.gather_kernel import (
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
