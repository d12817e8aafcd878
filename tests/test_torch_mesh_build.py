"""The multi-device build through the port's public entry points (the
cases of tests/test_mesh_public_api.py): ``LearnedIndexBuilder(...,
devices=["cpu"] * 8)`` → ``get_sharded_store`` → ``search(store=...)``,
at one and two levels, held by outcome (the two packages draw from
other PRNGs) and against the JAX package's mesh build on the same data;
then both packages' CLI with ``--shard-devices 4``."""

import os

import jax
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu import cli as jcli
from learnedmetricindex_tpu.data import synthetic_blobs
from learnedmetricindex_tpu.parallel.mesh import create_mesh as jax_create_mesh
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch import cli
from learnedmetricindex_tpu_torch.eval import load_results
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall

torch.set_num_threads(2)
pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")

CPUS = [torch.device("cpu")] * 8


def _build(data, cfg, devices):
    return lmi.LearnedIndexBuilder(data, cfg, device="cpu", devices=devices).build()


def _jax_recall(data, queries, jcfg, visit, gt):
    jidx, jpred, *_ = jlmi.LearnedIndexBuilder(data, jcfg, mesh=jax_create_mesh(8)).build()
    jstore = jidx.get_sharded_store(data, jpred, jax_create_mesh(8))
    _, ji, _ = jidx.search(data, queries, data, queries, jpred, None, n_buckets=visit, k=10,
                           store=jstore)
    return recall(np.asarray(ji), gt, 10)


@pytest.fixture(scope="module")
def built():
    data, queries = synthetic_blobs(4000, 24, 100, n_clusters=12, seed=3)
    cfg = lmi.BuildConfiguration("kmeans", 60, "MLP", 0.01, [8], seed=5)
    index, data_prediction, n_buckets, build_t, cluster_t = _build(data, cfg, CPUS)
    return data, queries, index, data_prediction, n_buckets


def test_device_build_produces_valid_index(built):
    data, queries, index, data_prediction, n_buckets = built
    assert 2 <= n_buckets <= 8
    assert (data_prediction[:, 0] >= 0).all()
    counts = np.bincount(data_prediction[:, 0], minlength=8)
    assert (counts[np.nonzero(index.leaf_valid)[0]] > 0).all()
    assert all(p.device == torch.device("cpu") for lv in index.levels for p in lv.mlp.weights)


def test_sharded_search_matches_single_device_scan(built):
    data, queries, index, data_prediction, n_buckets = built
    sharded = index.get_sharded_store(data, data_prediction, CPUS)
    assert index.get_sharded_store(data, data_prediction, CPUS) is sharded
    d_mesh, i_mesh, t_mesh = index.search(data, queries, data, queries, data_prediction, None,
                                          n_buckets=3, k=10, store=sharded)
    d_one, i_one, _ = index.search(data, queries, data, queries, data_prediction, None,
                                   n_buckets=3, k=10, precision="highest", rerank=False)
    np.testing.assert_allclose(d_mesh, d_one, rtol=1e-4, atol=1e-5)
    mism = i_mesh != i_one
    if mism.any():  # ids differ only at exact ties
        np.testing.assert_allclose(d_mesh[mism], d_one[mism], rtol=1e-6, atol=1e-7)
    assert t_mesh["search"] > 0 and t_mesh["inference"] > 0


def test_full_visit_equals_oracle_and_recall_near_jax(built):
    """Visiting every bucket is exact kNN; at visit 3 the whole-corpus
    recall is within 0.03 of the JAX package's mesh build of the same
    data and configuration."""
    data, queries, index, data_prediction, n_buckets = built
    sharded = index.get_sharded_store(data, data_prediction, CPUS)
    _, gt = exact_knn(data, queries, k=10, device="cpu")
    _, nns, _ = index.search(data, queries, data, queries, data_prediction, None,
                             n_buckets=n_buckets, k=10, store=sharded)
    assert recall(nns, gt, 10) == 1.0
    _, nns3, _ = index.search(data, queries, data, queries, data_prediction, None, n_buckets=3,
                              k=10, store=sharded)
    jcfg = jlmi.BuildConfiguration("kmeans", 60, "MLP", 0.01, [8], seed=5)
    theirs = _jax_recall(data, queries, jcfg, 3, gt)
    assert abs(recall(nns3, gt, 10) - theirs) <= 0.03, (recall(nns3, gt, 10), theirs)


def test_builder_device_arguments():
    data, _ = synthetic_blobs(300, 8, 1, n_clusters=4, seed=1)
    cfg = lmi.BuildConfiguration("kmeans", 2, "MLP-8", 0.01, [2])
    with pytest.raises(ValueError, match="devices"):
        lmi.LearnedIndexBuilder(data, cfg, device="cpu", devices=["meta", "cpu"])
    builder = lmi.LearnedIndexBuilder(data, cfg, device="cpu", devices=["cpu"] * 3)
    assert [b.shape[0] for b in builder.blocks.blocks] == [100, 100, 100]


def test_device_build_root_is_the_one_device_clustering(built):
    """The root is clustered as on one device; only the order of the
    data-parallel training's sums differs, so at least 99% of the rows
    land in the same bucket as the one-device build's."""
    data, _, _, data_prediction, _ = built
    cfg = lmi.BuildConfiguration("kmeans", 60, "MLP", 0.01, [8], seed=5)
    _, one, *_ = _build(data, cfg, None)
    assert (one[:, 0] == data_prediction[:, 0]).mean() >= 0.99


@pytest.fixture(scope="module")
def built_two_level():
    data, queries = synthetic_blobs(6000, 24, 80, n_clusters=16, seed=11)
    cfg = lmi.BuildConfiguration("kmeans", 40, "MLP", 0.02, [4, 4], seed=5)
    index, data_prediction, n_buckets, _, _ = _build(data, cfg, CPUS)
    return data, queries, index, data_prediction, n_buckets


def test_two_level_full_visit_equals_oracle(built_two_level):
    data, queries, index, data_prediction, n_buckets = built_two_level
    assert index.n_levels == 2
    sharded = index.get_sharded_store(data, data_prediction, CPUS)
    _, nns, _ = index.search(data, queries, data, queries, data_prediction, None,
                             n_buckets=n_buckets, k=10, store=sharded, policy="best_first")
    _, gt = exact_knn(data, queries, k=10, device="cpu")
    assert recall(nns, gt, 10) == 1.0


def test_two_level_partial_visit_matches_single_device(built_two_level):
    """Visit 4 over the sharded store equals the single store's search; the
    whole-corpus recall is within 0.03 of the JAX package's mesh build."""
    data, queries, index, data_prediction, n_buckets = built_two_level
    sharded = index.get_sharded_store(data, data_prediction, CPUS)
    visit = min(4, n_buckets)
    d_mesh, i_mesh, _ = index.search(data, queries, data, queries, data_prediction, None,
                                     n_buckets=visit, k=10, store=sharded)
    index._store_cache = None  # drop the sharded store from the cache
    d_one, i_one, _ = index.search(data, queries, data, queries, data_prediction, None,
                                   n_buckets=visit, k=10)
    np.testing.assert_allclose(d_mesh, d_one, rtol=1e-5, atol=1e-6)
    mism = i_mesh != i_one
    if mism.any():  # only exact ties may permute
        np.testing.assert_allclose(d_mesh[mism], d_one[mism], rtol=1e-6, atol=1e-7)
    _, gt = exact_knn(data, queries, k=10, device="cpu")
    assert recall(i_mesh, gt, 10) >= 0.5
    jcfg = jlmi.BuildConfiguration("kmeans", 40, "MLP", 0.02, [4, 4], seed=5)
    theirs = _jax_recall(data, queries, jcfg, visit, gt)
    assert abs(recall(i_mesh, gt, 10) - theirs) <= 0.03, (recall(i_mesh, gt, 10), theirs)


def test_cli_shard_devices_in_both_packages(tmp_path, monkeypatch):
    """Both packages' ``main`` with ``--shard-devices 4`` on one argv (the
    JAX package on its CPU mesh, the port with ``--device cpu``, four
    repeats of the CPU): the port's result files read back, and visiting
    every bucket finds the exact neighbours in both."""
    monkeypatch.setenv("JOB_ID", "shard")
    argv = ["--synthetic", "1500", "--synthetic-dim", "16", "--n-categories", "6",
            "--epochs", "30", "--no-save", "--shard-devices", "4", "-b", "2", "6"]
    ours = cli.main(argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    theirs = jcli.main(argv + ["--out-dir", str(tmp_path / "jax")])
    assert len(ours) == len(theirs) == 2
    data, queries = synthetic_blobs(1500, 16, 100, seed=2023)
    _, gt = exact_knn(data, queries, k=10, device="cpu")
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for ours_p, theirs_p in zip(ours, theirs):
        knns, dists, attrs = load_results(ours_p)
        assert knns.shape == dists.shape == (100, 10) and attrs["algo"] == "Learned-index"
        if "-buck=6-" in ours_p:
            assert recall(knns, gt, 10) == recall(load_results(theirs_p)[0], gt, 10) == 1.0
    one = cli.parse_args(argv[:9] + ["-b", "6", "--device", "cpu"])
    assert one.shard_devices == 0
    result = cli.sweep(**cli.sweep_arguments(one), devices=["cpu"] * 2)
    assert isinstance(result.store, lmi.ShardedStore) and len(result.store.shards) == 2
