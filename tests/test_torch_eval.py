"""The port's data helpers, result files and evaluation, ``Baseline`` and
``utils/`` against the JAX package's, on the same seeded inputs."""

import csv
import json
import logging
import os

import h5py
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu import data as jdata
from learnedmetricindex_tpu import eval as jeval
from learnedmetricindex_tpu.utils import compat as jcompat
from learnedmetricindex_tpu.utils import logging as jlogging
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch import data as pdata
from learnedmetricindex_tpu_torch import eval as peval
from learnedmetricindex_tpu_torch.utils import compat, profiling
from learnedmetricindex_tpu_torch.utils.logging import Logger, log_runtime

torch.set_num_threads(2)


def _same_bits(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("kw", [
    dict(n=500, d=12, n_queries=40),
    dict(n=300, d=7, n_queries=9, n_clusters=3, seed=5, cluster_std=0.5),
    dict(n=200, d=16, n_queries=10, normalized=False, seed=11),
])
def test_synthetic_blobs_bit_equal(kw):
    for ours, theirs in zip(pdata.synthetic_blobs(**kw), jdata.synthetic_blobs(**kw)):
        _same_bits(ours, theirs)


def test_normalize_and_urls_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(50, 9)) * 10.0 ** rng.integers(-3, 3, size=(50, 1))
    x[3] = 0.0  # a zero row stays zero
    _same_bits(pdata.normalize(x), jdata.normalize(x))
    _same_bits(pdata.normalize(x.astype(np.float32)), jdata.normalize(x.astype(np.float32)))
    assert not pdata.normalize(x)[3].any()
    for kind, size in (("clip768v2", "10M"), ("pca32v2", "300K")):
        assert pdata.dataset_urls(kind, size) == jdata.dataset_urls(kind, size)
    assert pdata.KIND_TO_KEY == jdata.KIND_TO_KEY and pdata.SISAP_URL == jdata.SISAP_URL


def _stage(root, kind="pca96v2", size="100K", seed=0):
    rng = np.random.default_rng(seed)
    key = pdata.KIND_TO_KEY[kind]
    for version, n in (("dataset", 300), ("query", 16)):
        path = os.path.join(str(root), kind, size, f"{version}.h5")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with h5py.File(path, "w") as f:
            f.create_dataset(key, data=rng.normal(size=(n, 24)))


def test_prepare_uses_staged_files_and_never_downloads(tmp_path, monkeypatch):
    import urllib.request

    def no_download(*a, **k):
        raise AssertionError("prepare tried to download")

    monkeypatch.setattr(urllib.request, "urlretrieve", no_download)
    with pytest.raises(FileNotFoundError) as e:
        pdata.prepare("pca96v2", "100K", str(tmp_path), download=False)
    assert str(tmp_path) in str(e.value) and "https://" in str(e.value)
    _stage(tmp_path)
    paths = pdata.prepare("pca96v2", "100K", str(tmp_path))  # download allowed, not needed
    assert paths == jdata.prepare("pca96v2", "100K", str(tmp_path), download=False)
    assert all(os.path.exists(p) for p in paths)


@pytest.mark.parametrize("preprocess", [True, False])
def test_load_dataset_on_staged_files_equal(tmp_path, preprocess):
    _stage(tmp_path)
    ours = pdata.load_dataset("pca96v2", "100K", str(tmp_path), preprocess=preprocess,
                              download=False)
    theirs = jdata.load_dataset("pca96v2", "100K", str(tmp_path), preprocess=preprocess,
                                download=False)
    for a, b in zip(ours, theirs):
        _same_bits(a, b)
    assert ours[0].shape == (300, 24) and ours[0].dtype == np.float32


def _results(seed=0, n_q=30, k=10):
    rng = np.random.default_rng(seed)
    gt = np.stack([rng.choice(200, k, replace=False) + 1 for _ in range(n_q)]).astype(np.uint32)
    nns = gt.copy()
    swap = rng.random(gt.shape) < 0.3
    nns[swap] = rng.integers(1, 201, size=int(swap.sum()))
    dists = np.sort(rng.random((n_q, k)).astype(np.float32), axis=1)
    return dists, nns, gt


def test_store_results_files_equal_and_cross_load(tmp_path):
    """Both packages write the same datasets and attrs, and each loads the
    other's file."""
    dists, nns, _ = _results()
    args = ("Learned-index", "clip768v2", dists, nns, 12.5, 0.25, "params-x", "10M")
    peval.store_results(str(tmp_path / "port" / "r.h5"), *args)
    jeval.store_results(str(tmp_path / "jax" / "r.h5"), *args)
    loaded = {}
    for who, path in (("port", tmp_path / "port" / "r.h5"), ("jax", tmp_path / "jax" / "r.h5")):
        with h5py.File(path, "r") as f:
            loaded[who] = ({k: f[k][()] for k in f}, {k: f[k].dtype for k in f},
                           {k: f.attrs[k] for k in f.attrs})
        ours, theirs = peval.load_results(str(path)), jeval.load_results(str(path))
        for a, b in zip(ours[:2], theirs[:2]):
            _same_bits(a, b)
        assert ours[2] == theirs[2]
    (dp, tp, ap), (dj, tj, aj) = loaded["port"], loaded["jax"]
    assert tp == tj == {"knns": np.dtype(np.uint32), "dists": np.dtype(np.float32)}
    for k in dp:
        _same_bits(dp[k], dj[k])
    assert ap == aj and ap["buildtime"] == 12.5 and ap["data"] == "clip768v2"


def test_evaluate_rows_equal(tmp_path):
    paths, gt = [], None
    for seed in range(3):
        dists, nns, gt_s = _results(seed=seed)
        gt = gt_s if gt is None else gt
        path = str(tmp_path / f"r{seed}.h5")
        peval.store_results(path, "Learned-index", "kind", dists, nns, 1.0 + seed,
                            0.1 * (seed + 1), f"p{seed}", "100K")
        paths.append(path)
    with h5py.File(tmp_path / "gt.h5", "w") as f:
        f.create_dataset("knns", data=gt)
    for ground in (gt, str(tmp_path / "gt.h5")):
        assert peval.evaluate_result_file(paths[1], ground) == jeval.evaluate_result_file(
            paths[1], ground)
        ours = peval.evaluate_to_csv(paths, ground, str(tmp_path / "port.csv"), k=5)
        theirs = jeval.evaluate_to_csv(paths, ground, str(tmp_path / "jax.csv"), k=5)
        assert ours == theirs and 0.0 < ours[1]["recall"] < 1.0
        assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    _same_bits(peval.load_groundtruth(str(tmp_path / "gt.h5")),
               jeval.load_groundtruth(str(tmp_path / "gt.h5")))
    with open(tmp_path / "port.csv") as f:
        assert [r["params"] for r in csv.DictReader(f)] == ["p0", "p1", "p2"]
    assert peval.evaluate_to_csv([], gt, str(tmp_path / "none.csv")) == []


def test_plot_results_writes_a_png(tmp_path):
    rows = [{"recall": 0.5 + 0.1 * i, "querytime": 0.01 * (i + 1), "params": f"p{i}"}
            for i in range(3)]
    out = peval.plot_results(rows, str(tmp_path / "plot.png"))
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("seed,n_q,k,n_b,visits", [
    (0, 40, 10, 7, [1, 2, 3, 10]),
    (1, 25, 30, 4, [4, 1, 2]),
    (2, 10, 5, 50, [1, 5, 6]),
])
def test_oracle_navigation_recall_equal(seed, n_q, k, n_b, visits):
    b = np.random.default_rng(seed).integers(0, n_b, size=(n_q, k))
    ours = peval.oracle_navigation_recall(b, visits)
    assert ours == jeval.oracle_navigation_recall(b, visits)
    assert list(ours) == sorted(set(visits))


def _tied_ids_only(d_ours, i_ours, d_theirs, i_theirs):
    """Ids may differ only where the reference's distances are exactly tied
    with a neighbour in the list."""
    diff = i_ours != i_theirs
    tied = np.zeros_like(diff)
    tied[:, 1:] |= d_theirs[:, 1:] == d_theirs[:, :-1]
    tied[:, :-1] |= d_theirs[:, 1:] == d_theirs[:, :-1]
    assert not (diff & ~tied).any()


def test_baseline_matches_the_jax_baseline():
    data, queries = pdata.synthetic_blobs(3000, 24, 50, seed=3)
    data = data * np.random.default_rng(1).uniform(0.5, 2.0, size=(3000, 1)).astype(np.float32)
    data[100:110] = data[:10]  # exact ties: the lower row first, as lax.top_k
    base = lmi.Baseline(device="cpu")
    assert base.build(data) >= 0.0
    dists, nns, seconds = base.search(queries, data, k=10)
    jd, jn, _ = jlmi.Baseline().search(queries, data, k=10)
    jd, jn = np.asarray(jd), np.asarray(jn)
    np.testing.assert_allclose(dists, jd, rtol=1e-4, atol=1e-5)
    assert nns.dtype == np.uint32 and nns.shape == (50, 10) and seconds > 0.0
    _tied_ids_only(dists, nns, jd, jn)
    cached = base._norm_cache[1]
    again = base.search(queries, data, k=10)
    assert base._norm_cache[1] is cached  # the same device tensor: nothing normalized again
    np.testing.assert_array_equal(again[1], nns)
    base.search(queries, data.copy(), k=10)
    assert base._norm_cache[1] is not cached


def test_pairwise_cosine_matches():
    rng = np.random.default_rng(4)
    x, y = rng.normal(size=(20, 16)), rng.normal(size=(30, 16)).astype(np.float32)
    ours = compat.pairwise_cosine(x, y, device="cpu")
    assert ours.shape == (20, 30) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, jcompat.pairwise_cosine(x, y), atol=1e-6)


def test_serialize_and_filter_path_idxs_equal(tmp_path):
    for lst in ([1, 2, 3], ["MLP", "MLP-4"], [0.01], []):
        assert compat.serialize(lst) == jcompat.serialize(lst)
    paths = np.random.default_rng(5).integers(0, 3, size=(40, 2))
    for path in ((1, 2), np.array([0, 0]), (5, 5)):
        _same_bits(compat.filter_path_idxs(paths, path), jcompat.filter_path_idxs(paths, path))
    compat.save_as_pickle(str(tmp_path / "p.pkl"), {"a": 1})
    jcompat.save_as_pickle(str(tmp_path / "j.pkl"), {"a": 1})
    assert (tmp_path / "p.pkl").read_bytes() == (tmp_path / "j.pkl").read_bytes()


def test_log_runtime_logs_as_the_jax_decorator(caplog):
    class Ours(Logger):
        @log_runtime(logging.INFO, "ran in {:.3f}s")
        def work(self, x):
            return x + 1

    class Theirs(jlogging.Logger):
        @jlogging.log_runtime(logging.INFO, "ran in {:.3f}s")
        def work(self, x):
            return x + 1

    with caplog.at_level(logging.INFO):
        assert Ours().work(1) == Theirs().work(1) == 2
    names = [r.name for r in caplog.records]
    assert names == [f"{__name__}.Ours", f"{__name__}.Theirs"]
    assert all(r.getMessage().startswith("ran in ") for r in caplog.records)
    assert Ours.work.__name__ == "work"


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        with profiling.span("lmi.probe"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.trace_path and os.path.dirname(prof.trace_path) == str(tmp_path)
    with open(prof.trace_path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "lmi.probe" in names
    assert profiling.device_events(prof.trace_path) == []  # no device on the CPU
