"""The port's experiment driver (``learnedmetricindex_tpu_torch.cli``)
against the JAX package's: the parser, the file names, the SISAP result
files of a synthetic run and of staged HDF5 datasets (also the
dual-embedding branch), the refusals, ``sweep`` without h5py, and the
port's examples."""

import os
import pathlib
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

import learnedmetricindex_tpu as jlmi
from learnedmetricindex_tpu import cli as jcli
from learnedmetricindex_tpu import eval as jeval
from learnedmetricindex_tpu.data import KIND_TO_KEY
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch import cli
from learnedmetricindex_tpu_torch import eval as lmi_eval
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]

SYNTHETIC_ARGV = ["--synthetic", "1500", "--synthetic-dim", "12", "--n-categories", "4",
                  "--epochs", "20", "--model-type", "MLP-8", "--buckets-perc", "25", "50", "100",
                  "--chunk-size", "128", "--no-save"]


@pytest.fixture(autouse=True)
def job_id(monkeypatch):
    """File names end in the job id from the environment: fix it."""
    monkeypatch.delenv("PBS_JOBID", raising=False)
    monkeypatch.setenv("JOB_ID", "test")


def test_parser_defaults_match_the_jax_parser():
    ours = vars(cli.build_parser().parse_args([]))
    assert ours.pop("device") == "cuda"
    assert ours == vars(jcli.build_parser().parse_args([]))
    assert ours["n_categories"] == [10, 10] and ours["buckets_perc"] == [10]
    assert ours["preprocess"] is True and ours["save"] is True and ours["download"] is True


@pytest.mark.parametrize("argv", [
    ["--no-preprocess", "--no-save"],
    ["-b", "2", "3"],
    ["--no-download", "--data-dir", "x", "--dtype", "bfloat16", "--policy", "joint"],
    ["--clustering-algorithm", "faiss_kmeans", "--nav-temp", "1,4", "--k", "30"],
])
def test_parser_flags_match_the_jax_parser(argv):
    """The JAX tests' flag cases (real boolean flags, a working ``-b``) and
    more: the same namespace apart from ``--device``."""
    ours = vars(cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert ours.pop("device") == "cpu"
    assert ours == vars(jcli.build_parser().parse_args(argv))


def test_per_level_validation():
    args = vars(cli.build_parser().parse_args(["--n-categories", "5", "6", "--epochs", "10"]))
    jargs = dict(args)
    cli.expand_per_level(args)
    jcli.expand_per_level(jargs)
    assert args == jargs and args["epochs"] == [10, 10] and args["model_type"] == ["MLP"] * 2
    bad = vars(cli.build_parser().parse_args(
        ["--n-categories", "5", "6", "7", "--epochs", "10", "20"]))
    with pytest.raises(ValueError, match="--epochs must have 1 or 3 values"):
        cli.expand_per_level(bad)


@pytest.mark.parametrize("value,expected", [(None, None), ("2", 2.0), ("1,4", [1.0, 4.0])])
def test_nav_temp_is_a_scalar_or_one_a_level(value, expected):
    assert cli.parse_nav_temp(value) == expected


def test_format_identifier_matches():
    args = (["kmeans", "kmeans"], [3, 5], ["MLP", "MLP-4"], [0.01, 0.1], [10, 12])
    for bucket, kind, size in ((0, "pca32v2", "10M"), (7, "synthetic12", "100K")):
        ours = cli.format_identifier(bucket, kind, lmi.BuildConfiguration(*args),
                                     args[0], "learned-index", size)
        assert ours == jcli.format_identifier(bucket, kind, jlmi.BuildConfiguration(*args),
                                              args[0], "learned-index", size)
    assert ours.endswith("-buck=7-clustering_algorithm=kmeans,kmeans-test")


def _read(path):
    with h5py.File(path, "r") as f:
        return ({k: f[k][()] for k in f}, {k: f[k].dtype for k in f},
                {k: f.attrs[k] for k in f.attrs})


def _compare_runs(ours: list, theirs: list, gt, full_visit_suffix: str):
    """The same files (names relative to each out dir), datasets of the same
    dtypes and shapes, equal data/size/params attrs; recall 1.0 against
    exact kNN at a full visit, and by outcome at fewer buckets (the builds'
    PRNGs differ)."""
    assert [pathlib.Path(p).name for p in ours] == [pathlib.Path(p).name for p in theirs]
    assert len(ours) >= 1
    for a, b in zip(ours, theirs):
        (da, ta, aa), (db, tb, ab) = _read(a), _read(b)
        assert ta == tb == {"knns": np.dtype(np.uint32), "dists": np.dtype(np.float32)}
        assert {k: v.shape for k, v in da.items()} == {k: v.shape for k, v in db.items()}
        assert set(aa) == set(ab) == {"algo", "data", "buildtime", "querytime", "params", "size"}
        assert all(aa[k] == ab[k] for k in ("algo", "data", "size", "params"))
        assert da["knns"].min() >= 1  # 1-based
        r_ours, r_theirs = recall(da["knns"], gt, 10), recall(db["knns"], gt, 10)
        if a.endswith(full_visit_suffix):
            assert r_ours == r_theirs == 1.0
        else:
            assert r_ours >= r_theirs - 0.05, (a, r_ours, r_theirs)


def test_synthetic_end_to_end_matches_the_jax_cli(tmp_path):
    """``main`` of both packages on the same argv: the same result files in
    the SISAP schema, recall 1.0 at every bucket."""
    ours = cli.main(SYNTHETIC_ARGV + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    theirs = jcli.main(SYNTHETIC_ARGV + ["--out-dir", str(tmp_path / "jax")])
    assert [p.split("/synthetic12/")[1] for p in ours] == [
        p.split("/synthetic12/")[1] for p in theirs]
    assert len(ours) == 3 and "-buck=4-" in ours[-1]
    from learnedmetricindex_tpu_torch.data import synthetic_blobs

    data, queries = synthetic_blobs(1500, 12, 100, seed=2023)
    _, gt = exact_knn(data, queries, k=10, device="cpu")
    _compare_runs(ours, theirs, gt, "-buck=4-clustering_algorithm=kmeans-test.h5")
    # each package reads both packages' files the same
    for path in ours + theirs:
        assert lmi_eval.evaluate_result_file(path, gt) == jeval.evaluate_result_file(path, gt)


def _write_h5(path, key, arr):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset(key, data=arr)


def _stage(root, n=1200, nq=24, seed=2):
    """clip768v2 (key emb, d 24) and pca32v2 (key pca32, d 8: a projection
    of the same rows) under ``root/<kind>/100K/``; returns the normalized
    clip768v2 data and queries."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(8, 24)).astype(np.float32)
    data = centers[rng.integers(0, 8, n)] + 0.3 * rng.normal(size=(n, 24)).astype(np.float32)
    queries = data[rng.integers(0, n, nq)] + 0.05 * rng.normal(size=(nq, 24)).astype(np.float32)
    proj = rng.normal(size=(24, 8)).astype(np.float32)
    for kind, x, q in (("clip768v2", data, queries), ("pca32v2", data @ proj, queries @ proj)):
        base = os.path.join(str(root), kind, "100K")
        _write_h5(os.path.join(base, "dataset.h5"), KIND_TO_KEY[kind], x)
        _write_h5(os.path.join(base, "query.h5"), KIND_TO_KEY[kind], q)
    from learnedmetricindex_tpu_torch.data import normalize

    return normalize(data), normalize(queries)


@pytest.mark.parametrize("dataset,emb", [("clip768v2", "emb"), ("pca32v2", "pca32")])
def test_offline_staged_dataset_matches_the_jax_cli(tmp_path, dataset, emb):
    """``--no-download --data-dir`` on staged files, in both packages:
    ``clip768v2`` alone, and ``pca32v2`` navigation with a ``clip768v2``
    scan (dual embeddings).  Visiting every bucket is exact in the scan's
    space."""
    data, queries = _stage(tmp_path / "data")
    argv = ["--dataset", dataset, "--emb", emb, "--size", "100K", "--data-dir",
            str(tmp_path / "data"), "--no-download", "--n-categories", "5", "--epochs", "5",
            "--chunk-size", "64", "--no-save", "-b", "2", "5"]
    ours = cli.main(argv + ["--out-dir", str(tmp_path / "port"), "--device", "cpu"])
    theirs = jcli.main(argv + ["--out-dir", str(tmp_path / "jax")])
    assert all(f"/{dataset}/100K/" in p for p in ours)
    _, gt = exact_knn(data, queries, k=10, device="cpu")
    _compare_runs(ours, theirs, gt, "-buck=5-clustering_algorithm=kmeans-test.h5")


def test_missing_staged_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match=r"query\.h5.*https://"):
        cli.main(["--dataset", "clip768v2", "--emb", "emb", "--data-dir", str(tmp_path),
                  "--no-download", "--device", "cpu"])


def test_shard_devices_raises():
    """``--shard-devices N`` on CUDA names the first N cards and raises when
    the machine has fewer (the JAX package's create_mesh); ``--device``
    must be the first of them."""
    from learnedmetricindex_tpu_torch.parallel.mesh import device_list

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"need {have + 1} cuda devices"):
        device_list(have + 1, "cuda")
    with pytest.raises(ValueError, match="first shard device"):
        cli.sweep(**cli.sweep_arguments(cli.parse_args(["--synthetic", "200", "--device", "cpu"])),
                  devices=["meta", "cpu"])
    if not have:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--synthetic", "200", "--shard-devices", "2"])


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda would run")
    for argv in (["--synthetic", "200"], ["--synthetic", "200", "--index-type", "baseline"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(argv)


def test_baseline_index_type_matches(tmp_path):
    """``--index-type baseline``: exact kNN, ``(dists, nns)`` and no file."""
    argv = ["--synthetic", "600", "--synthetic-dim", "12", "--index-type", "baseline",
            "--out-dir", str(tmp_path)]
    dists, nns = cli.main(argv + ["--device", "cpu"])
    jd, jn = jcli.main(argv)
    np.testing.assert_allclose(dists, np.asarray(jd), rtol=1e-4, atol=1e-5)
    assert nns.dtype == np.uint32 and nns.shape == (100, 10)
    assert recall(nns, np.asarray(jn), 10) == 1.0
    assert not any(tmp_path.iterdir())


def test_sweep_takes_a_built_index():
    """``sweep(built=...)`` searches the given index: the same answers as
    the sweep that built it, and nothing built anew."""
    kw = cli.sweep_arguments(cli.parse_args(SYNTHETIC_ARGV + ["--device", "cpu"]))
    first = cli.sweep(**kw)
    built = (first.index, first.data_prediction, first.index.n_buckets, first.build_t,
             first.cluster_t)
    again = cli.sweep(**kw, built=built)
    assert again.index is first.index and again[2:4] == first[2:4]
    assert [s[0] for s in again.searches] == [s[0] for s in first.searches] == [1, 2, 4]
    for a, b in zip(first.searches, again.searches):
        np.testing.assert_array_equal(a[2], b[2])
        assert a[4] == b[4]
        assert set(a[3]) == set(cli.LOGGED_TIMES)


_SWEEP_WITHOUT_H5PY = """
import sys
sys.modules["h5py"] = None
import os, torch
torch.set_num_threads(1)
os.environ["JOB_ID"] = "test"
from learnedmetricindex_tpu_torch import cli
args = cli.parse_args({argv!r})
result = cli.sweep(**cli.sweep_arguments(args))
assert [s[0] for s in result.searches] == [1, 2, 4], result.searches
try:
    cli.write_results(result, args.size, {out!r})
except ImportError:
    print("ok")
"""


def test_sweep_runs_without_h5py(tmp_path):
    """``sweep`` needs no h5py; writing the result files does."""
    code = _SWEEP_WITHOUT_H5PY.format(argv=SYNTHETIC_ARGV + ["--device", "cpu"],
                                      out=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


@pytest.mark.parametrize("example", ["introduction", "serving", "dynamic", "multichip",
                                     "multihost"])
def test_port_examples_run(example):
    """Each of the port's examples runs end to end at a small ``--n`` on
    the CPU (``multichip`` over ``["cpu"] * 8``, ``multihost`` as two gloo
    ranks, each asserting full-visit recall 1.0)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "learnedmetricindex_tpu_torch" / "examples" / f"{example}.py"),
         "--device", "cpu", "--n", "2000"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = proc.stdout.strip().splitlines()[-1]
    assert {"introduction": "reloaded index recall@10",
            "serving": "micro-batching:",
            "dynamic": "no collisions",
            "multichip": "OK",
            "multihost": "multi-host demo OK"}[example] in last
