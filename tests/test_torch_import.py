"""The port imports and runs without jax, names its devices explicitly,
and carries the configuration surface of the JAX package."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

import learnedmetricindex_tpu_torch as lmi

torch.set_num_threads(2)

PACKAGE = pathlib.Path(lmi.__file__).resolve().parent
ROOT = PACKAGE.parent

MODULES = [
    "learnedmetricindex_tpu_torch",
    "learnedmetricindex_tpu_torch.baseline",
    "learnedmetricindex_tpu_torch.cli",
    "learnedmetricindex_tpu_torch.config",
    "learnedmetricindex_tpu_torch.data",
    "learnedmetricindex_tpu_torch.eval",
    "learnedmetricindex_tpu_torch.models.mlp",
    "learnedmetricindex_tpu_torch.models.train",
    "learnedmetricindex_tpu_torch.native",
    "learnedmetricindex_tpu_torch.ops.clustering",
    "learnedmetricindex_tpu_torch.ops.cuda_build",
    "learnedmetricindex_tpu_torch.ops.gather_kernel",
    "learnedmetricindex_tpu_torch.ops.kmeans",
    "learnedmetricindex_tpu_torch.ops.knn",
    "learnedmetricindex_tpu_torch.ops.precision",
    "learnedmetricindex_tpu_torch.ops.quantize",
    "learnedmetricindex_tpu_torch.ops.scan_kernel",
    "learnedmetricindex_tpu_torch.ops.select",
    "learnedmetricindex_tpu_torch.index.bucket_store",
    "learnedmetricindex_tpu_torch.index.builder",
    "learnedmetricindex_tpu_torch.index.index",
    "learnedmetricindex_tpu_torch.index.mutation",
    "learnedmetricindex_tpu_torch.index.navigation",
    "learnedmetricindex_tpu_torch.index.serialization",
    "learnedmetricindex_tpu_torch.parallel",
    "learnedmetricindex_tpu_torch.parallel.distributed",
    "learnedmetricindex_tpu_torch.parallel.mesh",
    "learnedmetricindex_tpu_torch.parallel.multiprocess",
    "learnedmetricindex_tpu_torch.parallel.sharded_index",
    "learnedmetricindex_tpu_torch.parallel.sharded_mutation",
    "learnedmetricindex_tpu_torch.serve",
    "learnedmetricindex_tpu_torch.utils",
    "learnedmetricindex_tpu_torch.utils.compat",
    "learnedmetricindex_tpu_torch.utils.logging",
    "learnedmetricindex_tpu_torch.utils.profiling",
]


def _run_without(body: str, blocked=("jax",)) -> subprocess.CompletedProcess:
    code = "import sys\n" + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked) + body
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300
    )


# after the body: neither jax nor the JAX package was loaded
_NOTHING_LOADED = """
loaded = [m for m, v in sys.modules.items() if v is not None and (
    m == "jax" or m.startswith("jax.") or m == "learnedmetricindex_tpu"
    or m.startswith("learnedmetricindex_tpu."))]
assert not loaded, loaded
print("ok")
"""


def _search_body(tmp_path) -> str:
    """Every module imports, and a tiny index saves, loads and searches on
    the CPU."""
    return f"""
import importlib
import numpy as np, torch
torch.set_num_threads(1)
for m in {MODULES!r}:
    importlib.import_module(m)
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.index.serialization import index_from_arrays
rng = np.random.default_rng(0)
data = rng.normal(size=(300, 8)).astype(np.float32)
data /= np.linalg.norm(data, axis=1, keepdims=True)
cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-8", 0.01, [4], chunk_size=32)
params = [{{"w": rng.normal(size=(1, 8, 8)).astype(np.float32), "b": np.zeros((1, 8), np.float32)}},
          {{"w": rng.normal(size=(1, 8, 4)).astype(np.float32), "b": np.zeros((1, 4), np.float32)}}]
index = index_from_arrays(cfg, [params], [np.ones((1, 4), bool)], ["MLP-8"], np.ones(4, bool), "cpu")
pred = rng.integers(0, 4, (300, 1))
index.save({str(tmp_path / 'i.npz')!r}, pred)
index, pred = lmi.LearnedIndex.load({str(tmp_path / 'i.npz')!r}, "cpu")
d, i, t = index.search(None, data[:5], data, data[:5], pred, n_buckets=4, k=3, precision="highest")
assert (i[:, 0] == np.arange(1, 6)).all(), i
dyn = lmi.DynamicIndex.from_built(index, data, pred, dtype="int8")
ids = dyn.insert(-data[:40])
assert dyn.delete(ids[:20]) == 20
dyn.compact()
dyn.save({str(tmp_path / 'd.ckpt')!r})
dyn = lmi.DynamicIndex.load({str(tmp_path / 'd.ckpt')!r}, "cpu")
d, i, t = dyn.search(-data[20:25], n_buckets=4, k=1)
assert (i[:, 0] == ids[20:25]).all(), i
""" + _NOTHING_LOADED


# the build path: a 2-level index is built, every bucket is filled and
# best-first search finds each query itself
_BUILD_BODY = """
import numpy as np, torch
torch.set_num_threads(1)
import learnedmetricindex_tpu_torch as lmi
rng = np.random.default_rng(1)
centers = rng.normal(size=(6, 8)).astype(np.float32)
data = centers[rng.integers(0, 6, 600)] + 0.2 * rng.normal(size=(600, 8)).astype(np.float32)
data /= np.linalg.norm(data, axis=1, keepdims=True)
cfg = lmi.BuildConfiguration("kmeans", 3, "MLP-8", 0.05, [3, 2], chunk_size=32, batch_size=64)
index, pred, n_buckets, build_t, cluster_t = lmi.LearnedIndexBuilder(data, cfg, device="cpu").build()
assert n_buckets == 6 and (np.bincount(index.bucket_ids_from_prediction(pred), minlength=6) > 0).all()
d, i, t = index.search(None, data[:5], data, data[:5], pred, n_buckets=2, k=3, precision="highest")
assert (i[:, 0] == np.arange(1, 6)).all(), i
""" + _NOTHING_LOADED

WITHOUT_THE_JAX_PACKAGE = ("jax", "learnedmetricindex_tpu")


def test_imports_and_searches_without_jax(tmp_path):
    """Every module imports with jax unimportable, and a tiny index saves,
    loads and searches on the CPU, then takes inserts, deletes and a
    compaction as a DynamicIndex through a checkpoint."""
    proc = _run_without(_search_body(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_builds_and_searches_without_jax():
    """The build path runs with jax unimportable: a 2-level index is built,
    every bucket is filled and best-first search finds each query itself."""
    proc = _run_without(_BUILD_BODY)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_imports_and_searches_without_the_jax_package(tmp_path):
    """The same with the JAX package unimportable as well: the port keeps
    its own configuration and native helpers."""
    proc = _run_without(_search_body(tmp_path), WITHOUT_THE_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_builds_and_searches_without_the_jax_package():
    proc = _run_without(_BUILD_BODY, WITHOUT_THE_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


# the experiment driver: every module imports, cli.sweep builds and
# searches, and Baseline answers, with neither h5py nor matplotlib
_DRIVER_BODY = """
import importlib, os
import numpy as np, torch
torch.set_num_threads(1)
for m in {modules!r}:
    importlib.import_module(m)
from learnedmetricindex_tpu_torch import cli
from learnedmetricindex_tpu_torch.data import synthetic_blobs
from learnedmetricindex_tpu_torch.ops.knn import recall
os.environ["JOB_ID"] = "import"
args = cli.parse_args(["--synthetic", "800", "--synthetic-dim", "8", "--n-categories", "3",
                       "--epochs", "3", "--model-type", "MLP-8", "-b", "3", "--chunk-size", "64",
                       "--no-save", "--device", "cpu"])
result = cli.sweep(**cli.sweep_arguments(args))
(n_buckets, dists, nns, measured, identifier), = result.searches
assert n_buckets == 3 and identifier.endswith("-buck=3-clustering_algorithm=kmeans-import")
data, queries = synthetic_blobs(800, 8, 100, seed=2023)
_, gt, _ = cli.Baseline(device="cpu").search(queries, data, k=10)
assert recall(nns, gt, 10) == 1.0, recall(nns, gt, 10)
""" + _NOTHING_LOADED


# a tensor corpus searched through a virtual store and through a store
# sharded over two "devices", and k past the kernel's widest list
_STORES_BODY = """
import numpy as np, torch
torch.set_num_threads(1)
import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.index.serialization import index_from_arrays
rng = np.random.default_rng(2)
data = rng.normal(size=(3000, 8)).astype(np.float32)
data /= np.linalg.norm(data, axis=1, keepdims=True)
cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-8", 0.01, [4], chunk_size=64)
params = [{"w": rng.normal(size=(1, 8, 8)).astype(np.float32), "b": np.zeros((1, 8), np.float32)},
          {"w": rng.normal(size=(1, 8, 4)).astype(np.float32), "b": np.zeros((1, 4), np.float32)}]
index = index_from_arrays(cfg, [params], [np.ones((1, 4), bool)], ["MLP-8"], np.ones(4, bool), "cpu")
pred = rng.integers(0, 4, (3000, 1))
corpus = torch.as_tensor(data)
store = index.get_bucket_store(corpus, pred)
assert store.virtual and store.data_ref is corpus
sharded = index.get_sharded_store(corpus, pred, lmi.create_mesh(device_type="cpu") * 2)
for st in (store, sharded):
    d, i, t = index.search(None, data[:5], None, data[:5], pred, n_buckets=4, k=1100,
                           precision="highest", store=st)
    assert i.shape == (5, 1100) and (i[:, 0] == np.arange(1, 6)).all(), i[:, :3]
# built over three "devices", then mutated while sharded over two
from learnedmetricindex_tpu_torch.parallel import ShardedDynamicIndex, sharded_kmeans
c, lab = sharded_kmeans(data, 4, ["cpu"] * 3)
assert c.shape == (4, 8) and lab.shape == (3000,)
cfg2 = lmi.BuildConfiguration("kmeans", 2, "MLP-8", 0.01, [2, 2], chunk_size=64)
built = lmi.LearnedIndexBuilder(data, cfg2, device="cpu", devices=["cpu"] * 3).build()
dyn = ShardedDynamicIndex.from_built(built[0], data, built[1], ["cpu"] * 2)
ids = dyn.insert(data[:4] * 0.5)
assert dyn.delete(ids[:2]) == 2 and dyn.n_rows == 3002
dyn.compact()
d, i, t = dyn.search(data[:3], n_buckets=4, k=1)
assert (i[:, 0] == np.arange(1, 4)).all(), i
""" + _NOTHING_LOADED


def test_virtual_and_sharded_stores_without_the_jax_package():
    """Virtual and sharded stores, a k=1100 search, a build over a device
    list and a ShardedDynamicIndex run with jax and the JAX package
    unimportable."""
    proc = _run_without(_STORES_BODY, WITHOUT_THE_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_driver_runs_without_jax_h5py_or_matplotlib():
    """``cli``, ``eval``, ``baseline``, ``data`` and ``utils`` import, and
    ``cli.sweep`` and ``Baseline`` run, with jax, the JAX package, h5py and
    matplotlib all unimportable."""
    proc = _run_without(_DRIVER_BODY.format(modules=MODULES),
                        WITHOUT_THE_JAX_PACKAGE + ("h5py", "matplotlib"))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _imported_modules(path: pathlib.Path):
    """Every module name an ``import`` or ``from ... import`` of ``path``
    names (relative imports resolve inside the port)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("where", ["package", "chip_smoke.py"])
def test_no_import_of_the_jax_package(where):
    """No module of the port and no line of chip_smoke.py imports the JAX
    package (``learnedmetricindex_tpu`` or any of its modules)."""
    files = sorted(PACKAGE.rglob("*.py")) if where == "package" else [ROOT / "chip_smoke.py"]
    if where == "package":
        walked = {str(p.relative_to(PACKAGE)) for p in files}
        assert {"parallel/multiprocess.py", "examples/multihost.py",
                "examples/multichip.py"} <= walked
    offenders = [
        f"{path.relative_to(ROOT)}: {name}"
        for path in files
        for name in _imported_modules(path)
        if name == "learnedmetricindex_tpu" or name.startswith("learnedmetricindex_tpu.")
    ]
    assert files and offenders == []


def test_no_jax_import_in_the_chip_tools():
    """No line of the card's tools (``tools/torch_*.py``, the A/B, probe,
    split and search tools) or of chip_smoke.py imports ``jax`` or the JAX
    package: they run on the GPU machine, which has neither."""
    files = sorted((ROOT / "tools").glob("torch_*.py")) + [ROOT / "chip_smoke.py"]
    assert {"torch_scan_ab.py", "torch_scan_probe.py", "torch_search_ab.py"} <= {
        p.name for p in files}
    offenders = [
        f"{path.relative_to(ROOT)}: {name}"
        for path in files
        for name in _imported_modules(path)
        if name.split(".")[0] in ("jax", "jaxlib", "learnedmetricindex_tpu")
    ]
    assert offenders == []


def test_native_helpers_build_outside_the_packages():
    """The port's native library is built under the checkout's build/, not
    into either package."""
    from learnedmetricindex_tpu_torch import native

    path = native.library_path()
    assert path.parent == ROOT / "build" / "torch_native"
    assert native.SOURCE.parent == PACKAGE / "native"


def test_no_jax_import_in_the_package():
    offenders = [
        str(p.relative_to(ROOT))
        for p in PACKAGE.rglob("*.py")
        if "import jax" in p.read_text() or "from jax" in p.read_text()
    ]
    assert offenders == []


def test_exports():
    """The public names, and importing the port leaves the caller's TF32
    flags as it found them (the exact stages scope full f32 to their own
    calls: ops/precision.py)."""
    assert set(lmi.__all__) >= {"Baseline", "BuildConfiguration", "DynamicIndex", "LearnedIndex",
                                "LearnedIndexBuilder", "ModelParameters", "NeuralNetwork",
                                "ShardedStore", "create_mesh", "load_index", "save_index",
                                "shard_packed_store", "shard_store", "sharded_search"}
    from learnedmetricindex_tpu_torch import parallel

    assert set(parallel.__all__) == {"ShardedDynamicIndex", "ShardedStore", "create_mesh",
                                     "data_model_axes", "device_list", "shard_packed_store",
                                     "shard_store", "sharded_kmeans", "sharded_search"}
    assert all(hasattr(parallel, name) for name in parallel.__all__)
    assert all(hasattr(lmi, name) for name in lmi.__all__)
    # the JAX package's public names of ops/, index/ and models/, and the attributes
    # its examples read, with jax and the JAX package unimportable
    proc = _run_without("""
import numpy as np, torch
from learnedmetricindex_tpu_torch.ops import exact_knn, recall, kmeans, kmeans_nodes
from learnedmetricindex_tpu_torch.index import (BucketStore, LearnedIndexBuilder, LearnedIndex,
                                                DynamicIndex)
from learnedmetricindex_tpu_torch import ops, index, models
from learnedmetricindex_tpu_torch.models import NeuralNetwork, train_until_covered
from learnedmetricindex_tpu_torch.index.bucket_store import scan_buckets
assert set(models.__all__) == {"MLP_REGISTRY", "StackedMLP", "NeuralNetwork",
                               "train_until_covered"}
assert all(hasattr(models, n) for n in models.__all__) and callable(train_until_covered)
from learnedmetricindex_tpu_torch.parallel import multiprocess as mp
assert set(ops.__all__) == {"exact_knn", "recall", "kmeans", "kmeans_nodes"}
assert set(index.__all__) == {"BucketStore", "LearnedIndexBuilder", "LearnedIndex", "DynamicIndex"}
assert all(callable(getattr(mp, n)) for n in ("initialize", "global_mesh", "from_process_local",
                                              "is_multiprocess", "to_host_replicated"))
import learnedmetricindex_tpu_torch as lmi
data = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
cfg = lmi.BuildConfiguration("kmeans", 2, "MLP-8", 0.05, [2, 2], chunk_size=32)
idx, pred, _, _, _ = LearnedIndexBuilder(data, cfg, device="cpu").build()
assert [(lv.n_models, lv.n_categories) for lv in idx.levels] == [(1, 2), (2, 2)]
store = idx.get_sharded_store(data, pred, ["cpu"] * 3)
assert store.nbytes_device_arrays() == store.nbytes() == sum(s.nbytes() for s in store.shards)
nn = lmi.NeuralNetwork(8, 3, device="cpu")
assert [tuple(p["w"].shape) for p in nn.params] == [(8, 128), (128, 3)], nn.params
assert [tuple(p["b"].shape) for p in nn.params] == [(128,), (3,)]
""" + _NOTHING_LOADED, WITHOUT_THE_JAX_PACKAGE)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
    for matmul, cudnn in ((True, False), (False, True)):
        proc = _run_without(f"""
import torch
torch.backends.cuda.matmul.allow_tf32 = {matmul}
torch.backends.cudnn.allow_tf32 = {cudnn}
import learnedmetricindex_tpu_torch
assert torch.backends.cuda.matmul.allow_tf32 is {matmul}
assert torch.backends.cudnn.allow_tf32 is {cudnn}
print("ok")
""", blocked=())
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip().endswith("ok")


# the caller's setting, then full_f32 entered (and left by an exception)
# twice: full f32 inside, every record restored after
_FULL_F32_BODY = """
import torch
from learnedmetricindex_tpu_torch.ops.precision import full_f32
B = torch.backends
RECORDS = {{"cuda": lambda: B.cuda.matmul.fp32_precision,
           "mkldnn": lambda: B.mkldnn.matmul.fp32_precision,
           "process": torch.get_float32_matmul_precision,
           "allow_tf32": lambda: B.cuda.matmul.allow_tf32}}
def state():
    out = {{}}
    for name, read in RECORDS.items():
        try:
            out[name] = read()
        except RuntimeError:  # unreadable while the records disagree
            out[name] = "unreadable"
    return out
{setting}
before = state()
with full_f32():
    assert B.cuda.matmul.fp32_precision == "ieee"
    inside = state()
    assert inside["process"] in ("highest", "unreadable") and inside["allow_tf32"] in (False, "unreadable"), inside
assert state() == before, (before, state())
try:
    with full_f32():
        raise KeyError("inside")
except KeyError:
    pass
assert state() == before, (before, state())
@full_f32()
def decorated():
    return B.cuda.matmul.fp32_precision
assert decorated() == "ieee" and state() == before
print("ok", before)
"""


@pytest.mark.parametrize("setting", [
    "",
    'torch.set_float32_matmul_precision("high")',
    'torch.set_float32_matmul_precision("medium")',
    "B.cuda.matmul.allow_tf32 = True",
    'B.cuda.matmul.fp32_precision = "tf32"',
])
def test_full_f32_restores_the_callers_settings(setting):
    """``full_f32`` runs its body with IEEE f32 matmuls and puts every
    record of the caller's TF32 setting back, also after an exception
    and when used as a decorator."""
    proc = _run_without(_FULL_F32_BODY.format(setting=setting), blocked=())
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().startswith("ok")


def test_config_validates_without_the_jax_registry():
    cfg = lmi.BuildConfiguration(["kmeans"], [3], ["MLP-4"], [0.01], [120], chunk_size=2048)
    again = lmi.BuildConfiguration.from_dict(cfg.to_dict())
    assert again.to_dict() == cfg.to_dict()
    assert isinstance(again, lmi.BuildConfiguration)
    with pytest.raises(ValueError, match="model type"):
        lmi.BuildConfiguration("kmeans", 1, "MLP-99", 0.01, [4])
    with pytest.raises(ValueError, match="clustering"):
        lmi.BuildConfiguration("dbscan", 1, "MLP", 0.01, [4])
    with pytest.raises(ValueError, match="positive"):
        lmi.BuildConfiguration("kmeans", 1, "MLP", 0.01, [0])


def test_cuda_asked_for_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from learnedmetricindex_tpu_torch.index.index import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_is_keyed_by_source():
    from learnedmetricindex_tpu_torch.ops import cuda_build, scan_kernel

    path = cuda_build.library_path(scan_kernel.SOURCE)
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.name.startswith("libscan_pairs_") and path.suffix == ".so"
    assert path == cuda_build.library_path(scan_kernel.SOURCE)
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_gather_kernel_build_is_keyed_by_source():
    from learnedmetricindex_tpu_torch.ops import cuda_build, gather_kernel, scan_kernel

    path = cuda_build.library_path(gather_kernel.SOURCE)
    assert path.parent == ROOT / "build" / "torch_kernels"
    assert path.name.startswith("libgather_rows_") and path.suffix == ".so"
    assert gather_kernel.SOURCE.parent == scan_kernel.SOURCE.parent == PACKAGE / "csrc"
    assert path != cuda_build.library_path(scan_kernel.SOURCE)


def test_builder_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import numpy as np

    cfg = lmi.BuildConfiguration("kmeans", 1, "MLP-8", 0.01, [2])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lmi.LearnedIndexBuilder(np.zeros((4, 8), np.float32), cfg, device="cuda")
