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
    "learnedmetricindex_tpu_torch.config",
    "learnedmetricindex_tpu_torch.data",
    "learnedmetricindex_tpu_torch.models.mlp",
    "learnedmetricindex_tpu_torch.models.train",
    "learnedmetricindex_tpu_torch.native",
    "learnedmetricindex_tpu_torch.ops.clustering",
    "learnedmetricindex_tpu_torch.ops.cuda_build",
    "learnedmetricindex_tpu_torch.ops.gather_kernel",
    "learnedmetricindex_tpu_torch.ops.kmeans",
    "learnedmetricindex_tpu_torch.ops.knn",
    "learnedmetricindex_tpu_torch.ops.quantize",
    "learnedmetricindex_tpu_torch.ops.scan_kernel",
    "learnedmetricindex_tpu_torch.ops.select",
    "learnedmetricindex_tpu_torch.index.bucket_store",
    "learnedmetricindex_tpu_torch.index.builder",
    "learnedmetricindex_tpu_torch.index.index",
    "learnedmetricindex_tpu_torch.index.navigation",
    "learnedmetricindex_tpu_torch.index.serialization",
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
    loads and searches on the CPU."""
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
    offenders = [
        f"{path.relative_to(ROOT)}: {name}"
        for path in files
        for name in _imported_modules(path)
        if name == "learnedmetricindex_tpu" or name.startswith("learnedmetricindex_tpu.")
    ]
    assert files and offenders == []


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
    assert set(lmi.__all__) >= {"BuildConfiguration", "LearnedIndex", "LearnedIndexBuilder",
                                "load_index", "save_index"}
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


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
