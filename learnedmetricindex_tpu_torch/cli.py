"""Experiment driver CLI (counterpart of ``learnedmetricindex_tpu/cli.py``).

The JAX package's flag surface and flow, flag for flag: load or generate
the data, build the index, search it at each visit count of the sweep
and write one SISAP'23 result file per visit count.  ``-b`` gives
explicit visit counts in place of the ``--buckets-perc`` sweep;
``--preprocess``/``--save``/``--download`` are real booleans
(``--no-...``); ``--synthetic N`` runs offline on seeded blobs; a
navigation ``--dataset`` other than ``clip768v2`` scans in ``clip768v2``
(dual embeddings).  One flag is the port's own: ``--device`` (default
``cuda``; without a GPU that raises, ``--device cpu`` runs the kernels'
plain versions).  ``--shard-devices N`` builds over N devices and sweeps
one store sharded by bucket over them: on CUDA the first N cards (all
of them for N < 0; it raises if there are fewer), with ``--device cpu``
N repeats of the CPU (``parallel.mesh.device_list``).  From Python,
:func:`sweep` and :func:`run` also take ``devices=``, any list
(``[cuda:0] * 4`` runs four shards on one card).

Run as ``python -m learnedmetricindex_tpu_torch.cli [flags]``.  Result
files need h5py; :func:`sweep` (build and search, no files) does not.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import List, NamedTuple, Optional, Union

import numpy as np

from learnedmetricindex_tpu_torch import eval as lmi_eval
from learnedmetricindex_tpu_torch.baseline import Baseline
from learnedmetricindex_tpu_torch.config import SUPPORTED_CLUSTERINGS, BuildConfiguration
from learnedmetricindex_tpu_torch.data import load_dataset, normalize, synthetic_blobs
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore
from learnedmetricindex_tpu_torch.index.builder import LearnedIndexBuilder
from learnedmetricindex_tpu_torch.index.index import LearnedIndex, resolve_device
from learnedmetricindex_tpu_torch.parallel.mesh import device_list
from learnedmetricindex_tpu_torch.parallel.sharded_index import ShardedStore
from learnedmetricindex_tpu_torch.utils.logging import configure_logging

LOG = logging.getLogger("learnedmetricindex_tpu_torch.cli")

MODELS_DIR_NAME = "models"
SHORT_IDENTIFIER = "learned-index"
#: the ``measured`` keys logged after each search
LOGGED_TIMES = ("inference", "search", "search_within_buckets", "seq_search", "sort")


def format_identifier(
    bucket: int, kind: str, config, clustering_algorithms: List[str],
    short_identifier: str, size: str,
) -> str:
    """The result and model file stem; ends in ``PBS_JOBID`` or ``JOB_ID``
    from the environment, else ``local``."""
    job = os.environ.get("PBS_JOBID", os.environ.get("JOB_ID", "local"))

    def ser(lst):
        return ",".join(map(str, lst))

    return (
        f"{short_identifier}-{kind}-{size}"
        f"-ep={ser(config.epochs)}"
        f"-lr={ser(config.lrs)}"
        f"-cat={ser(config.n_categories)}"
        f"-model={ser(config.model_types)}"
        f"-buck={bucket}"
        f"-clustering_algorithm={ser(clustering_algorithms)}"
        f"-{job}"
    )


def _devices(shard_devices: int, device, devices):
    """``(device, devices)``: ``devices`` as given, else ``--shard-devices``'s
    list (None for 0); with a list, ``device`` must be its first entry."""
    device = resolve_device(device)
    if devices is None and shard_devices:
        devices = device_list(shard_devices, device)
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if devices[0] != device:
            raise ValueError(f"--device {device} is not the first shard device {devices[0]}")
    return device, devices


def load_data(kind, key, size, preprocess, synthetic=0, synthetic_dim=96, seed=2023,
              download=True, data_dir="data"):
    """``(kind, data, queries)`` as the CLI reads them: ``synthetic`` blobs
    (``kind`` becomes ``synthetic<dim>``, ``max(n // 100, 100)`` queries)
    or a SISAP kind and size, normalized if ``preprocess``."""
    if synthetic:
        data, queries = synthetic_blobs(
            synthetic, synthetic_dim, max(synthetic // 100, 100), seed=seed
        )
        return f"synthetic{synthetic_dim}", data, queries
    data, queries = load_dataset(
        kind, size, data_dir, key=key, preprocess=False, download=download
    )
    if preprocess:
        data, queries = normalize(data), normalize(queries)
    return kind, data, queries


class Sweep(NamedTuple):
    """What :func:`sweep` returns: the index and its ``data_prediction``,
    the build's seconds and its clustering's, the seconds the data took to
    load or generate on the host, the data kind the file names carry, the
    search queries and the packed store the searches scanned, and one
    ``(n_buckets, dists, nns, measured, identifier)`` a visit count,
    ascending.  Over devices the store is the :class:`ShardedStore` every
    search shared."""

    index: LearnedIndex
    data_prediction: np.ndarray
    build_t: float
    cluster_t: float
    data_t: float
    kind: str
    queries: np.ndarray
    store: Union[BucketStore, ShardedStore]
    searches: list


def sweep(
    kind: str,
    key: str,
    size: str,
    k: int,
    n_buckets_perc: List[int],
    n_categories: List[int],
    epochs: List[int],
    model_types: List[str],
    lr: List[float],
    preprocess: bool,
    save: bool,
    clustering_algorithms: List[str],
    n_buckets_explicit=None,
    synthetic: int = 0,
    synthetic_dim: int = 96,
    policy: str = "best_first",
    nav_temp=None,
    seed: int = 2023,
    chunk_size: int = 1024,
    dtype: str = "float32",
    batch_size: int = 256,
    shard_devices: int = 0,
    download: bool = True,
    data_dir: str = "data",
    *,
    device,
    devices=None,
    built: Optional[tuple] = None,
) -> Sweep:
    """Build the learned index on ``device`` (or take ``built``, what
    ``LearnedIndexBuilder.build()`` returned over the same data) and search
    it at each visit count; writes no result file.  The first search
    packs the search store (host rows at ``dtype``) and uploads it, and
    its ``measured["search"]`` includes that.  Over ``devices`` (or
    ``shard_devices``) the build runs over them and every search shares
    one store sharded by bucket over them, made before the first."""
    device, devices = _devices(shard_devices, device, devices)
    s = time.perf_counter()
    kind, data, queries = load_data(kind, key, size, preprocess, synthetic, synthetic_dim,
                                    seed, download, data_dir)
    data_t = time.perf_counter() - s
    LOG.info("Loaded data: n=%d, d=%d; queries=%s in %.2f s", *data.shape, queries.shape,
             data_t)

    s = time.perf_counter()
    data_search, queries_search = data, queries
    if not synthetic and kind != "clip768v2":
        # dual embeddings: navigate in `kind`, scan in clip768v2
        data_search, queries_search = load_dataset(
            "clip768v2", size, data_dir, key="emb", preprocess=preprocess,
            download=download,
        )

    config = BuildConfiguration(
        clustering_algorithms,
        epochs,
        model_types,
        lr,
        n_categories,
        seed=seed,
        batch_size=batch_size,
        chunk_size=chunk_size,
        dtype=dtype,
    )
    if built is None:
        built = LearnedIndexBuilder(data, config, device=device, devices=devices).build()
    index, data_prediction, _, build_t, cluster_t = built
    LOG.info("Cluster time: %.2f", cluster_t)
    n_buckets_in_index = index.n_buckets
    LOG.info("Total number of buckets in the index: %d", n_buckets_in_index)
    LOG.info("Pure build time: %.2f", build_t)
    LOG.info("Overall build time: %.2f", time.perf_counter() - s)

    if save:
        os.makedirs(MODELS_DIR_NAME, exist_ok=True)
        save_path = os.path.join(
            MODELS_DIR_NAME,
            format_identifier(0, kind, config, clustering_algorithms, "index", size) + ".npz",
        )
        LOG.info("Saving index to %s", save_path)
        index.save(save_path, data_prediction)

    if n_buckets_explicit:
        n_buckets = sorted(set(b for b in n_buckets_explicit if b > 0))
    else:
        n_buckets = [int((p / 100) * n_buckets_in_index) for p in n_buckets_perc]
        n_buckets = sorted(set(b for b in n_buckets if b > 0))
    LOG.info("Number of buckets to search in: %s", n_buckets)

    shared_store = None
    if devices is not None:
        LOG.info("Sharding over %d devices: %s", len(devices), devices)
        shared_store = index.get_sharded_store(data_search, data_prediction, devices)
    searches = []
    for bucket in n_buckets:
        LOG.info("Searching with %d buckets", bucket)
        dists, nns, measured = index.search(
            data_navigation=data,
            queries_navigation=queries,
            data_search=data_search,
            queries_search=queries_search,
            data_prediction=data_prediction,
            n_categories=n_categories,
            n_buckets=bucket,
            k=k,
            policy=policy,
            nav_temp=nav_temp,
            store=shared_store,
        )
        for key_t in LOGGED_TIMES:
            LOG.info("%s time: %.4f", key_t, measured[key_t])
        identifier = format_identifier(
            bucket, kind, config, clustering_algorithms, SHORT_IDENTIFIER, size
        )
        searches.append((bucket, dists, nns, measured, identifier))
    store = (shared_store if shared_store is not None  # the searches' own
             else index.get_bucket_store(data_search, data_prediction))
    return Sweep(index, data_prediction, build_t, cluster_t, data_t, kind, queries_search,
                 store, searches)


def write_results(result: Sweep, size: str, out_dir: str = "result") -> List[str]:
    """One SISAP'23 result file a visit count of ``result``, at
    ``<out_dir>/<kind>/<size>/<identifier>.h5`` (needs h5py); returns the
    paths."""
    paths = []
    for _, dists, nns, measured, identifier in result.searches:
        dst = os.path.join(out_dir, result.kind, size, f"{identifier}.h5")
        lmi_eval.store_results(
            dst,
            SHORT_IDENTIFIER.capitalize(),
            result.kind,
            dists,
            nns,
            result.build_t,
            measured["search"],
            identifier,
            size,
        )
        paths.append(dst)
    return paths


def run(
    kind: str,
    key: str,
    size: str,
    k: int,
    index_type: str,
    n_buckets_perc: List[int],
    n_categories: List[int],
    epochs: List[int],
    model_types: List[str],
    lr: List[float],
    preprocess: bool,
    save: bool,
    clustering_algorithms: List[str],
    n_buckets_explicit=None,
    synthetic: int = 0,
    synthetic_dim: int = 96,
    policy: str = "best_first",
    nav_temp=None,
    seed: int = 2023,
    chunk_size: int = 1024,
    dtype: str = "float32",
    batch_size: int = 256,
    out_dir: str = "result",
    shard_devices: int = 0,
    download: bool = True,
    data_dir: str = "data",
    *,
    device,
    devices=None,
):
    """``baseline``: exact kNN, returns ``(dists, nns)`` and writes nothing.
    ``learned-index``: :func:`sweep` (over ``devices`` or
    ``shard_devices``), then :func:`write_results`; returns the result
    files' paths."""
    if index_type not in ("baseline", "learned-index"):
        raise ValueError(f"Unknown index type: {index_type}")
    device, devices = _devices(shard_devices, device, devices)
    if index_type == "baseline":
        _, data, queries = load_data(kind, key, size, preprocess, synthetic, synthetic_dim,
                                     seed, download, data_dir)
        LOG.info("Loaded data: n=%d, d=%d; queries=%s", *data.shape, queries.shape)
        baseline = Baseline(device=device)
        LOG.info("Build time: %s", baseline.build(data))
        dists, nns, search_t = baseline.search(queries=queries, data=data, k=k)
        LOG.info("Search time: %s", search_t)
        return dists, nns
    result = sweep(
        kind, key, size, k, n_buckets_perc, n_categories, epochs, model_types, lr,
        preprocess, save, clustering_algorithms, n_buckets_explicit=n_buckets_explicit,
        synthetic=synthetic, synthetic_dim=synthetic_dim, policy=policy, nav_temp=nav_temp,
        seed=seed, chunk_size=chunk_size, dtype=dtype, batch_size=batch_size,
        download=download, data_dir=data_dir, device=device, devices=devices,
    )
    return write_results(result, size, out_dir)


def build_parser() -> argparse.ArgumentParser:
    """The JAX package's parser, flag for flag, plus ``--device``."""
    parser = argparse.ArgumentParser(
        prog="learnedmetricindex_tpu_torch",
        description="Learned Metric Index experiment driver (PyTorch + CUDA)",
    )
    parser.add_argument("--dataset", default="pca96v2")
    parser.add_argument("--emb", default="pca96")
    parser.add_argument(
        "--size", default="100K", choices=["100K", "300K", "10M", "30M", "100M"]
    )
    parser.add_argument("--k", default=10, type=int)
    parser.add_argument("--n-categories", nargs="+", default=[10, 10], type=int)
    parser.add_argument("--epochs", nargs="+", default=[100], type=int)
    parser.add_argument("--model-type", nargs="+", default=["MLP"])
    parser.add_argument("--lr", nargs="+", default=[0.01], type=float)
    parser.add_argument("-b", "--n-buckets", nargs="+", default=None, type=int)
    parser.add_argument("-bp", "--buckets-perc", nargs="+", default=[10], type=int)
    parser.add_argument(
        "--preprocess", action=argparse.BooleanOptionalAction, default=True
    )
    parser.add_argument(
        "--save", action=argparse.BooleanOptionalAction, default=True
    )
    parser.add_argument(
        "--clustering-algorithm",
        nargs="+",
        default=["kmeans"],
        choices=list(SUPPORTED_CLUSTERINGS),
    )
    parser.add_argument(
        "--index-type", default="learned-index",
        choices=["baseline", "learned-index"],
    )
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="run offline on N synthetic clustered vectors")
    parser.add_argument("--synthetic-dim", type=int, default=96)
    parser.add_argument("--nav-temp", default=None,
                        help="navigation softmax temperature: scalar or "
                             "per-level comma list (e.g. '1,4')")
    parser.add_argument("--policy", default="best_first",
                        choices=["best_first", "joint"])
    parser.add_argument("--seed", type=int, default=2023)
    parser.add_argument("--chunk-size", type=int, default=1024)
    parser.add_argument("--dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--batch-size", type=int, default=256)
    parser.add_argument("--out-dir", default="result")
    parser.add_argument(
        "--shard-devices", type=int, default=0, metavar="N",
        help="build and search over N devices: the first N cards (-1 = all; "
        "0 = one device, the default); with --device cpu, N repeats of the CPU, "
        "the counterpart of the JAX package's N virtual CPU devices",
    )
    parser.add_argument("--data-dir", default="data",
                        help="where SISAP HDF5 files live (or are staged)")
    parser.add_argument(
        "--download", action=argparse.BooleanOptionalAction, default=True,
        help="--no-download = strictly offline: use staged SISAP files "
        "only and fail with the expected path instead of downloading",
    )
    parser.add_argument("--device", default="cuda",
                        help="torch device to build and search on (cuda, cpu, ...)")
    return parser


def expand_per_level(args: dict) -> None:
    """Broadcast the per-level flags given once to every level of
    ``--n-categories``; a flag with another count raises ``ValueError``."""
    n = len(args["n_categories"])
    for arg in ("clustering_algorithm", "model_type", "epochs", "lr"):
        if len(args[arg]) == 1:
            args[arg] = args[arg] * n
        elif len(args[arg]) != n:
            raise ValueError(f"--{arg.replace('_', '-')} must have 1 or {n} values")


def parse_nav_temp(value: Optional[str]):
    """``--nav-temp``: None, one float, or a list of floats (one a level)."""
    if value is None:
        return None
    temps = [float(t) for t in str(value).split(",")]
    return temps[0] if len(temps) == 1 else temps


def sweep_arguments(args: argparse.Namespace) -> dict:
    """The keyword arguments of :func:`sweep` that parsed, expanded
    ``args`` stand for."""
    return dict(
        kind=args.dataset,
        key=args.emb,
        size=args.size,
        k=args.k,
        n_buckets_perc=args.buckets_perc,
        n_categories=args.n_categories,
        epochs=args.epochs,
        model_types=args.model_type,
        lr=args.lr,
        preprocess=args.preprocess,
        save=args.save,
        clustering_algorithms=args.clustering_algorithm,
        n_buckets_explicit=args.n_buckets,
        synthetic=args.synthetic,
        synthetic_dim=args.synthetic_dim,
        policy=args.policy,
        nav_temp=parse_nav_temp(args.nav_temp),
        seed=args.seed,
        chunk_size=args.chunk_size,
        dtype=args.dtype,
        batch_size=args.batch_size,
        shard_devices=args.shard_devices,
        download=args.download,
        data_dir=args.data_dir,
        device=args.device,
    )


def parse_args(argv=None) -> argparse.Namespace:
    """Parse ``argv`` and expand the per-level flags."""
    args = build_parser().parse_args(argv)
    expand_per_level(vars(args))
    return args


def main(argv=None):
    configure_logging()
    args = parse_args(argv)
    return run(index_type=args.index_type, out_dir=args.out_dir, **sweep_arguments(args))


if __name__ == "__main__":
    main()
