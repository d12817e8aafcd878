"""The learned index: navigation, bucket scan, merge (counterpart of
``learnedmetricindex_tpu/index/index.py``).

Same observable API as the JAX package's ``LearnedIndex.search``:
``(dists (Q, k) float32, anns (Q, k) uint32 1-based, measured dict)``
with the reference's timing keys.  Everything runs on the index's
``device``: the stacked MLP forward per level, masked softmax with the
navigation temperature, bucket ordering, then
``bucket_store.scan_buckets_device`` (or, for a store sharded over
devices, ``parallel.sharded_index.sharded_search``).  A search opens the
spans ``lmi.upload`` (the queries to the device), ``lmi.navigate``, the
scan's (``bucket_store``) and ``lmi.copy_back`` (``utils/profiling.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch import native
from learnedmetricindex_tpu_torch.config import BuildConfiguration
from learnedmetricindex_tpu_torch.index.bucket_store import (
    BucketStore,
    scan_buckets_device,
)
from learnedmetricindex_tpu_torch.index.navigation import (
    TreeLayout,
    _quantize_visits,
    best_first_device,
    flatten_entry_probs_device,
    joint_order_device,
    max_best_first_queries,
    nav_frontier,
    single_level_order_device,
)
from learnedmetricindex_tpu_torch.models.mlp import StackedMLP
from learnedmetricindex_tpu_torch.parallel.multiprocess import World
from learnedmetricindex_tpu_torch.parallel.sharded_index import (
    ShardedStore,
    shard_store,
    sharded_search,
)
from learnedmetricindex_tpu_torch.utils.profiling import span

NEG_INF = -1e9
CLASSIFY_ROWS = 1 << 16  # rows a slice of LearnedIndex.classify


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no usable
    GPU is present (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for but CUDA is not available")
        if device.index is None:  # "cuda" names the current card: compare as "cuda:N"
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def synchronize(device: torch.device) -> None:
    """Wait for the device, so a host clock around work is its time."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class LevelModels:
    """All node models of one tree level, stacked."""

    mlp: StackedMLP
    class_mask: torch.Tensor  # (n_models, n_categories) bool, on the device
    model_type: str

    @property
    def n_models(self) -> int:
        return int(self.class_mask.shape[0])

    @property
    def n_categories(self) -> int:
        return int(self.class_mask.shape[1])


def _masked_level_probs(mlp: StackedMLP, mask: torch.Tensor, queries, inv_temp=1.0):
    """(Q, n_models, C) conditional probabilities, masked classes at 0;
    ``inv_temp`` scales the logits before the softmax."""
    logits = mlp(queries) * inv_temp  # (M, Q, C)
    m = mask[:, None, :]
    probs = torch.softmax(torch.where(m, logits, NEG_INF), dim=-1)
    return torch.where(m, probs, 0.0).permute(1, 0, 2)


def _navigate_device(
    queries, levels: Sequence[LevelModels], layout: TreeLayout, inv_temps, *, cap: int, policy: str
):
    """Per-level forwards + masking + ordering → (Q, cap) int32 buckets."""
    level_probs = [
        _masked_level_probs(lv.mlp, lv.class_mask, queries, float(inv_temps[i]))
        for i, lv in enumerate(levels)
    ]
    masks = [lv.class_mask for lv in levels]
    if len(level_probs) == 1:
        return single_level_order_device(level_probs[0][:, 0, :], masks[0][0], cap)
    if policy == "joint":
        return joint_order_device(level_probs, masks, cap)
    entry_probs = flatten_entry_probs_device(level_probs, masks)
    return best_first_device(entry_probs, layout, n_buckets=cap, frontier=nav_frontier())


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()


class LearnedIndex:
    """A built index, living on ``device``."""

    def __init__(
        self,
        levels: List[LevelModels],
        layout: TreeLayout,
        config: BuildConfiguration,
        leaf_valid: np.ndarray,
        device,
    ):
        self.levels = levels
        self.layout = layout
        self.config = config
        self.leaf_valid = np.asarray(leaf_valid, dtype=bool)
        self.device = resolve_device(device)
        # (kind, values, data_prediction, store): strong references, so
        # the identity key cannot be recycled while the entry lives; kind
        # ("store", or ("sharded", devices, chunk)) keeps the stores of
        # get_bucket_store and get_sharded_store apart
        self._store_cache: Optional[tuple] = None

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    @property
    def bucket_paths(self) -> List[Tuple[int, ...]]:
        """The path (one category per level) of every valid leaf bucket,
        in leaf order, as the JAX package's ``bucket_paths`` lists them."""
        dims = tuple(self.config.n_categories)
        return [tuple(int(v) for v in np.unravel_index(leaf, dims))
                for leaf in np.nonzero(self.leaf_valid)[0]]

    @property
    def n_buckets(self) -> int:
        return int(self.leaf_valid.sum())

    # ------------------------------------------------------------------
    # persistence (same .npz format as the JAX package)
    # ------------------------------------------------------------------
    def save(self, path: str, data_prediction: Optional[np.ndarray] = None):
        from learnedmetricindex_tpu_torch.index.serialization import save_index

        save_index(self, path, data_prediction)

    @classmethod
    def load(cls, path: str, device):
        from learnedmetricindex_tpu_torch.index.serialization import load_index

        return load_index(path, device)

    # ------------------------------------------------------------------
    # bucket stores
    # ------------------------------------------------------------------
    def classify(self, vectors) -> np.ndarray:
        """Each row's full tree path, ``(n, n_levels)`` int64: per level the
        argmax of its node's masked probabilities, the node being the one
        the previous levels chose (model index = raveled path prefix, the
        builder's convention).  These are the rows' ``data_prediction``
        entries had they been present at build time; ``DynamicIndex``
        routes inserts with them.  Rows go through in slices of
        ``CLASSIFY_ROWS`` (rows are independent), which bounds the (rows,
        models, classes) probabilities a level holds."""
        q = _as_tensor(vectors, self.device)
        cats = tuple(self.config.n_categories)
        out = []
        with torch.no_grad():
            for s0 in range(0, q.shape[0], CLASSIFY_ROWS):
                x = q[s0 : s0 + CLASSIFY_ROWS]
                rows = torch.arange(x.shape[0], device=self.device)
                model = torch.zeros(x.shape[0], dtype=torch.int64, device=self.device)
                preds = []
                for lv, c in zip(self.levels, cats):
                    own = _masked_level_probs(lv.mlp, lv.class_mask, x)[rows, model]  # (n, C)
                    pred = torch.argmax(own, dim=-1)
                    preds.append(pred)
                    model = model * c + pred
                out.append(torch.stack(preds, dim=1))
        if not out:
            return np.zeros((0, self.n_levels), np.int64)
        return torch.cat(out).cpu().numpy().astype(np.int64)

    def bucket_ids_from_prediction(self, data_prediction: np.ndarray) -> np.ndarray:
        """Dense global bucket id per data row (row-major over the path)."""
        return native.ravel_rows(np.asarray(data_prediction), tuple(self.config.n_categories))

    def _n_leaves(self) -> int:
        return int(np.prod(self.config.n_categories, dtype=np.int64))

    def _cached(self, kind, values, data_prediction):
        c = self._store_cache
        if c is not None and c[0] == kind and c[1] is values and c[2] is data_prediction:
            return c[3]
        return None

    def get_bucket_store(self, data_search, data_prediction: np.ndarray) -> BucketStore:
        """Build (and cache) the store of ``data_search``, rows or
        ``(values, row_scales)``.

        A tensor gets a *virtual* store over the tensor itself
        (``BucketStore.build_virtual``: the id grid and no copy of the
        rows; a tensor on another device than the index's is moved there
        first), as the JAX package makes one of a device array; the store
        holds a reference to the tensor.  Host rows are
        packed on the host (``BucketStore.build``, as ``config.dtype``).
        :meth:`prepare_packed_store` packs a tensor."""
        values, scales = data_search if isinstance(data_search, tuple) else (data_search, None)
        store = self._cached("store", values, data_prediction)
        if store is not None:
            return store
        if isinstance(values, torch.Tensor):
            store = BucketStore.build_virtual(
                values.to(self.device),
                self.bucket_ids_from_prediction(data_prediction),
                n_buckets=self._n_leaves(),
                chunk=self.config.chunk_size,
                row_scales=None if scales is None else _as_tensor(scales, self.device),
            )
        else:
            data = np.asarray(values, np.float32)
            if scales is not None:
                data = data * np.asarray(scales, np.float32)[:, None]
            store = BucketStore.build(
                data,
                self.bucket_ids_from_prediction(data_prediction),
                n_buckets=self._n_leaves(),
                chunk=self.config.chunk_size,
                dtype=self.config.dtype,
                device=self.device,
            )
        self._store_cache = ("store", values, data_prediction, store)
        return store

    def prepare_packed_store(self, data_search, data_prediction: np.ndarray) -> BucketStore:
        """Pack a device-resident corpus (a tensor, or ``(int8 tensor,
        row_scales)``) into a store on the index's device.  Pass the
        result as ``store=`` to :meth:`search`; nothing here keeps a
        reference to the corpus, so the caller may free it."""
        values, scales = data_search if isinstance(data_search, tuple) else (data_search, None)
        if not isinstance(values, torch.Tensor):
            raise TypeError("prepare_packed_store expects the corpus as a tensor")
        return BucketStore.build_packed_device(
            values.to(self.device),
            self.bucket_ids_from_prediction(data_prediction),
            n_buckets=self._n_leaves(),
            chunk=self.config.chunk_size,
            row_scales=None if scales is None else _as_tensor(scales, self.device),
        )

    def get_sharded_store(self, data_search, data_prediction: np.ndarray, devices,
                          chunk: Optional[int] = None) -> ShardedStore:
        """Build (and cache) a store sharded by bucket over ``devices`` (a
        list of devices, repeats allowed; ``parallel.mesh.create_mesh``
        lists a machine's): each device holds the slabs of its buckets.
        Pass it as ``store=`` to :meth:`search`.  ``chunk`` defaults to
        ``min(config.chunk_size, 256)``, the JAX package's default off the
        TPU.  ``data_search``: rows or ``(values, row_scales)``; a tensor
        is gathered where it lies.

        Over the ranks of a world (``devices`` a
        ``parallel.multiprocess.World``, ``data_search`` this rank's
        ``from_process_local`` rows, ``data_prediction`` the same on every
        rank) each rank holds its own shard, filled through ``all_to_all``
        exchanges of bounded bytes (``parallel.sharded_index.shard_store``)."""
        values, scales = data_search if isinstance(data_search, tuple) else (data_search, None)
        if not isinstance(devices, World):
            devices = [resolve_device(d) for d in devices]
        chunk = chunk or min(self.config.chunk_size, 256)
        kind = ("sharded", devices if isinstance(devices, World) else tuple(devices), chunk)
        store = self._cached(kind, values, data_prediction)
        if store is not None:
            return store
        store = shard_store(values, self.bucket_ids_from_prediction(data_prediction),
                            self._n_leaves(), devices, chunk=chunk, row_scales=scales)
        self._store_cache = (kind, values, data_prediction, store)
        return store

    # ------------------------------------------------------------------
    # search
    # ------------------------------------------------------------------
    def compute_bucket_order(
        self,
        queries_navigation,
        n_buckets: int,
        policy: str = "best_first",
        keep_on_device: bool = False,
        nav_temp=None,
    ) -> Tuple[object, float]:
        """Per-query bucket visit order: ``(order (Q, n_buckets) global
        bucket ids, -1 padded, seconds)``.  The order is numpy unless
        ``keep_on_device``, which returns the int32 tensor.

        ``nav_temp``: softmax temperature, a scalar or one per level;
        ``None`` = 1.0 (untempered).  Ranking-neutral for one level."""
        with span("lmi.navigate"):
            s = time.perf_counter()
            if policy not in ("best_first", "joint"):
                raise ValueError(f"Unknown navigation policy: {policy}")
            if nav_temp is None:
                nav_temp = 1.0
            temps = (
                [float(nav_temp)] * self.n_levels
                if np.isscalar(nav_temp)
                else [float(t) for t in nav_temp]
            )
            if len(temps) != self.n_levels:
                raise ValueError(f"nav_temp has {len(temps)} entries for {self.n_levels} levels")
            inv_temps = np.asarray([1.0 / t for t in temps], dtype=np.float32)
            q = _as_tensor(queries_navigation, self.device)
            n_leaves = self.layout.n_leaves
            n_buckets = min(n_buckets, n_leaves)
            cap = _quantize_visits(n_buckets, n_leaves)
            # best-first state is (Q, E): wide trees navigate in query slices
            # that fit the state budget (exact: queries are independent)
            step = max(q.shape[0], 1)
            if policy == "best_first" and self.n_levels > 1:
                step = max_best_first_queries(self.layout.n_entries)
            with torch.no_grad():
                order = torch.cat([
                    _navigate_device(q[s0 : s0 + step], self.levels, self.layout, inv_temps,
                                     cap=cap, policy=policy)[:, :n_buckets]
                    for s0 in range(0, max(q.shape[0], 1), step)
                ])
            if not keep_on_device:
                order = order.cpu().numpy()
            synchronize(self.device)
            return order, time.perf_counter() - s

    def search(
        self,
        data_navigation,
        queries_navigation,
        data_search,
        queries_search,
        data_prediction: np.ndarray,
        n_categories: Optional[Sequence[int]] = None,
        n_buckets: int = 1,
        k: int = 10,
        policy: str = "best_first",
        approx_recall: Optional[float] = None,
        store: Optional[BucketStore] = None,
        rerank_margin: int = 6,
        precision: str = "default",
        rerank: bool = True,
        qtile: int = 128,
        nav_temp=None,
    ):
        """Search the ``k`` nearest neighbors in each query's ``n_buckets``
        most probable buckets.

        ``data_navigation``, ``n_categories`` and ``approx_recall`` are
        accepted for signature parity (the scan is always exact per
        visited bucket).  ``precision`` and ``rerank`` as in
        ``bucket_store.scan_buckets_device``.  A :class:`ShardedStore`
        ``store`` runs ``sharded_search`` ("int8" raises there), with the
        same ``qtile`` (the JAX package caps it at 32 for its TPU kernel;
        a query's results do not depend on its tile, and the CUDA kernel
        computes 128-query tiles whatever their fill).  A store sharded
        over the ranks of a world is searched by every rank with the same
        queries, each scanning its own shard, and every rank returns the
        same answer."""
        measured: Dict[str, float] = {
            "inference": 0.0,
            "search": 0.0,
            "search_within_buckets": 0.0,
            "seq_search": 0.0,
            "sort": 0.0,
        }
        if len(queries_navigation) == 0:
            return np.zeros((0, k), np.float32), np.zeros((0, k), np.uint32), measured
        s = time.perf_counter()
        if store is None:
            store = self.get_bucket_store(data_search, data_prediction)
        with span("lmi.upload"):
            q_nav = _as_tensor(queries_navigation, self.device)
            q_search = q_nav if queries_search is queries_navigation else _as_tensor(
                queries_search, self.device
            )
        order, measured["inference"] = self.compute_bucket_order(
            q_nav, n_buckets, policy=policy, keep_on_device=True, nav_temp=nav_temp
        )
        s_scan = time.perf_counter()
        if isinstance(store, ShardedStore):
            dists, anns = sharded_search(
                store, q_search, order, k=k, qtile=qtile, precision=precision,
                rerank=rerank, rerank_margin=rerank_margin,
            )
        else:
            with torch.no_grad():
                dists, ids = scan_buckets_device(
                    store, q_search, order, k=k, qtile=qtile, precision=precision,
                    rerank=rerank, rerank_margin=rerank_margin,
                )
            with span("lmi.copy_back"):
                dists = dists.cpu().numpy()
                anns = ids.cpu().numpy().astype(np.uint32)
        t_scan = time.perf_counter() - s_scan
        measured["search_within_buckets"] = t_scan
        measured["seq_search"] = t_scan
        measured["search"] = time.perf_counter() - s
        return dists, anns, measured
