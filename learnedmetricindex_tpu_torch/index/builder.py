"""Index construction (counterpart of
``learnedmetricindex_tpu/index/builder.py``).

Top-down, level by level: cluster each node's rows with k-means, train
the level's node MLPs to imitate the clustering, then partition the
rows by the MLPs' *own predictions* and recurse.  ``build()`` returns
the reference 5-tuple ``(index, data_prediction, n_buckets, build_t,
cluster_t)``; ``data_prediction`` is an ``(n, n_levels)`` int64 matrix
padded with -1.

Both clustering routes of the JAX package are kept: at levels below the
root, sibling nodes with at least ``C`` rows are clustered together by
``kmeans_nodes`` (turned off with ``LMI_BATCHED_NODE_KMEANS=0``); every
other node goes through the serial per-node loop with the reference's
guards (< 2 rows → one cluster; fewer rows than clusters → ``n // 5``,
at least 2).  Per-node seeds are ``seed + level·1_000_003 + node``.

``devices`` (the JAX package's ``mesh=``) builds over a list of
devices: the corpus is split into contiguous row blocks over them
(``parallel/distributed.py``), deeper levels' sibling nodes are
clustered by ``kmeans_nodes(devices=)``, each node block reading its
rows where they lie, and every level's models train on
``StackedNodeTrainer(devices=)``.  The root is clustered as on one
device: the builder holds the whole corpus on ``devices[0]`` and the
fit takes a seeded sample of at most 256 rows a cluster, so spreading
it would gain nothing.  (The JAX package's mesh path fits the root on
every row with ``sharded_kmeans``; on the near-uniform CLI corpus that
gives a flatter partition and lower recall at few visits.)  The routers
live on ``device``, which must be ``devices[0]``.

``devices`` may be the world of a multi-process run
(``parallel.multiprocess.global_mesh()``), the corpus then this rank's
rows (``multiprocess.from_process_local``).  Every rank runs the same
build: the root and every deeper node are clustered by the one-device
call over the rank-local corpus (the same seeded sample on every rank,
read through one collective; each rank assigns its own rows), deeper
levels take the serial per-node path as the JAX package's multi-process
build does, and every level trains data parallel across the ranks.
``data_prediction`` and the routers come out the same on every rank.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch.config import BuildConfiguration
from learnedmetricindex_tpu_torch.index.index import LearnedIndex, LevelModels, resolve_device
from learnedmetricindex_tpu_torch.index.navigation import TreeLayout
from learnedmetricindex_tpu_torch.models.train import StackedNodeTrainer, group_rows
from learnedmetricindex_tpu_torch.ops.clustering import algorithms as clustering_algorithms
from learnedmetricindex_tpu_torch.ops.kmeans import kmeans_nodes
from learnedmetricindex_tpu_torch.parallel.distributed import RankRows, split_rows
from learnedmetricindex_tpu_torch.parallel.multiprocess import World

EMPTY_VALUE = -1
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _guarded_n_clusters(n_rows: int, n_clusters: int) -> int:
    """The reference's guard: fewer rows than clusters → ``n // 5``, at least 2."""
    if n_rows < n_clusters:
        n_clusters = max(n_rows // 5, 2)
    return n_clusters


class LearnedIndexBuilder:
    """Builds a :class:`LearnedIndex` on ``device`` from ``data``: a float
    array, a tensor, or ``(int8 values, f32 row scales)`` for a
    quantized corpus.  Host data is uploaded once, as f32 (as
    ``config.dtype`` for training when that is bf16); a tensor stays
    where it lies and must lie on ``device``.  ``devices``: build over
    this list of devices (module docstring), ``devices[0] == device``;
    or over a world's ranks, ``data`` then this rank's ``RankRows`` and
    ``device`` the rank's device."""

    def __init__(self, data, config: BuildConfiguration, *, device, devices=None):
        self.device = resolve_device(device)
        self.config = config
        self.devices = self.blocks = None
        if isinstance(devices, World) or isinstance(data, RankRows):
            if not (isinstance(devices, World) and isinstance(data, RankRows)):
                raise TypeError("a build across ranks takes from_process_local's rows and "
                                "devices=global_mesh()")
            if devices.device != self.device:
                raise ValueError(f"the rank's device is {devices.device}, the builder runs on "
                                 f"{self.device}")
            self.data = data
            self.row_scales = None  # carried by the rows
            self.devices = devices
            return
        values, scales = data if isinstance(data, tuple) else (data, None)
        self.data = self._on_device(values, None)
        self.row_scales = None if scales is None else self._on_device(scales, torch.float32)
        if devices is not None:
            self.devices = [resolve_device(d) for d in devices]
            if not self.devices or self.devices[0] != self.device:
                raise ValueError(f"devices[0] must be the builder's device {self.device}, "
                                 f"got {self.devices[:1]}")
            self.blocks = split_rows(self.data, self.devices, self.row_scales)

    def _on_device(self, x, dtype):
        if isinstance(x, torch.Tensor):
            if x.device != self.device:
                raise ValueError(f"the corpus lies on {x.device}, the builder runs on {self.device}")
            return x if dtype is None else x.to(dtype)
        arr = np.asarray(x)
        if dtype is None and arr.dtype != np.int8:
            dtype = torch.float32
        t = torch.as_tensor(np.ascontiguousarray(arr), device=self.device)
        return t if dtype is None else t.to(dtype)

    def _train_data(self) -> torch.Tensor:
        """The rows the trainer gathers: the corpus as it is, or a bf16
        copy of a float corpus when the configuration asks for bf16."""
        dt = _DTYPES.get(self.config.dtype, torch.float32)
        if isinstance(self.data, RankRows):
            if self.data.block.dtype == torch.float32 and dt != torch.float32:
                return dataclasses.replace(self.data, block=self.data.block.to(dt))
            return self.data
        if self.data.dtype == torch.float32 and dt != torch.float32:
            return self.data.to(dt)
        return self.data

    def _cluster_batched(self, level, parent_gid, eligible, C, labels_full, class_mask):
        """Sibling nodes clustered together; dense label compaction and the
        class mask per node, as the serial path's unique-shrink."""
        seeds = (self.config.seed + level * 1_000_003 + eligible).astype(np.int64)
        if self.devices is not None:
            lab_b = kmeans_nodes(self.blocks, parent_gid, eligible, C, seeds=seeds,
                                 devices=self.devices)
        else:
            lab_b = kmeans_nodes(self.data, parent_gid, eligible, C, seeds=seeds,
                                 row_scales=self.row_scales)
        sel = lab_b >= 0
        pos = np.full(class_mask.shape[0], len(eligible), np.int64)
        pos[eligible] = np.arange(len(eligible))
        b = pos[parent_gid[sel]]
        hist = np.zeros((len(eligible), C), np.int64)
        np.add.at(hist, (b, lab_b[sel]), 1)
        present = hist > 0
        remap = np.cumsum(present, axis=1) - 1
        labels_full[sel] = remap[b, lab_b[sel]].astype(np.int32)
        class_mask[eligible[:, None], np.arange(C)[None, :]] = (
            np.arange(C)[None, :] < present.sum(axis=1)[:, None]
        )

    def _cluster_serial(self, level, gid, rows, C, algorithm, labels_full, class_mask):
        """One node through the registry, with the reference's guards."""
        n = self.data.shape[0]
        if len(rows) < 2:
            labels_full[rows] = 0
            class_mask[gid, :1] = True
            return
        k_g = _guarded_n_clusters(len(rows), C)
        _, lab = clustering_algorithms[algorithm](
            self.data,
            k_g,
            {
                "seed": self.config.seed + level * 1_000_003 + int(gid),
                "round_sizes": level > 0,
                "row_scales": self.row_scales,
                "rows": None if len(rows) == n else rows,
            },
        )
        if len(lab) != len(rows):
            raise ValueError(
                f"clustering backend returned {len(lab)} labels for {len(rows)} rows"
            )
        # dense labels: the reference's len(np.unique(labels)) shrink
        uniques, lab = np.unique(lab, return_inverse=True)
        labels_full[rows] = lab.astype(np.int32)
        class_mask[gid, : len(uniques)] = True

    def build(self) -> Tuple[LearnedIndex, np.ndarray, int, float, float]:
        s = time.perf_counter()
        cfg = self.config
        n, d = self.data.shape
        data_prediction = np.full((n, cfg.n_levels), EMPTY_VALUE, dtype=np.int64)
        levels: List[LevelModels] = []
        cluster_t_total = 0.0
        self.rounds: List[int] = []
        valid_nodes = np.ones(1, dtype=bool)  # level 0: the root
        train_data = self._train_data()

        for level in range(cfg.n_levels):
            params = cfg.level_configurations[level]
            n_models = int(np.prod(cfg.n_categories[:level], dtype=np.int64)) if level else 1
            C = params.n_categories
            if level == 0:
                parent_gid = np.zeros(n, dtype=np.int64)
            else:
                parent_gid = np.ravel_multi_index(
                    tuple(data_prediction[:, l] for l in range(level)),
                    tuple(cfg.n_categories[:level]),
                )
            counts = np.bincount(parent_gid, minlength=n_models)
            if (valid_nodes & (counts == 0)).any():
                raise AssertionError("There are no data points associated with the given path.")

            # ---- per-node clustering ----
            labels_full = np.zeros(n, dtype=np.int32)
            class_mask = np.zeros((n_models, C), dtype=bool)
            s_cluster = time.perf_counter()
            handled = np.zeros(n_models, dtype=bool)
            serial_nodes = np.nonzero(valid_nodes)[0]
            if (
                level > 0
                and not isinstance(self.devices, World)  # across ranks: serial, as JAX's
                and params.clustering_algorithm in ("kmeans", "faiss_kmeans", "scikit_kmeans")
                and os.environ.get("LMI_BATCHED_NODE_KMEANS", "1") != "0"
            ):
                eligible = serial_nodes[counts[serial_nodes] >= max(C, 2)]
                if len(eligible) > 1:
                    self._cluster_batched(level, parent_gid, eligible, C, labels_full, class_mask)
                    handled[eligible] = True
            for gid in serial_nodes:
                if not handled[gid]:
                    rows = np.nonzero(parent_gid == gid)[0]
                    self._cluster_serial(level, gid, rows, C, params.clustering_algorithm,
                                         labels_full, class_mask)
            synced = [self.device] if isinstance(self.devices, World) else self.devices or []
            for dev in {self.device, *synced}:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
            cluster_t = time.perf_counter() - s_cluster
            cluster_t_total += cluster_t

            # ---- all node models of the level, trained together ----
            grouped = group_rows(train_data, parent_gid, n_models, labels=labels_full,
                                 tile=4096, scales=self.row_scales)
            trainer = StackedNodeTrainer(
                n_models, d, C, model_type=params.model_type, lr=params.lr,
                batch_size=cfg.batch_size, seed=cfg.seed + level,
                update_rule=cfg.update_rule, device=self.device, devices=self.devices,
            )
            trainer.set_class_mask(class_mask)
            if params.class_weight == "balanced":
                # inverse-frequency weights per node: w[m,c] = n_m / (C_m · count[m,c])
                cnt = np.zeros((n_models, C), np.int64)
                np.add.at(cnt, (parent_gid, labels_full), 1)
                n_m = cnt.sum(axis=1, keepdims=True)
                c_m = class_mask.sum(axis=1, keepdims=True)
                with np.errstate(divide="ignore", invalid="ignore"):
                    w = n_m / (np.maximum(c_m, 1) * cnt)
                w = np.where(class_mask & (cnt > 0), w, 0.0)
                trainer.set_class_weight(w.astype(np.float32))
            preds_slots, rounds = trainer.fit(grouped, params.epochs)
            self.rounds.append(rounds)
            data_prediction[:, level] = grouped.scatter_to_rows(
                preds_slots.astype(np.int64), n, fill=EMPTY_VALUE
            )
            levels.append(LevelModels(
                mlp=trainer.mlp,
                class_mask=torch.as_tensor(class_mask, device=self.device),
                model_type=params.model_type,
            ))
            # next level's node validity = this level's (node, class) grid
            valid_nodes = (valid_nodes[:, None] & class_mask).reshape(-1)

        index = LearnedIndex(
            levels=levels,
            layout=TreeLayout.create(cfg.n_categories),
            config=cfg,
            leaf_valid=valid_nodes,
            device=self.device,
        )
        build_t = time.perf_counter() - s
        return index, data_prediction, int(valid_nodes.sum()), build_t, cluster_t_total
