"""Lloyd's k-means (counterpart of ``learnedmetricindex_tpu/ops/kmeans.py``).

Same algorithm and settings as the JAX package, which mimics faiss:

* init: ``k`` data points at seeded random indices, nudged apart by
  ``+ arange(k)`` (``_kmeans_device`` :88-92);
* assignment: argmin over ``||c||² - 2 x·c`` in full f32 whatever the
  caller's TF32 settings (ties to the first centroid), tiled over rows;
* update: one-hot matmul sums per tile, divided by the counts;
* an empty cluster is re-seeded deterministically from the largest one:
  ``c_j = c_biggest · (1 + 1e-4 (1 + j))``;
* training subsample: at most ``256·k`` points, drawn with numpy's
  ``default_rng(seed)`` exactly as the JAX package draws them, so the
  subsample indices are identical.

What differs is the PRNG of the init and of the per-node samples: the
JAX package draws them with ``jax.random``, the port with a CPU
``torch.Generator`` seeded the same way (so the CPU and the GPU draw the
same indices).  :func:`kmeans_device` takes ``init_idx`` so a caller can
feed any draw, the JAX package's included.

Data may be a numpy array (clustered on the CPU, where it lies) or a
tensor (clustered on its device), f32/bf16, or int8 with ``row_scales``.
:func:`kmeans` also takes a corpus split over the ranks of a world
(``parallel.distributed.RankRows``): every rank draws the same sample,
reads its rows through one collective, fits the same centroids, assigns
its own rows, and the labels are all-gathered.
Labels are ``int32`` in ``[0, k)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch import native
from learnedmetricindex_tpu_torch.ops.precision import full_f32


def _as_tensor(data) -> torch.Tensor:
    """A tensor as is; a numpy array as a CPU tensor sharing its memory
    (copied only when numpy marks it read-only)."""
    if isinstance(data, torch.Tensor):
        return data
    arr = np.asarray(data)
    return torch.from_numpy(arr if arr.flags.writeable else arr.copy())


def rows_f32(data: torch.Tensor, idx=None, scales=None) -> torch.Tensor:
    """``data[idx]`` (all rows when ``idx`` is None) as f32, times the row
    scales of an int8 corpus."""
    if idx is not None:
        idx = torch.as_tensor(idx, device=data.device).long()
    x = (data if idx is None else data[idx]).float()
    if scales is not None:
        sc = _as_tensor(scales).to(device=data.device, dtype=torch.float32)
        x = x * (sc if idx is None else sc[idx])[:, None]
    return x


def init_indices(n: int, n_clusters: int, generator: torch.Generator) -> torch.Tensor:
    """The random init of :func:`kmeans_device`: ``n_clusters`` indices in
    ``[0, n)``, each nudged by its position (duplicates are rare for
    n ≫ k; the empty-cluster resplit handles the rest)."""
    n = max(n, 1)
    draw = torch.randint(0, n, (n_clusters,), generator=generator)
    return (draw + torch.arange(n_clusters)) % n


@full_f32()
def _lloyd(x: torch.Tensor, init_idx: torch.Tensor, n_iters: int, tile_rows: int):
    """Batched Lloyd's: ``x`` (P, T, d) f32 problems, ``init_idx`` (P, R,
    C) init rows for R restarts each.  Returns centroids (P, R, C, d)
    and final labels (P, R, T)."""
    P, T, d = x.shape
    R, C = init_idx.shape[1:]
    rows = init_idx.to(x.device).reshape(P, R * C)
    cent = torch.gather(x, 1, rows[:, :, None].expand(P, R * C, d)).reshape(P, R, C, d)
    eps = 1.0 + 1e-4 * (1.0 + torch.arange(C, dtype=torch.float32, device=x.device))

    def assign(cent, xt):
        c2 = (cent * cent).sum(-1)[:, :, None, :]  # (P, R, 1, C)
        sims = torch.matmul(xt[:, None], cent.transpose(-1, -2))  # (P, R, t, C)
        return torch.argmin(c2 - 2.0 * sims, dim=-1)  # ties → first centroid

    for _ in range(n_iters):
        sums = torch.zeros((P, R, C, d), device=x.device)
        counts = torch.zeros((P, R, C), device=x.device)
        for t0 in range(0, T, tile_rows):
            xt = x[:, t0 : t0 + tile_rows]
            onehot = torch.nn.functional.one_hot(assign(cent, xt), C).float()
            sums += torch.matmul(onehot.transpose(-1, -2), xt[:, None])
            counts += onehot.sum(-2)
        new = sums / torch.clamp_min(counts, 1.0)[..., None]
        # deterministic resplit of empty clusters from the largest one
        biggest = torch.argmax(counts, dim=-1)  # (P, R), first on ties
        big = torch.gather(new, 2, biggest[:, :, None, None].expand(P, R, 1, d))
        cent = torch.where((counts == 0.0)[..., None], big * eps[:, None], new)
    labels = torch.cat(
        [assign(cent, x[:, t0 : t0 + tile_rows]) for t0 in range(0, T, tile_rows)], dim=-1
    )
    return cent, labels


def kmeans_device(
    x: torch.Tensor,
    n_clusters: int,
    *,
    n_iters: int = 25,
    seed: int = 2023,
    init_idx: Optional[torch.Tensor] = None,
    tile_rows: int = 65536,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's on the rows of ``x`` (n, d) f32 where it lies →
    ``(centroids (k, d), labels (n,) int64)``.  ``init_idx`` (k,) gives
    the init rows; by default :func:`init_indices` draws them from a
    CPU generator seeded with ``seed``."""
    if init_idx is None:
        init_idx = init_indices(x.shape[0], n_clusters, torch.Generator().manual_seed(seed))
    cent, labels = _lloyd(x[None], torch.as_tensor(init_idx)[None, None], n_iters, tile_rows)
    return cent[0, 0], labels[0, 0]


def device_free_bytes(device) -> Optional[int]:
    """Free memory of ``device``: ``torch.cuda.mem_get_info`` on a GPU,
    ``None`` elsewhere (host memory bounds nothing here)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return None


@full_f32()
def _assign(centroids: torch.Tensor, data: torch.Tensor, rows, scales, tile_rows: int) -> np.ndarray:
    """Nearest-centroid label of ``data[rows]`` (all rows when ``rows``
    is None), ``tile_rows`` rows at a time."""
    n = data.shape[0] if rows is None else len(rows)
    c = centroids.to(device=data.device, dtype=torch.float32)
    c2 = (c * c).sum(1)[None, :]
    out = []
    for s0 in range(0, n, tile_rows):
        if rows is None:
            x = data[s0 : s0 + tile_rows].float()
            if scales is not None:
                x = x * scales[s0 : s0 + tile_rows][:, None]
        else:
            x = rows_f32(data, rows[s0 : s0 + tile_rows], scales)
        out.append(torch.argmin(c2 - 2.0 * (x @ c.T), dim=1).to(torch.int32))
    return torch.cat(out).cpu().numpy() if out else np.zeros(0, np.int32)


def _assign_tile(n: int, d: int, device) -> int:
    """:func:`kmeans_assign`'s default tile: ~1.5 GB of f32 rows, at most
    a third of the device's free memory."""
    tile_rows = max(8192, min(n, (384 << 20) // max(d, 1)))
    free = device_free_bytes(device)
    if free is not None:
        tile_rows = min(tile_rows, max(8192, (free // 3) // (4 * max(d, 1))))
    return tile_rows


def kmeans_assign(centroids, data, tile_rows: int = 0, row_scales=None) -> np.ndarray:
    """Nearest centroid of each row of ``data`` (faiss's
    ``index.search(data, 1)``), in blocks; ``tile_rows=0`` targets
    ~1.5 GB of f32 rows, clamped to a third of the device's free
    memory."""
    data = _as_tensor(data)
    n, d = data.shape
    tile_rows = int(min(tile_rows or _assign_tile(n, d, data.device), max(8, n)))
    scales = None
    if row_scales is not None:
        scales = _as_tensor(row_scales).to(device=data.device, dtype=torch.float32)
    return _assign(_as_tensor(centroids), data, None, scales, tile_rows)


def kmeans(
    data,
    n_clusters: int,
    n_iters: int = 25,
    seed: int = 2023,
    tile_rows: int = 65536,
    round_sizes: bool = False,
    max_points_per_centroid: int = 256,
    row_scales=None,
    rows=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster ``data`` into ``n_clusters`` → ``(centroids (k, d) f32,
    labels (n,) int32)`` as numpy.

    ``rows``: cluster only these row indices of ``data`` (``len(rows)``
    labels).  ``max_points_per_centroid``: fit on a seeded subsample of
    at most that many points per cluster (faiss's default 256; 0
    disables), then assign every row.  ``round_sizes`` is accepted for
    the JAX package's signature: it pads shapes there to reuse compiled
    programs, and eager PyTorch compiles none."""
    del round_sizes
    return _kmeans_rows(
        data, n_clusters, None if rows is None else np.asarray(rows),
        n_iters=n_iters, seed=seed, max_points_per_centroid=max_points_per_centroid,
        row_scales=row_scales, tile_rows=tile_rows,
    )


def _kmeans_rows(
    data,
    n_clusters: int,
    rows: Optional[np.ndarray],
    *,
    n_iters: int,
    seed: int,
    max_points_per_centroid: int,
    row_scales,
    tile_rows: int = 65536,
) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`kmeans` over ``data[rows]`` (every row when ``rows`` is
    None) without materializing more than the training rows.

    ``data`` is a tensor, or a corpus split over the ranks of a world
    (``RankRows``, which carries its scales; every rank passes the same
    ``rows``, ascending): every rank then reads the same seeded sample
    through ``RankRows.gather`` and fits the same centroids, labels the
    rows it holds, and the labels are joined in rank order, which is
    ``rows`` order.  Only the assignment's matmul shapes differ from the
    one-device call's."""
    from learnedmetricindex_tpu_torch.parallel.distributed import RankRows

    ranks = isinstance(data, RankRows)
    scales = data.scales if ranks else None
    if not ranks:
        data = _as_tensor(data)
        if row_scales is not None:
            scales = _as_tensor(row_scales).to(device=data.device, dtype=torch.float32)
    n = data.shape[0] if rows is None else len(rows)
    assert n_clusters >= 1

    def read(idx):
        if ranks:
            return data.gather(np.arange(n) if idx is None else idx, data.device)
        return rows_f32(data, idx, scales)

    if n < 2:
        # the reference's guard: < 2 points → one cluster
        first = read(np.arange(n) if rows is None else rows)[:1]
        return first.cpu().numpy(), np.zeros(n, dtype=np.int32)
    n_clusters = min(n_clusters, n)
    cap = max_points_per_centroid * n_clusters
    subsampled = bool(max_points_per_centroid) and n > cap
    if subsampled:
        sample = np.sort(np.random.default_rng(seed).choice(n, size=cap, replace=False))
        train = sample if rows is None else rows[sample]
    else:
        train = rows
    centroids, labels = kmeans_device(
        read(train), n_clusters, n_iters=n_iters, seed=seed, tile_rows=tile_rows
    )
    if not subsampled:
        return centroids.cpu().numpy(), labels.to(torch.int32).cpu().numpy()
    if rows is None:
        tile = int(min(_assign_tile(n, data.shape[1], data.device), max(8, n)))
    else:
        tile = 1 << min(18, max(13, (n - 1).bit_length()))  # 8k..256k rows
    if not ranks:
        return centroids.cpu().numpy(), _assign(centroids, data, rows, scales, tile)
    every = np.arange(n) if rows is None else rows
    cuts = np.searchsorted(every, data.starts)  # each rank's share of ``every``
    r = data.world.rank
    mine = None if rows is None else torch.as_tensor(every[cuts[r]:cuts[r + 1]] - data.lo)
    lab = torch.as_tensor(_assign(centroids, data.block, mine, scales, tile), device=data.device)
    return centroids.cpu().numpy(), data.join([lab], sizes=np.diff(cuts))


#: sibling nodes are clustered in blocks of at most ``ceil(M / NODE_BLOCKS)``
#: nodes (and the gather budget), with or without devices, so a node's
#: arithmetic, and so its labels, do not depend on the device list
NODE_BLOCKS = 8


@full_f32()
def kmeans_nodes(
    data,
    parent_gid: np.ndarray,
    node_ids: np.ndarray,
    n_clusters: int,
    *,
    seeds: np.ndarray,
    n_iters: int = 25,
    max_points_per_centroid: int = 256,
    row_scales=None,
    tile: int = 4096,
    node_batch_bytes: int = 1 << 30,
    restarts: int = 4,
    devices=None,
) -> np.ndarray:
    """Cluster many sibling nodes' row sets at once (the JAX package's
    batched sibling k-means).  Each node in ``node_ids`` (every one owning
    at least ``n_clusters`` rows of ``parent_gid``) trains on a seeded
    sample of ``T`` of its rows drawn with replacement, over ``restarts``
    seeded inits, keeping the lowest-inertia run; then every row is
    assigned under its own node's centroids.  Returns labels (n,) int32,
    -1 for rows of other nodes.  Deterministic in ``seeds`` (one per
    node); the draws come from CPU generators, not ``jax.random``.

    ``devices``: the node blocks go to the devices in turn (block ``j``
    to ``devices[j % len(devices)]``; the JAX package shards the node
    axis over its mesh), and each block reads its rows where they lie:
    ``data`` may then be one tensor, a list of per-device row blocks or
    ``parallel.distributed.RowBlocks``.  The blocks are the same with
    and without devices (:data:`NODE_BLOCKS`), so the labels are
    bit-equal."""
    from learnedmetricindex_tpu_torch.parallel import multiprocess as mp
    from learnedmetricindex_tpu_torch.parallel.distributed import RankRows, split_rows

    if mp.is_multiprocess(devices) or (isinstance(data, RankRows) and data.world.size > 1):
        raise ValueError(
            "kmeans_nodes(devices=...) is single-process only (it reads every node's rows "
            "from one process); on a multi-process world run the serial per-node path — the "
            "builder gates this automatically")
    if isinstance(devices, mp.World):  # a world of one rank holds every row
        devices = None
    if isinstance(data, RankRows):
        data, row_scales = data.block, data.scales
    parent_gid = np.asarray(parent_gid)
    node_ids = np.asarray(node_ids, dtype=np.int64)
    seeds = np.asarray(seeds, dtype=np.int64)
    if devices is not None:
        blocks = split_rows(data, devices, row_scales)
        run_on = [torch.device(d) for d in devices]
        n, d = blocks.shape
        read = blocks.gather
    else:
        data = _as_tensor(data)
        run_on = [data.device]
        n, d = data.shape
        scales = None
        if row_scales is not None:
            scales = _as_tensor(row_scales).to(device=data.device, dtype=torch.float32)

        def read(rows, device):
            return rows_f32(data, rows.reshape(-1), scales).reshape(*rows.shape, d).to(device)

    M, C = len(node_ids), n_clusters

    # dense node index per row; rows of other nodes go to dummy group M
    pos = np.full(int(parent_gid.max()) + 1, M, dtype=np.int64)
    pos[node_ids] = np.arange(M)
    b_of_row = pos[parent_gid]
    counts = native.bincount(b_of_row, M + 1)
    assert (counts[:M] >= C).all(), "kmeans_nodes needs >= C rows per node"
    padded = np.maximum(-(-counts[:M] // tile) * tile, tile)
    seg_starts = np.concatenate([[0], np.cumsum(padded)]).astype(np.int64)
    S = int(seg_starts[-1])
    slot_rows, _ = native.fill_slots(
        b_of_row, np.concatenate([seg_starts[:-1], [S]]), S + int(counts[M])
    )
    slot_rows = slot_rows[:S]  # drop the dummy segment
    tile_node = np.repeat(np.arange(M), padded // tile)

    # training-sample size: the faiss cap, bounded by the largest node
    cap = max(max_points_per_centroid * C, C)
    T = 256
    while T < min(cap, int(counts[:M].max())):
        T *= 2
    T = min(T, cap)

    # per node: the sample, then each restart's init, from one generator
    samples, inits = [], []
    for m in range(M):
        g = torch.Generator().manual_seed(int(seeds[m]))
        samples.append(torch.randint(0, int(counts[m]), (T,), generator=g) + int(seg_starts[m]))
        inits.append(torch.stack([init_indices(T, C, g) for _ in range(restarts)]))
    slot_rows_t = torch.as_tensor(slot_rows, device=run_on[0]).long()
    M_b = min(M, max(1, int(node_batch_bytes // max(T * d * 4, 1))), -(-M // NODE_BLOCKS))
    B = max(1, (256 << 20) // (tile * d * 4))  # assignment tiles a step
    labs = []  # every tile's labels, in slot order
    for j, m0 in enumerate(range(0, M, M_b)):
        m1 = min(m0 + M_b, M)
        dev = run_on[j % len(run_on)]
        rows = slot_rows_t[torch.stack(samples[m0:m1]).to(run_on[0])]  # (m1 - m0, T)
        x = read(rows, dev)
        cent, lab = _lloyd(x, torch.stack(inits[m0:m1]), n_iters, tile_rows=T)
        # inertia per (node, restart); the first of the lowest wins
        inertia = torch.stack([
            ((x - torch.gather(cent[:, r], 1, lab[:, r, :, None].expand(-1, -1, d))) ** 2)
            .sum((-1, -2))
            for r in range(restarts)
        ], dim=1)
        best = torch.argmin(inertia, dim=1)
        centroids = cent[torch.arange(m1 - m0, device=dev), best]  # (m1 - m0, C, d)
        del x, cent, lab

        # the block's slots under their own node's centroids, B tiles at a time
        t_lo, t_hi = int(seg_starts[m0]) // tile, int(seg_starts[m1]) // tile
        srt = slot_rows_t[t_lo * tile : t_hi * tile].reshape(-1, tile)
        tn = torch.as_tensor(tile_node[t_lo:t_hi] - m0, device=dev)
        for t0 in range(0, t_hi - t_lo, B):
            r = srt[t0 : t0 + B]
            x = read(r.clamp_min(0), dev)
            c = centroids[tn[t0 : t0 + B]]  # (B, C, d)
            c2 = (c * c).sum(-1)[:, None, :]
            lab = torch.argmin(c2 - 2.0 * torch.bmm(x, c.transpose(1, 2)), dim=-1)
            labs.append(torch.where(r.to(dev) >= 0, lab, -1).reshape(-1).to(run_on[0]))
    labs = torch.cat(labs).to(torch.int32).cpu().numpy()
    labels = np.full(n, -1, dtype=np.int32)
    valid = slot_rows >= 0
    labels[slot_rows[valid]] = labs[valid]
    return labels
