"""Lloyd's k-means (counterpart of ``learnedmetricindex_tpu/ops/kmeans.py``).

Same algorithm and settings as the JAX package, which mimics faiss:

* init: ``k`` data points at seeded random indices, nudged apart by
  ``+ arange(k)`` (``_kmeans_device`` :88-92);
* assignment: argmin over ``||c||² - 2 x·c`` in full f32 (ties to the
  first centroid), tiled over rows;
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
Labels are ``int32`` in ``[0, k)``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch import native


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


def kmeans_assign(centroids, data, tile_rows: int = 0, row_scales=None) -> np.ndarray:
    """Nearest centroid of each row of ``data`` (faiss's
    ``index.search(data, 1)``), in blocks; ``tile_rows=0`` targets
    ~1.5 GB of f32 rows, clamped to a third of the device's free
    memory."""
    data = _as_tensor(data)
    n, d = data.shape
    if not tile_rows:
        tile_rows = max(8192, min(n, (384 << 20) // max(d, 1)))
        free = device_free_bytes(data.device)
        if free is not None:
            tile_rows = min(tile_rows, max(8192, (free // 3) // (4 * max(d, 1))))
    tile_rows = int(min(tile_rows, max(8, n)))
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
        _as_tensor(data), n_clusters, None if rows is None else np.asarray(rows),
        n_iters=n_iters, seed=seed, max_points_per_centroid=max_points_per_centroid,
        row_scales=row_scales, tile_rows=tile_rows,
    )


def _kmeans_rows(
    data: torch.Tensor,
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
    None) without materializing more than the training rows."""
    n = data.shape[0] if rows is None else len(rows)
    assert n_clusters >= 1
    scales = None
    if row_scales is not None:
        scales = _as_tensor(row_scales).to(device=data.device, dtype=torch.float32)
    if n < 2:
        # the reference's guard: < 2 points → one cluster
        first = rows_f32(data, np.arange(n) if rows is None else rows, scales)[:1]
        return first.cpu().numpy(), np.zeros(n, dtype=np.int32)
    n_clusters = min(n_clusters, n)
    cap = max_points_per_centroid * n_clusters
    subsampled = bool(max_points_per_centroid) and n > cap
    if subsampled:
        sample = np.sort(np.random.default_rng(seed).choice(n, size=cap, replace=False))
        train = sample if rows is None else rows[sample]
    else:
        train = rows
    x = rows_f32(data, train, scales)
    centroids, labels = kmeans_device(
        x, n_clusters, n_iters=n_iters, seed=seed, tile_rows=tile_rows
    )
    if not subsampled:
        return centroids.cpu().numpy(), labels.to(torch.int32).cpu().numpy()
    if rows is None:
        return centroids.cpu().numpy(), kmeans_assign(centroids, data, row_scales=scales)
    tile = 1 << min(18, max(13, (n - 1).bit_length()))  # 8k..256k rows
    return centroids.cpu().numpy(), _assign(centroids, data, rows, scales, tile)


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
) -> np.ndarray:
    """Cluster many sibling nodes' row sets at once (the JAX package's
    batched sibling k-means).  Each node in ``node_ids`` (every one owning
    at least ``n_clusters`` rows of ``parent_gid``) trains on a seeded
    sample of ``T`` of its rows drawn with replacement, over ``restarts``
    seeded inits, keeping the lowest-inertia run; then every row is
    assigned under its own node's centroids.  Returns labels (n,) int32,
    -1 for rows of other nodes.  Deterministic in ``seeds`` (one per
    node); the draws come from CPU generators, not ``jax.random``."""
    data = _as_tensor(data)
    device = data.device
    parent_gid = np.asarray(parent_gid)
    node_ids = np.asarray(node_ids, dtype=np.int64)
    seeds = np.asarray(seeds, dtype=np.int64)
    n, d = data.shape
    M, C = len(node_ids), n_clusters
    scales = None
    if row_scales is not None:
        scales = _as_tensor(row_scales).to(device=device, dtype=torch.float32)

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
    slot_rows_t = torch.as_tensor(slot_rows, device=device).long()
    M_b = min(M, max(1, int(node_batch_bytes // max(T * d * 4, 1))))
    cent_blocks = []
    for m0 in range(0, M, M_b):
        m1 = min(m0 + M_b, M)
        rows = slot_rows_t[torch.stack(samples[m0:m1]).to(device)]  # (M_b, T)
        x = rows_f32(data, rows.reshape(-1), scales).reshape(m1 - m0, T, d)
        cent, lab = _lloyd(x, torch.stack(inits[m0:m1]), n_iters, tile_rows=T)
        # inertia per (node, restart); the first of the lowest wins
        inertia = torch.stack([
            ((x - torch.gather(cent[:, r], 1, lab[:, r, :, None].expand(-1, -1, d))) ** 2)
            .sum((-1, -2))
            for r in range(restarts)
        ], dim=1)
        best = torch.argmin(inertia, dim=1)
        cent_blocks.append(cent[torch.arange(m1 - m0, device=device), best])
    centroids = torch.cat(cent_blocks)  # (M, C, d)

    # every slot under its own node's centroids, a block of tiles at a time
    n_tiles = len(tile_node)
    srt = slot_rows_t.reshape(n_tiles, tile)
    tile_node_t = torch.as_tensor(tile_node, device=device)
    B = max(1, (256 << 20) // (tile * d * 4))
    labs = []
    for t0 in range(0, n_tiles, B):
        r = srt[t0 : t0 + B]
        x = rows_f32(data, r.clamp_min(0).reshape(-1), scales).reshape(*r.shape, d)
        c = centroids[tile_node_t[t0 : t0 + B]]  # (B, C, d)
        c2 = (c * c).sum(-1)[:, None, :]
        lab = torch.argmin(c2 - 2.0 * torch.bmm(x, c.transpose(1, 2)), dim=-1)
        labs.append(torch.where(r >= 0, lab, -1))
    labs = torch.cat(labs).reshape(-1).to(torch.int32).cpu().numpy()
    labels = np.full(n, -1, dtype=np.int32)
    valid = slot_rows >= 0
    labels[slot_rows[valid]] = labs[valid]
    return labels
