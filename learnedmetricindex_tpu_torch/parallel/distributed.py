"""Row blocks over a device list and Lloyd's k-means over them
(counterpart of ``learnedmetricindex_tpu/parallel/distributed.py``).

The JAX package shards the corpus rows over a ``Mesh`` and lets XLA turn
the per-iteration centroid sums and counts into a ``psum``.  The port
runs from one process over a list of devices (``parallel/mesh.py``):
the rows are split into contiguous blocks, one a device
(:class:`RowBlocks`); each iteration every device computes its partial
sums and counts where its rows lie, the partials are added on the first
device in device order, and the new centroids go back to every device.
A list may repeat a device (``["cpu"] * 4``; ``[cuda:0] * 4`` on one
card): the blocks are then views of one tensor and the devices take
turns, which checks the results but measures nothing about spreading
the work.

The other multi-device engines live with their single-device
counterparts: ``ops/kmeans.py::kmeans_nodes(devices=)``,
``models/train.py::StackedNodeTrainer(devices=)`` and
``parallel/sharded_index.py``.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch.ops.kmeans import init_indices
from learnedmetricindex_tpu_torch.ops.precision import full_f32


class RowBlocks(NamedTuple):
    """A corpus as contiguous row blocks, block ``i`` (global rows
    ``starts[i] .. starts[i + 1]``) on ``devices[i]``, in its own type;
    ``scales`` holds an int8 corpus's row scales the same way."""

    blocks: List[torch.Tensor]
    scales: Optional[List[torch.Tensor]]
    starts: np.ndarray  # (len(devices) + 1,) int64
    devices: List[torch.device]

    @property
    def shape(self) -> Tuple[int, int]:
        return int(self.starts[-1]), int(self.blocks[0].shape[1])

    def block_f32(self, i: int, lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
        """Local rows ``lo .. hi`` of block ``i`` as f32, times their scales."""
        x = self.blocks[i][lo:hi].float()
        if self.scales is not None:
            x = x * self.scales[i][lo:hi][:, None]
        return x

    def gather(self, rows: torch.Tensor, device) -> torch.Tensor:
        """``rows`` (global indices, any shape) as f32 rows on ``device``,
        each read on the device that holds it: ``rows.shape + (d,)``."""
        device = torch.device(device)
        flat = rows.reshape(-1).to(device).long()
        out = torch.empty((flat.shape[0], self.shape[1]), dtype=torch.float32, device=device)
        starts = torch.as_tensor(self.starts, device=device)
        owner = torch.bucketize(flat, starts[1:-1], right=True)
        for i, dev in enumerate(self.devices):
            sel = torch.nonzero(owner == i)[:, 0]
            if sel.numel() == 0:
                continue
            local = (flat[sel] - int(self.starts[i])).to(dev)
            x = self.blocks[i][local].float()
            if self.scales is not None:
                x = x * self.scales[i][local][:, None]
            out[sel] = x.to(device)
        return out.reshape(*rows.shape, self.shape[1])


def split_rows(data, devices: Optional[Sequence], row_scales=None) -> RowBlocks:
    """``data`` as :class:`RowBlocks` over ``devices``: a host array or one
    tensor is cut into contiguous blocks of ``ceil(n / len(devices))``
    rows (the last shorter; the JAX package's row sharding without its
    padding), each moved to its device (a view where it already lies
    there); a list of per-device blocks stays where it is (``devices``
    may then be None).  Host floats
    become f32; int8 stays int8 with ``row_scales``."""
    if isinstance(data, RowBlocks):
        return data
    if isinstance(data, (list, tuple)):
        if devices is not None and len(data) != len(devices):
            raise ValueError(f"{len(data)} row blocks for {len(devices)} devices")
        blocks = [torch.as_tensor(b) for b in data]
        sizes = [b.shape[0] for b in blocks]
        scales = None if row_scales is None else [
            torch.as_tensor(s, dtype=torch.float32).to(b.device) for s, b in zip(row_scales, blocks)]
        return RowBlocks(blocks, scales, np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64),
                         [b.device for b in blocks])
    if not isinstance(data, torch.Tensor):
        arr = np.asarray(data)
        if arr.dtype != np.int8:
            arr = arr.astype(np.float32, copy=False)
        data = torch.from_numpy(np.ascontiguousarray(arr))
    devices = [torch.device(d) for d in devices]
    n = data.shape[0]
    per = -(-n // len(devices))
    starts = np.minimum(np.arange(len(devices) + 1, dtype=np.int64) * per, n)
    blocks = [data[int(a):int(b)].to(dev) for a, b, dev in zip(starts[:-1], starts[1:], devices)]
    scales = None
    if row_scales is not None:
        sc = torch.as_tensor(row_scales if isinstance(row_scales, torch.Tensor)
                             else np.asarray(row_scales, np.float32)).float()
        scales = [sc[int(a):int(b)].to(dev) for a, b, dev in zip(starts[:-1], starts[1:], devices)]
    return RowBlocks(blocks, scales, starts, devices)


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest centroid of each row (ties to the first), as the JAX
    package's ``argmin(|c|² − 2 x·c)``."""
    c2 = (c * c).sum(1)[None, :]
    return torch.argmin(c2 - 2.0 * (x @ c.T), dim=1)


@full_f32()
def lloyd_blocks(
    rows: RowBlocks, init_idx, n_iters: int = 25, tile_rows: int = 65536
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Lloyd's over every row of ``rows`` from the init rows ``init_idx``
    (global indices): each iteration each device adds its rows' one-hot
    sums and counts, tile by tile; the partials are added on the first
    device in device order; empty clusters are re-split from the largest
    one as in the JAX package (``c_big · (1 + 1e-4 (1 + j))``).  Returns
    the centroids (k, d) on the first device and each block's final
    labels on its device."""
    home = rows.devices[0]
    init_idx = torch.as_tensor(np.asarray(init_idx), dtype=torch.int64)
    cent = rows.gather(init_idx, home)
    k, d = cent.shape
    eps = 1.0 + 1e-4 * (1.0 + torch.arange(k, dtype=torch.float32, device=home))
    for _ in range(n_iters):
        sums = torch.zeros((k, d), device=home)
        counts = torch.zeros(k, device=home)
        on_dev = {}
        for i, dev in enumerate(rows.devices):
            c = on_dev.setdefault(dev, cent.to(dev))
            s_i = torch.zeros((k, d), device=dev)
            n_i = torch.zeros(k, device=dev)
            for t0 in range(0, rows.blocks[i].shape[0], tile_rows):
                x = rows.block_f32(i, t0, t0 + tile_rows)
                onehot = torch.nn.functional.one_hot(_assign(x, c), k).float()
                s_i += onehot.T @ x
                n_i += onehot.sum(0)
            sums += s_i.to(home)
            counts += n_i.to(home)
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        big = new[torch.argmax(counts)]  # the first of the largest
        cent = torch.where((counts == 0.0)[:, None], big[None, :] * eps[:, None], new)
    labels = []
    for i, dev in enumerate(rows.devices):
        c = cent.to(dev)
        labels.append(torch.cat(
            [_assign(rows.block_f32(i, t0, t0 + tile_rows), c)
             for t0 in range(0, rows.blocks[i].shape[0], tile_rows)]
            or [torch.zeros(0, dtype=torch.int64, device=dev)]))
    return cent, labels


def sharded_kmeans(
    data,
    n_clusters: int,
    devices: Sequence,
    n_iters: int = 25,
    seed: int = 2023,
    row_scales=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Lloyd's k-means with the rows split over ``devices`` (the JAX
    package's ``sharded_kmeans``).  The init is ``randint(n) + arange(k)
    mod n`` from a CPU ``torch.Generator`` seeded with ``seed``
    (:func:`init_indices`).  ``data``: a host array, one tensor, a list
    of per-device row blocks (which stay where they lie) or
    :class:`RowBlocks`; int8 rows are read through ``row_scales`` (for a
    list of blocks, a list of their scales).  Returns ``(centroids (k,
    d) f32, labels (n,) int32)`` as numpy.  The builder does not call
    it: it holds the whole corpus on its first device and clusters the
    root there (``index/builder.py``)."""
    rows = split_rows(data, devices, row_scales)
    n = rows.shape[0]
    n_clusters = min(n_clusters, n)
    init = init_indices(n, n_clusters, torch.Generator().manual_seed(seed))
    cent, labels = lloyd_blocks(rows, init, n_iters)
    return (cent.cpu().numpy(),
            torch.cat([lab.cpu() for lab in labels]).to(torch.int32).numpy())
