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

Across the ranks of a ``torch.distributed`` world
(``parallel/multiprocess.py``) each rank holds only its own block
(:class:`RankRows`); rows another rank holds are read through a
collective (:meth:`RankRows.gather`), and Lloyd's all-gathers the
ranks' partial sums and counts and adds them in rank order, so a world
of ``W`` ranks gives the centroids and labels of ``["cpu"] * W``
bit for bit.

The other multi-device engines live with their single-device
counterparts: ``ops/kmeans.py::kmeans_nodes(devices=)``,
``models/train.py::StackedNodeTrainer(devices=)`` and
``parallel/sharded_index.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch.ops.kmeans import init_indices
from learnedmetricindex_tpu_torch.ops.precision import full_f32
from learnedmetricindex_tpu_torch.parallel import multiprocess as mp


class RowBlocks(NamedTuple):
    """A corpus as contiguous row blocks, block ``i`` (global rows
    ``starts[i] .. starts[i + 1]``) on ``devices[i]``, in its own type;
    ``scales`` holds an int8 corpus's row scales the same way.

    It shares its reading interface with :class:`RankRows` (``home``,
    ``owned``, ``local``, ``device_of``, ``block_f32``, ``gather``,
    ``add_in_order``, ``join``), so Lloyd's and the data-parallel trainer
    run one code path over a device list and over ranks."""

    blocks: List[torch.Tensor]
    scales: Optional[List[torch.Tensor]]
    starts: np.ndarray  # (len(devices) + 1,) int64
    devices: List[torch.device]

    @property
    def shape(self) -> Tuple[int, int]:
        return int(self.starts[-1]), int(self.blocks[0].shape[1])

    @property
    def home(self) -> torch.device:
        """Where partials are added: the first device."""
        return self.devices[0]

    def owned(self) -> List[int]:
        """The blocks this process holds: all of them."""
        return list(range(len(self.blocks)))

    def local(self, i: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Block ``i`` and its scales (None for a float corpus)."""
        return self.blocks[i], None if self.scales is None else self.scales[i]

    def device_of(self, i: int) -> torch.device:
        return self.devices[i]

    def block_f32(self, i: int, lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
        """Local rows ``lo .. hi`` of block ``i`` as f32, times their scales."""
        return _rows_f32(*self.local(i), slice(lo, hi))

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
            out[sel] = _rows_f32(*self.local(i), local).to(device)
        return out.reshape(*rows.shape, self.shape[1])

    def add_in_order(self, parts: Dict[int, torch.Tensor], numel: int) -> torch.Tensor:
        """The sum of the blocks' partials (``parts[i]``, flat f32,
        ``numel`` long; a block absent from ``parts`` adds nothing) on
        ``home``: zeros, then each added in block order.  (From +0 the
        sum never holds a -0, so adding an absent block's zeros instead
        would not change a bit: :meth:`RankRows.add_in_order` does.)"""
        total = torch.zeros(numel, device=self.home)
        for i in sorted(parts):
            total = total + parts[i].to(self.home)
        return total

    def join(self, parts: Sequence[torch.Tensor], sizes=None) -> np.ndarray:
        """The owned blocks' tensors (one each, in ``owned()`` order)
        joined in block order as numpy."""
        del sizes
        return torch.cat([p.cpu() for p in parts]).numpy()


def _rows_f32(block: torch.Tensor, scales: Optional[torch.Tensor], at) -> torch.Tensor:
    """``block[at]`` as f32, times the rows' scales."""
    x = block[at].float()
    if scales is not None:
        x = x * scales[at][..., None]
    return x


@dataclass(frozen=True)
class RankRows:
    """A corpus split over the ranks of a world, as one rank holds it:
    ``block`` is global rows ``starts[rank] .. starts[rank + 1]`` on
    ``world.device``, in its own type (``scales``: an int8 corpus's row
    scales).  ``parallel.multiprocess.from_process_local`` makes one.
    It reads as :class:`RowBlocks` does, with one owned block (the
    rank's) and collectives where a device list reads across devices.
    (Not a tuple: callers unpack a tuple corpus as ``(values, scales)``.)"""

    block: torch.Tensor
    scales: Optional[torch.Tensor]
    starts: np.ndarray  # (world.size + 1,) int64
    world: "mp.World"

    @property
    def shape(self) -> Tuple[int, int]:
        return int(self.starts[-1]), int(self.block.shape[1])

    @property
    def device(self) -> torch.device:
        return self.world.device

    home = device

    @property
    def lo(self) -> int:
        return int(self.starts[self.world.rank])

    def owned(self) -> List[int]:
        return [self.world.rank]

    def local(self, i: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        assert i == self.world.rank, f"rank {self.world.rank} holds no block {i}"
        return self.block, self.scales

    def device_of(self, i: int) -> torch.device:
        return self.world.device

    def block_f32(self, i: int, lo: int = 0, hi: Optional[int] = None) -> torch.Tensor:
        """Local rows ``lo .. hi`` of this rank's block as f32, times their scales."""
        return _rows_f32(*self.local(i), slice(lo, hi))

    def owner(self, rows: torch.Tensor) -> torch.Tensor:
        """The rank holding each global row of ``rows``."""
        starts = torch.as_tensor(self.starts[1:-1], device=rows.device)
        return torch.bucketize(rows, starts, right=True)

    def gather(self, rows, device) -> torch.Tensor:
        """``rows`` (global indices, any shape; every rank passes the same)
        as f32 rows on ``device``: each rank reads the rows it holds into
        zeros, one ``all_gather`` brings every rank's, and each row is
        taken from its owner's (no sum, so the bits are the owner's)."""
        dev = self.device
        rows = rows if isinstance(rows, torch.Tensor) else torch.as_tensor(np.asarray(rows))
        flat = rows.reshape(-1).to(dev).long()
        own = self.owner(flat) == self.world.rank
        mine = torch.zeros((flat.shape[0], self.shape[1]), dtype=torch.float32, device=dev)
        mine[own] = _rows_f32(self.block, self.scales, flat[own] - self.lo)
        every = torch.stack(mp.all_gather(mine, self.world))
        out = every[self.owner(flat), torch.arange(flat.shape[0], device=dev)]
        return out.reshape(*rows.shape, self.shape[1]).to(device)

    def add_in_order(self, parts: Dict[int, torch.Tensor], numel: int) -> torch.Tensor:
        """:meth:`RowBlocks.add_in_order` across ranks: one ``all_gather``
        of every rank's partial (zeros where the rank had none) and the
        same adds, in rank order, on every rank."""
        mine = parts.get(self.world.rank)
        total = torch.zeros(numel, device=self.device)
        for got in mp.all_gather(torch.zeros_like(total) if mine is None else mine, self.world):
            total = total + got
        return total

    def join(self, parts: Sequence[torch.Tensor], sizes=None) -> np.ndarray:
        """This rank's tensor (``parts[0]``) and every other rank's, joined
        in rank order as numpy on every rank; ``sizes``: each rank's row
        count when they differ."""
        return mp.to_host_replicated(parts[0], self.world, sizes)


def split_rows(data, devices: Optional[Sequence], row_scales=None) -> RowBlocks:
    """``data`` as :class:`RowBlocks` over ``devices``: a host array or one
    tensor is cut into contiguous blocks of ``ceil(n / len(devices))``
    rows (the last shorter; the JAX package's row sharding without its
    padding), each moved to its device (a view where it already lies
    there); a list of per-device blocks stays where it is (``devices``
    may then be None).  Host floats
    become f32; int8 stays int8 with ``row_scales``."""
    if isinstance(data, (RowBlocks, RankRows)):
        return data
    if isinstance(devices, mp.World):
        raise TypeError("over the ranks of a world the corpus is "
                        "multiprocess.from_process_local's rows")
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


def _partials(read, n_rows: int, c: torch.Tensor, tile_rows: int):
    """One block's one-hot centroid sums and counts, tile by tile;
    ``read(lo, hi)`` gives the block's rows ``lo .. hi`` as f32."""
    k, d = c.shape
    s_i = torch.zeros((k, d), device=c.device)
    n_i = torch.zeros(k, device=c.device)
    for t0 in range(0, n_rows, tile_rows):
        x = read(t0, t0 + tile_rows)
        onehot = torch.nn.functional.one_hot(_assign(x, c), k).float()
        s_i += onehot.T @ x
        n_i += onehot.sum(0)
    return s_i, n_i


def _labels(read, n_rows: int, c: torch.Tensor, tile_rows: int) -> torch.Tensor:
    return torch.cat([_assign(read(t0, t0 + tile_rows), c) for t0 in range(0, n_rows, tile_rows)]
                     or [torch.zeros(0, dtype=torch.int64, device=c.device)])


@full_f32()
def lloyd_blocks(
    rows, init_idx, n_iters: int = 25, tile_rows: int = 65536
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Lloyd's over every row of ``rows`` from the init rows ``init_idx``
    (global indices): each iteration each device adds its rows' one-hot
    sums and counts, tile by tile; the partials are added on the first
    device in device order; empty clusters are re-split from the largest
    one as in the JAX package (``c_big · (1 + 1e-4 (1 + j))``).  Returns
    the centroids (k, d) on the first device and each block's final
    labels on its device.

    ``rows`` may be :class:`RankRows`: each rank then computes its own
    block's partials, one ``all_gather`` a step brings every rank's and
    they are added in rank order on every rank; the centroids are on
    every rank and the labels are this rank's block's alone."""
    home = rows.home
    init_idx = torch.as_tensor(np.asarray(init_idx), dtype=torch.int64)
    cent = rows.gather(init_idx, home)
    k, d = cent.shape
    eps = 1.0 + 1e-4 * (1.0 + torch.arange(k, dtype=torch.float32, device=home))
    for _ in range(n_iters):
        on_dev, parts = {}, {}
        for i in rows.owned():
            c = on_dev.setdefault(rows.device_of(i), cent.to(rows.device_of(i)))
            s_i, n_i = _partials(lambda lo, hi: rows.block_f32(i, lo, hi),
                                 rows.local(i)[0].shape[0], c, tile_rows)
            parts[i] = torch.cat([s_i.reshape(-1), n_i])
        total = rows.add_in_order(parts, k * d + k)
        sums, counts = total[: k * d].reshape(k, d), total[k * d :]
        new = sums / torch.clamp_min(counts, 1.0)[:, None]
        big = new[torch.argmax(counts)]  # the first of the largest
        cent = torch.where((counts == 0.0)[:, None], big[None, :] * eps[:, None], new)
    return cent, [_labels(lambda lo, hi: rows.block_f32(i, lo, hi), rows.local(i)[0].shape[0],
                          cent.to(rows.device_of(i)), tile_rows)
                  for i in rows.owned()]


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
    list of blocks, a list of their scales).  Over the ranks of a world
    (``devices`` a ``multiprocess.World``) ``data`` is
    :class:`RankRows` and every rank gets the whole result.  Returns
    ``(centroids (k, d) f32, labels (n,) int32)`` as numpy.  The builder does not call
    it: it holds the whole corpus on its first device and clusters the
    root there (``index/builder.py``)."""
    rows = split_rows(data, devices, row_scales)
    n = rows.shape[0]
    n_clusters = min(n_clusters, n)
    init = init_indices(n, n_clusters, torch.Generator().manual_seed(seed))
    cent, labels = lloyd_blocks(rows, init, n_iters)
    return cent.cpu().numpy(), rows.join(labels).astype(np.int32)
