"""Multi-process execution on ``torch.distributed`` (counterpart of
``learnedmetricindex_tpu/parallel/multiprocess.py``).

The JAX package runs one process per host and lets a global mesh span
every chip of every process.  The port runs one process (a *rank*) per
device:

* :func:`initialize` joins the ranks into one process group: NCCL when
  the rank's device is a GPU, gloo when it is the CPU.  Nothing falls
  back: asking for CUDA without a GPU or without NCCL raises.
* :func:`global_mesh` returns the world as this rank sees it, a
  :class:`World`: its rank, the world size, its own device and the
  process group.  A rank cannot address another rank's device, so the
  world is not a list of devices; ``devices=`` takes it wherever it
  takes a list (``LearnedIndexBuilder``, ``StackedNodeTrainer``,
  ``sharded_kmeans``, ``shard_store``, ``LearnedIndex.get_sharded_store``).
* :func:`from_process_local` keeps each rank's own row block where it
  lies (``parallel/distributed.py::RankRows``); the corpus never funnels
  through one rank.

The ranks then run the device-list code with collectives where the
device list adds on its first device: Lloyd's partial sums and the
data-parallel gradients are all-gathered and added in rank order, so a
world of ``W`` ranks computes what the list ``["cpu"] * W`` computes;
a sharded store is filled by ``all_to_all`` exchanges of bounded
bytes that send each row to the rank owning its bucket, and a search ends in one ``all_gather`` of
the ranks' ``(Q, k)`` results.  Every collective of the port goes
through :func:`all_gather` and :func:`all_to_all` here.

``put_global`` and ``reshard`` are not ported: they place a
``jax.Array`` over a global mesh, and here each rank holds its own
tensors.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_DEVICE: Optional[torch.device] = None  # this rank's device, from initialize()


@dataclass(frozen=True)
class World:
    """The ranks of a process group as one of them sees it: ``rank`` of
    ``size``, this rank's ``device`` and the ``group``.  ``len(world)``
    is the world size, as ``len(devices)`` is a device list's."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None

    def __len__(self) -> int:
        return self.size


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device,
) -> None:
    """Join the process group (idempotent: returns when one exists).

    ``coordinator_address``: ``host:port`` (a TCP rendezvous) or a URL
    ``torch.distributed`` takes (``tcp://…``, ``file://…``); by default
    torchrun's ``MASTER_ADDR`` and ``MASTER_PORT``.  ``num_processes``
    and ``process_id`` default to ``WORLD_SIZE`` and ``RANK``.
    ``device`` is this rank's device: CUDA runs NCCL, the CPU gloo; a
    bare ``"cuda"`` resolves through :func:`rank_device`."""
    global _DEVICE
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} was asked for but CUDA is not available")
        if not dist.is_nccl_available():
            raise RuntimeError(f"device {device} needs the NCCL backend, which this torch lacks")
        device = rank_device(device)
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"a rank's device is 'cuda' or 'cpu', got {device}")
    if dist.is_initialized():
        if _DEVICE is None:
            _DEVICE = device
        return
    if coordinator_address is None and os.environ.get("MASTER_ADDR") and os.environ.get(
            "MASTER_PORT"):
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize needs a coordinator address, a process count and a process id "
            "(or torchrun's MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init_method, world_size=int(num_processes),
                            rank=int(process_id))
    _DEVICE = device


def rank_device(device) -> torch.device:
    """``device`` with its index: a bare ``"cuda"`` is the card of this
    rank's ``LOCAL_RANK`` (torchrun sets it, one card a local rank),
    else the current card."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if os.environ.get("LOCAL_RANK"):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


def global_mesh() -> World:
    """This rank's view of the world (the JAX package's global mesh)."""
    if not dist.is_initialized() or _DEVICE is None:
        raise RuntimeError("call multiprocess.initialize first")
    return World(dist.get_rank(), dist.get_world_size(), _DEVICE, dist.group.WORLD)


def is_multiprocess(devices) -> bool:
    """True when ``devices`` is a world of more than one rank."""
    return isinstance(devices, World) and devices.size > 1


def all_gather(t: torch.Tensor, world: World) -> List[torch.Tensor]:
    """``t`` of every rank, in rank order (same shape and dtype on every
    rank, on the rank's device)."""
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(world.size)]
    dist.all_gather(out, t, group=world.group)
    return out


def all_to_all(send: torch.Tensor, send_counts: Sequence[int], recv_counts: Sequence[int],
               world: World) -> torch.Tensor:
    """Rows ``send`` (grouped by destination rank, ``send_counts[r]`` for
    rank ``r``) exchanged: returns the rows every rank sent here, in
    source-rank order (``recv_counts[r]`` from rank ``r``)."""
    send = send.contiguous()
    out = send.new_empty((int(sum(recv_counts)),) + tuple(send.shape[1:]))
    dist.all_to_all_single(out, send, [int(c) for c in recv_counts],
                           [int(c) for c in send_counts], group=world.group)
    return out


def to_host_replicated(local: torch.Tensor, world: World,
                       sizes: Optional[Sequence[int]] = None) -> np.ndarray:
    """Every rank's ``local`` rows, joined in rank order, as numpy on
    every rank (one ``all_gather``).  ``sizes``: each rank's row count
    when they differ (every rank passes the same list)."""
    if sizes is None:
        return torch.cat(all_gather(local, world)).cpu().numpy()
    width = max(int(s) for s in sizes)
    padded = local.new_zeros((width,) + tuple(local.shape[1:]))
    padded[: local.shape[0]] = local
    parts = all_gather(padded, world)
    return torch.cat([p[: int(s)] for p, s in zip(parts, sizes)]).cpu().numpy()


def from_process_local(local_rows, world: World, row_scales=None):
    """This rank's rows of a corpus split over the ranks: each rank passes
    only its own block, the same number of rows on every rank (one
    ``all_gather`` of the counts checks that and gives the global
    offsets: rank ``r`` holds rows ``r·m .. (r+1)·m``).  Host floats
    become f32 on the rank's device; int8 stays int8 with ``row_scales``.
    Returns ``parallel.distributed.RankRows``, which the builder, the
    clustering and ``shard_store`` take where they take a corpus."""
    from learnedmetricindex_tpu_torch.parallel.distributed import RankRows

    dev = world.device
    if isinstance(local_rows, torch.Tensor):
        x = local_rows.to(dev)
    else:
        arr = np.asarray(local_rows)
        if arr.dtype != np.int8:
            arr = arr.astype(np.float32, copy=False)
        x = torch.as_tensor(np.ascontiguousarray(arr), device=dev)
    scales = None
    if row_scales is not None:
        scales = torch.as_tensor(row_scales if isinstance(row_scales, torch.Tensor)
                                 else np.asarray(row_scales, np.float32)).to(dev, torch.float32)
    counts = [int(c) for c in all_gather(
        torch.tensor([x.shape[0]], dtype=torch.int64, device=dev), world)]
    if len(set(counts)) > 1:
        raise ValueError(f"from_process_local needs equal row counts per rank, got {counts}")
    starts = np.arange(world.size + 1, dtype=np.int64) * counts[0]
    return RankRows(x, scales, starts, world)
