"""Device lists (counterpart of ``learnedmetricindex_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a 2-D ``jax.sharding.Mesh``
with a ``"data"`` and a ``"model"`` axis and runs its sharded search as
one ``shard_map`` program.  The port's sharded search runs from one
process over a plain list of ``torch.device``s, one sub-store each
(``parallel/sharded_index.py``), so a "mesh" here is that list.  A list
may name one device more than once: the CPU has one ``torch`` device,
and a machine with one GPU runs the shards of a sharded store on it in
turn.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch


def data_model_axes(n_devices: int, model_axis: Optional[int] = None) -> Tuple[int, int]:
    """Factor ``n_devices`` into (data, model) axis sizes.

    Defaults to the largest model axis ≤ √n that divides n, keeping the
    data axis ≥ model axis (bucket scans and k-means dominate FLOPs).
    """
    if model_axis is not None:
        assert n_devices % model_axis == 0
        return n_devices // model_axis, model_axis
    m = 1
    for cand in range(int(np.sqrt(n_devices)), 0, -1):
        if n_devices % cand == 0:
            m = cand
            break
    return n_devices // m, m


def create_mesh(n_devices: Optional[int] = None, device_type: str = "cuda") -> List[torch.device]:
    """The first ``n_devices`` devices of ``device_type`` (all of them by
    default), as ``[cuda:0, cuda:1, ...]``; raises if there are fewer.
    ``"cpu"`` has one device.  To run ``n`` shards on fewer devices,
    build the list yourself (``[torch.device("cuda", 0)] * 4``)."""
    if device_type == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(have)]
    elif device_type == "cpu":
        devices = [torch.device("cpu")]
    else:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    if n_devices is not None:
        if len(devices) < n_devices:
            raise RuntimeError(f"need {n_devices} {device_type} devices, have {len(devices)}")
        devices = devices[:n_devices]
    if not devices:
        raise RuntimeError(f"no {device_type} device is available")
    return devices


def device_list(n: int, device) -> List[torch.device]:
    """The devices of ``--shard-devices n`` next to ``--device device``: on
    CUDA the first ``n`` cards (all of them when ``n < 0``; raises if
    there are fewer), as the JAX package's ``create_mesh``; on the CPU
    ``["cpu"] * n`` (one when ``n < 0``), the port's counterpart of the
    JAX package's ``n`` virtual CPU devices."""
    kind = torch.device(device).type
    if kind == "cpu":
        return [torch.device("cpu")] * (n if n > 0 else 1)
    return create_mesh(n if n > 0 else None, kind)
