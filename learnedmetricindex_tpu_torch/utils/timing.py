"""Wall-clock timing helpers.

The reference accumulates spans into a ``measured_time`` dict with keys
``inference``, ``search``, ``search_within_buckets``, ``seq_search`` and
``sort``; :class:`Timer` keeps that taxonomy, measures with
``perf_counter`` and, when given tensors, waits for their devices before
reading the clock, so that asynchronous CUDA launches do not hide device
time.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict

import torch


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


def block(tree):
    """Wait for the devices of every tensor in ``tree`` (a tensor, or
    lists, tuples and dicts of them), then return ``tree``."""
    for device in _cuda_devices(tree, set()):
        torch.cuda.synchronize(device)
    return tree


class Timer:
    """Accumulates named wall-clock spans (device-synchronized)."""

    def __init__(self) -> None:
        self.measured: Dict[str, float] = defaultdict(float)

    @contextmanager
    def span(self, name: str, block_on=None):
        """Time the enclosed block; the devices of ``block_on``'s tensors
        are waited for before the clock is read."""
        start = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                block(block_on)
            self.measured[name] += time.perf_counter() - start

    def add(self, name: str, seconds: float) -> None:
        self.measured[name] += seconds

    def as_dict(self) -> Dict[str, float]:
        return dict(self.measured)
