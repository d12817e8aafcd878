"""What a cell is handed, made from ``--seed`` on the device.

The order of draws from the one generator is fixed: the mixture's
centres, the corpus in blocks of ``BLOCK`` rows, the query pool, then
the rows that serving inserts.  So the corpus of a configuration and
seed is the same whatever the traffic, and the reference can draw it
again after the program's state is freed.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import torch

from lmibench.frozen import blobs, handset

BLOCK = 500_000


def generator(config: dict, seed: int, device) -> blobs.BlobGenerator:
    return blobs.BlobGenerator(config["clusters"], config["dim"], seed, config["noise"],
                               device=device)


def corpus_blocks(gen: blobs.BlobGenerator, config: dict) -> Iterator[Tuple[int, torch.Tensor]]:
    """``(first row, (rows, d) f32 block)`` over the whole corpus."""
    n = config["rows"]
    for s0 in range(0, n, BLOCK):
        yield s0, gen.rows(min(BLOCK, n - s0))


def stored_form(x: torch.Tensor, store: str):
    """A block as the configuration's store holds it: ``(values, scales
    or None)``."""
    if store == "int8":
        return blobs.quantize_rows(x)
    return x, None


def as_float(values: torch.Tensor, scales) -> torch.Tensor:
    return values if scales is None else blobs.dequantize_rows(values, scales)


def centroid_positions(config: dict, seed: int) -> torch.Tensor:
    return handset.centroid_rows(config["rows"], config["n_buckets"], seed)
