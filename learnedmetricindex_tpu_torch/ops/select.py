"""Top-k with the JAX package's tie order.

``lax.top_k`` and the JAX package's stable merges put the lower index
first among equal values.  ``torch.topk`` leaves the order of ties
unspecified, so every selection in the port goes through
:func:`smallest_k`: each f32 value is mapped to an order-preserving
int32, shifted into the high half of an int64 and joined with its column
index in the low half.  The keys are then distinct and one integer
``topk`` returns exactly the first ``k`` columns in (value, index)
order — the order a stable ascending sort gives — without sorting the
whole row.
"""

from __future__ import annotations

from typing import Tuple

import torch


def smallest_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, idx)`` of the ``k`` smallest entries of each row of a 2-D
    f32 tensor, ascending, ties toward the lower column index.  NaN is
    not supported.  ``k`` must not exceed the row length."""
    if values.dim() != 2 or values.dtype != torch.float32:
        raise ValueError("smallest_k takes a 2-D float32 tensor")
    n = values.shape[1]
    if k > n:
        raise ValueError(f"k={k} exceeds the row length {n}")
    # +0.0 turns -0.0 into +0.0, so the two zeros tie as floats do
    bits = (values + 0.0).view(torch.int32)
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    col = torch.arange(n, device=values.device, dtype=torch.int64)
    keys = (ordered.to(torch.int64) << 32) | col
    keys = torch.topk(keys, k, dim=1, largest=False, sorted=True).values
    idx = keys & 0xFFFFFFFF
    return torch.gather(values, 1, idx), idx


def largest_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(vals, idx)`` of the ``k`` largest entries of each row, descending,
    ties toward the lower column index (``lax.top_k``'s order)."""
    neg, idx = smallest_k(-values, k)
    return -neg, idx
