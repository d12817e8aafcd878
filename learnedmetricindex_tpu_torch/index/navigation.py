"""Query navigation: from per-node probabilities to a bucket visit order
(counterpart of ``learnedmetricindex_tpu/index/navigation.py``).

Single-level trees rank the root model's classes; multi-level trees
rank leaves by their joint path probability ``∏ P(child | node)``
(``policy="joint"``).  The reference-parity best-first traversal
(``_best_first_device`` in the JAX package) is not ported yet.

Ties go to the lower leaf index, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import torch

from learnedmetricindex_tpu_torch.ops.select import largest_k

INVALID = -1.0  # entry probability marker; valid probabilities are >= 0


class TreeLayout(NamedTuple):
    """Entry numbering of an index tree: level ℓ holds
    ``prod(n_categories[:ℓ])`` entries numbered from ``offsets[ℓ-1]``; a
    leaf's local index is its global bucket id (row-major path).  The
    child links the best-first traversal needs come with its port."""

    n_categories: Tuple[int, ...]
    offsets: Tuple[int, ...]  # per level, len = n_levels + 1 (end sentinel)

    @property
    def n_leaves(self) -> int:
        return int(self.offsets[-1] - self.offsets[-2])

    @classmethod
    def create(cls, n_categories: Sequence[int]) -> "TreeLayout":
        n_categories = tuple(int(c) for c in n_categories)
        offsets = [0]
        acc = 1
        for c in n_categories:
            acc *= c
            offsets.append(offsets[-1] + acc)
        return cls(n_categories, tuple(offsets))


def _quantize_visits(n_buckets: int, n_leaves: int) -> int:
    """Emit capacity rounded up to a power of two (capped at
    ``n_leaves``).  Kept so the order has the same width as the JAX
    package's before the caller slices it to ``n_buckets``."""
    cap = 1 << max(int(n_buckets) - 1, 0).bit_length()
    return min(n_leaves, max(cap, 1))


def _joint_topk(leaf_probs: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """(Q, n_leaves) scores → (Q, n_buckets) int32 leaf ids by
    descending score, lower index first on ties, -1 where invalid."""
    probs, ids = largest_k(leaf_probs, n_buckets)
    return torch.where(probs > INVALID + 0.5, ids, -1).to(torch.int32)


def joint_order_device(
    level_probs: List[torch.Tensor], level_valid: List[torch.Tensor], cap: int
) -> torch.Tensor:
    """Rank leaves by joint path probability.  ``level_probs[ℓ]``:
    (Q, n_nodes_ℓ, C_ℓ); ``level_valid[ℓ]``: (n_nodes_ℓ, C_ℓ) bool."""
    Q = level_probs[0].shape[0]
    acc = None
    for probs, valid in zip(level_probs, level_valid):
        p = torch.where(valid[None, :, :], probs, 0.0)
        acc = p.reshape(Q, -1) if acc is None else (acc[:, :, None] * p).reshape(Q, -1)
    # leaves with zero accumulated probability are unreachable
    acc = torch.where(acc > 0.0, acc, INVALID)
    return _joint_topk(acc, cap)


def single_level_order_device(
    root_probs: torch.Tensor, valid: torch.Tensor, cap: int
) -> torch.Tensor:
    """1-level navigation: the root model's top ``cap`` classes."""
    probs = torch.where(valid[None, :], root_probs, INVALID)
    return _joint_topk(probs, cap)
