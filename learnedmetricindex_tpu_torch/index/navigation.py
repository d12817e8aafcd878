"""Query navigation: from per-node probabilities to a bucket visit order
(counterpart of ``learnedmetricindex_tpu/index/navigation.py``).

Single-level trees rank the root model's classes.  Multi-level trees
either replay the reference's best-first traversal
(``policy="best_first"``, :func:`best_first_device`) or rank leaves by
their joint path probability ``∏ P(child | node)`` (``policy="joint"``).

Ties go to the lower index, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from learnedmetricindex_tpu_torch.ops.select import largest_k

INVALID = -1.0  # entry probability marker; valid probabilities are >= 0

#: Default ceiling on the best-first traversal state (bytes of per-query
#: entry state: (Q, E) f32 probabilities + (Q, E) uint8 status).
#: Override with ``LMI_MAX_NAV_STATE_BYTES``.
MAX_NAV_STATE_BYTES = 1 << 30


class TreeLayout(NamedTuple):
    """Entry numbering of an index tree: level ℓ (1-based) holds
    ``prod(n_categories[:ℓ])`` entries numbered from ``offsets[ℓ-1]``; a
    leaf's local index is its global bucket id (row-major path).  An
    internal entry's children are ``child_base .. child_base +
    child_count``."""

    n_categories: Tuple[int, ...]
    offsets: Tuple[int, ...]  # per level, len = n_levels + 1 (end sentinel)
    child_base: np.ndarray  # (E,) first child entry, 0 for leaves
    child_count: np.ndarray  # (E,) n children, 0 for leaves
    is_leaf: np.ndarray  # (E,) bool

    @property
    def n_entries(self) -> int:
        return int(self.offsets[-1])

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
        E = offsets[-1]
        child_base = np.zeros(E, dtype=np.int32)
        child_count = np.zeros(E, dtype=np.int32)
        is_leaf = np.zeros(E, dtype=bool)
        for lvl in range(len(n_categories)):
            lo, hi = offsets[lvl], offsets[lvl + 1]
            if lvl == len(n_categories) - 1:
                is_leaf[lo:hi] = True
            else:
                c_next = n_categories[lvl + 1]
                child_base[lo:hi] = offsets[lvl + 1] + np.arange(hi - lo) * c_next
                child_count[lo:hi] = c_next
        return cls(n_categories, tuple(offsets), child_base, child_count, is_leaf)


def flatten_entry_probs_device(
    level_probs: List[torch.Tensor], level_valid: List[torch.Tensor]
) -> torch.Tensor:
    """Concatenate per-level probabilities (Q, n_nodes_ℓ, C_ℓ) into (Q, E)
    entry scores, invalid entries at :data:`INVALID`."""
    Q = level_probs[0].shape[0]
    parts = [
        torch.where(valid[None, :, :], probs, INVALID).reshape(Q, -1)
        for probs, valid in zip(level_probs, level_valid)
    ]
    return torch.cat(parts, dim=1)


def best_first_device(
    entry_probs: torch.Tensor, layout: TreeLayout, *, n_buckets: int, frontier: int = 16
) -> torch.Tensor:
    """Frontier-``F`` best-first traversal → (Q, n_buckets) int32 global
    bucket ids, -1 where a query ran out of reachable buckets.

    Every tree entry is hidden, queued or popped.  Each iteration takes
    the top-``F`` queued entries per query and pops the longest prefix
    of leaves plus at most the first internal entry: a leaf pop unlocks
    nothing, so this is the one-pop-at-a-time order of the reference
    (children ranked by their conditional probability alone), with up to
    ``F`` leaves emitted per iteration.  One host read of the loop
    condition per iteration."""
    device = entry_probs.device
    Q, E = entry_probs.shape
    HIDDEN, QUEUED, POPPED = 0, 1, 2
    F = max(1, min(frontier, E))
    leaf_offset = layout.offsets[-2]
    child_base = torch.as_tensor(layout.child_base, device=device).long()
    child_count = torch.as_tensor(layout.child_count, device=device).long()
    is_leaf = torch.as_tensor(layout.is_leaf, device=device)

    col = torch.arange(E, device=device)[None, :]
    status = (col < layout.offsets[1]).to(torch.uint8).repeat(Q, 1)  # QUEUED = 1
    # one column past the end takes the writes of entries not emitted
    order = torch.full((Q, n_buckets + 1), -1, dtype=torch.int32, device=device)
    emitted = torch.zeros(Q, dtype=torch.int64, device=device)
    rows = torch.arange(Q, device=device)
    valid_entry = entry_probs > INVALID + 0.5
    while bool(
        ((emitted < n_buckets) & ((status == QUEUED) & valid_entry).any(1)).any()
    ):
        masked = torch.where(status == QUEUED, entry_probs, -torch.inf)
        vals, pops = largest_k(masked, F)  # ties → lower index, as lax.top_k
        valid_f = vals > INVALID + 0.5
        leaf_f = is_leaf[pops]
        # longest leaf prefix + the first internal entry
        lead = torch.ones((Q, 1), dtype=torch.int64, device=device)
        prev_all_leaf = torch.cumprod(
            torch.cat([lead, leaf_f[:, :-1].long()], dim=1), dim=1
        ).bool()
        take_pfx = prev_all_leaf & valid_f
        emit_pfx = take_pfx & leaf_f
        # leaves popped strictly before batch position j
        before = torch.cumsum(emit_pfx.long(), dim=1) - emit_pfx.long()
        # sequential gate: entry j is popped iff the query still needs
        # buckets at that point
        take = take_pfx & (emitted[:, None] + before < n_buckets)

        cur = torch.gather(status, 1, pops)
        status.scatter_(1, pops, torch.where(take, POPPED, cur).to(torch.uint8))

        is_emit = take & leaf_f
        slot = torch.where(is_emit, emitted[:, None] + before, n_buckets)
        order.scatter_(1, slot, (pops - leaf_offset).to(torch.int32))
        emitted = emitted + is_emit.sum(1)

        # unlock the children of the (single) popped internal entry
        internal = take & ~leaf_f
        any_int = internal.any(1)
        pop_i = pops[rows, torch.argmax(internal.to(torch.int8), dim=1)]
        base = child_base[pop_i][:, None]
        cnt = child_count[pop_i][:, None]
        unlock = (col >= base) & (col < base + cnt) & any_int[:, None] & (status == HIDDEN)
        status = torch.where(unlock, QUEUED, status).to(torch.uint8)
    return order[:, :n_buckets]


def nav_frontier() -> int:
    """Frontier width ``F`` of the best-first traversal; override with
    ``LMI_NAV_FRONTIER`` (1 = one pop per iteration)."""
    return max(1, int(os.environ.get("LMI_NAV_FRONTIER", 16)))


def _nav_budget() -> int:
    return int(os.environ.get("LMI_MAX_NAV_STATE_BYTES", MAX_NAV_STATE_BYTES))


def check_best_first_budget(n_queries: int, n_entries: int) -> None:
    """Raise when the best-first state (``n_queries · n_entries · 5``
    bytes) would exceed the budget (:data:`MAX_NAV_STATE_BYTES`, or
    ``LMI_MAX_NAV_STATE_BYTES``) instead of allocating it."""
    budget = _nav_budget()
    state_bytes = n_queries * n_entries * 5  # f32 probs + uint8 status
    if state_bytes > budget:
        raise ValueError(
            f"best-first navigation state would be {state_bytes/1e9:.2f} "
            f"GB ({n_queries} queries x {n_entries} tree entries) — over "
            f"the {budget/1e9:.2f} GB budget. Use policy='joint' (exact "
            "for joint-probability ranking, no traversal state), search "
            "in smaller query batches, or raise LMI_MAX_NAV_STATE_BYTES."
        )


def max_best_first_queries(n_entries: int) -> int:
    """Largest query slice (a power of two) whose best-first state fits
    the budget; raises when even one query's does not."""
    m = _nav_budget() // max(int(n_entries) * 5, 1)
    if m < 1:
        check_best_first_budget(1, n_entries)  # raises
    return 1 << (int(m).bit_length() - 1)


def best_first_order(layout: TreeLayout, entry_probs: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Reference-parity best-first visit order → (Q, n_buckets) int32
    global bucket ids (-1 where a query ran out of reachable buckets)."""
    check_best_first_budget(entry_probs.shape[0], layout.n_entries)
    n_buckets = min(n_buckets, layout.n_leaves)
    cap = _quantize_visits(n_buckets, layout.n_leaves)
    order = best_first_device(entry_probs, layout, n_buckets=cap, frontier=nav_frontier())
    return order[:, :n_buckets]


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
