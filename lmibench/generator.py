"""The one traffic generator: schedules from a traffic file and a seed.

A traffic file (``lmibench/traffic/<mix>.json``) gives parameters only;
this module turns them into the work of a run.  Two kinds:

* ``closed_loop``: one caller sends ``queries`` queries a call, the next
  call when the last has returned, until the window is over.
* ``open_loop``: requests arrive on a schedule, whatever the server
  does.  ``rate_per_s`` requests a second, each of ``request_queries``
  queries starting at a random offset of the query pool.  The gaps
  between arrivals are the quantiles of an exponential distribution (a
  Poisson process), the same set for every seed in another order, so a
  seed changes which queries are asked and when, not how many or how
  bursty.  ``mutations`` (``{"every_ms",
  "insert_rows", "delete_rows"}``) inserts rows on a fixed period and
  deletes some of each batch right after.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

#: a schedule entry: (due seconds from the window's start, pool offset, queries)
Arrival = Tuple[float, int, int]


def rng(seed: int, stream: int) -> np.random.Generator:
    """An independent stream of the seed for each use."""
    return np.random.default_rng([int(seed) & (2**64 - 1), stream])


def arrivals(traffic: dict, seed: int, seconds: float, stream: int = 0) -> List[Arrival]:
    """The open loop's requests due in ``[0, seconds)``."""
    r = rng(seed, 1 + stream)
    n = max(int(round(traffic["rate_per_s"] * seconds)), 1)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / traffic["rate_per_s"]
    gaps = r.permutation(gaps) * (seconds / gaps.sum())
    due = np.cumsum(gaps) - gaps[0]
    nq = int(traffic["request_queries"])
    off = r.integers(0, traffic["queries"] - nq + 1, len(due))
    return [(float(t), int(o), nq) for t, o in zip(due, off)]


def mutation_times(traffic: dict, seconds: float) -> np.ndarray:
    """Due times of the insert batches in ``[0, seconds)``."""
    m = traffic.get("mutations")
    if not m:
        return np.zeros(0)
    return np.arange(0.0, seconds, m["every_ms"] / 1e3)


def insert_rows_needed(traffic: dict, seconds: float) -> int:
    """Rows the mutations of a warm-up and a window of ``seconds`` insert."""
    m = traffic.get("mutations")
    if not m:
        return 0
    batches = len(mutation_times(traffic, traffic.get("warmup_s", 0.0)))
    batches += len(mutation_times(traffic, seconds))
    return batches * m["insert_rows"]
