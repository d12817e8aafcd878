"""The port's own spans (``lmi.*``, ``utils/profiling.py::span`` in the
port) in a traced window: their host time a call.

A program without the span leaves no event of it, and the metric is
then left out of the line, not read as 0."""

from __future__ import annotations

from typing import Optional


def per_call_ms(rec, name: str) -> Optional[float]:
    """The summed host time of the spans named ``name`` in ``rec.trace``,
    in ms, over the window's calls; ``None`` without a trace, a call or
    such a span."""
    if rec.trace is None or not rec.calls:
        return None
    spans = [end - start for start, end, n in rec.trace._cpu if n == name]
    return 1e-6 * sum(spans) / len(rec.calls) if spans else None
