"""The readers of the port's spans (``upload_ms.batch``, ``plan_ms.batch``,
``split_ms.batch``) on a stub record with hand-made ``(start ns, end ns,
name)`` host events: the per-call mean, and nothing without a trace, a
call or the span (a program that opens none, as before the spans)."""

from types import SimpleNamespace

import pytest

from lmibench import spec

SPANS = {"upload_ms.batch": "lmi.upload", "plan_ms.batch": "lmi.plan",
         "split_ms.batch": "lmi.split"}


def _record(cpu, calls=3):
    trace = None if cpu is None else SimpleNamespace(_cpu=cpu)
    return SimpleNamespace(trace=trace, calls=[{}] * calls)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_per_call_mean(metric):
    name = SPANS[metric]
    cpu = [(0, 2_000_000, name), (10_000_000, 14_000_000, name), (20_000_000, 23_000_000, name),
           (0, 50_000_000, "lmibench.search"), (1_000_000, 9_000_000, "lmi.other")]
    # 2 + 4 + 3 ms over 3 calls
    assert spec.metric_module(metric).read(_record(cpu)) == pytest.approx(3.0)


@pytest.mark.parametrize("metric", sorted(SPANS))
def test_nothing_to_read(metric):
    read = spec.metric_module(metric).read
    name = SPANS[metric]
    assert read(_record(None)) is None  # an untraced run
    assert read(_record([(0, 1_000_000, name)], calls=0)) is None  # no call
    assert read(_record([(0, 1_000_000, "lmi.navigate")])) is None  # the parent: no such span
