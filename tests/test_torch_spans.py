"""The port's spans and counters: ``lmi.*`` spans of a search, the
serving dispatcher and mutations in a ``device_trace``, the gated no-op
with no profiler, ``SearchServer.stats()["busy_s"]``, and
``idle_by_span`` on a hand-made trace."""

import json
import threading

import numpy as np
import pytest
import torch

import learnedmetricindex_tpu_torch as lmi
from learnedmetricindex_tpu_torch.data import synthetic_blobs
from learnedmetricindex_tpu_torch.serve import SearchServer
from learnedmetricindex_tpu_torch.utils import profiling

torch.set_num_threads(2)

#: a search's spans, in the order they open
SEARCH_SPANS = ["lmi.upload", "lmi.navigate", "lmi.plan", "lmi.scan", "lmi.merge",
                "lmi.rerank", "lmi.resolve", "lmi.copy_back"]


@pytest.fixture(scope="module")
def built():
    data, queries = synthetic_blobs(1500, 16, 40, n_clusters=8, seed=3)
    cfg = lmi.BuildConfiguration("kmeans", 3, "MLP", 0.01, [6], seed=3, chunk_size=64)
    index, pred, *_ = lmi.LearnedIndexBuilder(data, cfg, device="cpu").build()
    return index, pred, data, queries


def _spans(trace_path, prefix="lmi."):
    """``(start, end, name, tid)`` of the host spans whose name starts with
    ``prefix``, by start."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"], e["tid"]) for e in events
                  if e.get("cat") == profiling.SPAN_CATEGORY
                  and e.get("name", "").startswith(prefix))


def test_search_spans_nest_in_order(built, tmp_path):
    index, pred, data, queries = built
    store = index.get_bucket_store(data, pred)
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        with profiling.span("outer.search"):
            index.search(None, queries, None, queries, pred, n_buckets=3, k=5, store=store)
    outer = _spans(prof.trace_path, "outer.")
    spans = _spans(prof.trace_path)
    assert [n for _, _, n, _ in spans] == SEARCH_SPANS  # the CPU scan has no split or launch
    (o0, o1, _, tid), = outer
    for (s0, e0, *_), (s1, *_) in zip(spans, spans[1:]):
        assert s0 <= e0 <= s1  # one after another, none overlapping
    assert all(o0 <= s <= e <= o1 and t == tid for s, e, _, t in spans)


def test_span_without_a_profiler_is_the_shared_no_op(tmp_path):
    assert profiling.span("lmi.nothing") is profiling.NO_SPAN
    with profiling.span("lmi.nothing"):
        pass
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        inside = profiling.span("lmi.something")
        with inside:
            pass
    assert inside is not profiling.NO_SPAN
    assert [n for _, _, n, _ in _spans(prof.trace_path)] == ["lmi.something"]
    assert profiling.span("lmi.nothing") is profiling.NO_SPAN


def test_server_trace_holds_the_dispatcher_thread(built, tmp_path):
    if profiling._all_threads_config() is None:
        pytest.skip("this torch's profiler records only the thread that starts it")
    index, pred, data, queries = built
    server = SearchServer(index, index.get_bucket_store(data, pred), k=5, n_buckets=3,
                          max_batch=64, max_wait_ms=1.0)
    try:  # the dispatcher thread started before the profiler
        with profiling.device_trace(str(tmp_path), device="cpu") as prof:
            server.search(queries[:8], timeout=60)
    finally:
        server.close()
    spans = _spans(prof.trace_path)
    main = threading.get_native_id()
    dispatch = [(s, e, t) for s, e, n, t in spans if n == "lmi.serve.dispatch"]
    assert dispatch and all(t != main for _, _, t in dispatch)
    s0, e0, tid = dispatch[0]
    inner = {n for s, e, n, t in spans if t == tid and s0 <= s <= e <= e0}
    assert set(SEARCH_SPANS) <= inner
    assert {"lmi.serve.lock_wait", "lmi.serve.batch_window"} <= {n for *_, n, _ in spans}


def test_busy_s_grows_with_searches_and_mutations(built):
    index, pred, data, queries = built
    dyn = lmi.DynamicIndex.from_built(index, data, pred, chunk=64, dtype="float32")
    server = SearchServer(dyn, k=5, n_buckets=3, max_batch=64, max_wait_ms=1.0)
    try:
        b0 = server.stats()["busy_s"]
        assert set(b0) == {"queue_wait", "lock_wait", "dispatch", "mutation"}
        assert b0["dispatch"] > 0 and b0["mutation"] == 0  # the warm-up dispatch
        for i in range(3):
            server.search(queries[i : i + 4], timeout=60)
        b1 = server.stats()["busy_s"]
        assert b1["dispatch"] > b0["dispatch"] and b1["queue_wait"] > b0["queue_wait"]
        assert b1["lock_wait"] >= b0["lock_wait"] and b1["mutation"] == 0
        ids = server.insert(queries[:6] + 0.01)
        b2 = server.stats()["busy_s"]
        assert b2["mutation"] > 0 and b2["dispatch"] == b1["dispatch"]
        assert server.delete(ids[:3]) == 3
        st = server.stats()
        b3 = st["busy_s"]
        assert b3["mutation"] > b2["mutation"]
        assert b3["dispatch"] + b3["mutation"] <= st["uptime_s"]
    finally:
        server.close()


def test_mutation_spans(built, tmp_path):
    index, pred, data, queries = built
    dyn = lmi.DynamicIndex.from_built(index, data, pred, chunk=64, dtype="float32")
    with profiling.device_trace(str(tmp_path), device="cpu") as prof:
        ids = dyn.insert(queries[:5])
        dyn.delete(ids[:2])
    assert [n for _, _, n, _ in _spans(prof.trace_path)] == [
        "lmi.mutation.classify", "lmi.mutation.insert_rows", "lmi.mutation.delete_ids"]


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


# device busy over [10, 30] and [50, 60] µs; lmi.b nested in lmi.a; aten::x is
# no lmi span; the device side of a span (gpu_user_annotation) is no device work
HAND_MADE = [
    _x("lmi.a", "user_annotation", 0, 40), _x("lmi.b", "user_annotation", 20, 15),
    _x("aten::x", "cpu_op", 40, 30), _x("lmi.c", "user_annotation", 70, 30),
    _x("lmibench.search", "user_annotation", 5, 75),
    _x("lmi.a", "gpu_user_annotation", 0, 40, tid=7),
    _x("scan_kernel", "kernel", 10, 20, tid=7), _x("Memcpy HtoD", "gpu_memcpy", 50, 5, tid=7),
    _x("Memset", "gpu_memset", 55, 5, tid=7), _x("lmi.empty", "user_annotation", 45, 0),
]


@pytest.mark.parametrize("within, want", [
    (None, {"lmi.a": 15e-6, "lmi.b": 5e-6, profiling.OUTSIDE: 20e-6, "lmi.c": 30e-6}),
    ("lmibench.search", {"lmi.a": 10e-6, "lmi.b": 5e-6, profiling.OUTSIDE: 20e-6,
                         "lmi.c": 10e-6}),
])
def test_idle_by_span_on_a_hand_made_trace(tmp_path, within, want):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": HAND_MADE}))
    got = profiling.idle_by_span(str(path), within=within)
    assert set(got) == set(want)
    for name in want:
        assert got[name] == pytest.approx(want[name], abs=1e-12), name
