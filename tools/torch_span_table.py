#!/usr/bin/env python3
"""One traced run of a benchmark cell with the port's ``lmi.*`` spans read
out, on one NVIDIA GPU.

    python3 tools/torch_span_table.py --workload laion10m-int8.batch --seed 7 --seconds 20

Runs ``lmibench.harness.run`` as ``python3 -m lmibench.run ... --trace 1``
does, keeps the window's profile and writes it as a Chrome trace under
``--out`` (default ``build/spans``).  Prints the result line; the
host time a call of each ``lmi.*`` span (mean over the window's calls);
``lmi.navigate`` beside ``nav_ms.batch`` and the sum of ``lmi.plan``
through ``lmi.copy_back`` beside ``seq_search_ms.batch``; and
``utils/profiling.py::idle_by_span`` of the trace inside the harness's
``lmibench.search`` spans (device-idle ms a call by innermost span, and
the share under some ``lmi.*`` span), and in the window outside them.
The last line is all of it as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

#: the spans ``measured["seq_search"]`` holds, in the order they open
SEQ_SEARCH = ("lmi.plan", "lmi.scan", "lmi.merge", "lmi.rerank", "lmi.resolve",
              "lmi.copy_back")


def traced_run(bench, cell, seed, seconds, device, path, log):
    """``harness.run`` of ``cell`` with the trace on; the window's profile
    is also written to ``path`` as a Chrome trace.  Returns the result
    line and the harness's :class:`lmibench.trace.Trace`."""
    from lmibench import harness, trace as tracing

    kept = {}
    reduce = tracing.Trace

    class Kept(reduce):  # the harness's reduction, and the profile kept whole
        def __init__(self, prof):
            super().__init__(prof)
            prof.export_chrome_trace(path)
            kept["trace"] = self

    tracing.Trace = Kept
    try:
        result, _, _ = harness.run(bench, cell, seed, seconds, True, device, log)
    finally:
        tracing.Trace = reduce
    return result, kept["trace"]


def span_table(result, trace, path) -> dict:
    """What the module docstring lists, from a traced run's result line,
    its harness trace and the same window's Chrome trace at ``path``."""
    from lmibench.trace import WINDOW
    from learnedmetricindex_tpu_torch.utils.profiling import OUTSIDE, idle_by_span

    events = trace._cpu
    n_calls = sum(n == "lmibench.search" for _, _, n in events)
    per_call = {}
    for s, e, n in events:
        if n.startswith("lmi."):
            per_call[n] = per_call.get(n, 0.0) + (e - s) / 1e6 / n_calls
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    idle_in = {k: 1e3 * v / n_calls
               for k, v in idle_by_span(path, within="lmibench.search").items()}
    total = sum(idle_in.values())
    with open(path) as f:  # the Chrome trace's clock (µs) for the window and the calls
        spans = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "user_annotation"]
    window = next(e for e in spans if e["name"] == WINDOW)
    last_call_end = max(e["ts"] + e["dur"] for e in spans if e["name"] == "lmibench.search")
    return {
        "calls": n_calls, "span_ms_per_call": per_call,
        "navigate_vs_nav_ms": [per_call.get("lmi.navigate"), metrics.get("nav_ms.batch")],
        "seq_search_spans_vs_seq_search_ms": [sum(per_call.get(n, 0.0) for n in SEQ_SEARCH),
                                              metrics.get("seq_search_ms.batch")],
        "idle_ms_per_call_in_search": idle_in,
        "idle_share_under_lmi": 1.0 - idle_in.get(OUTSIDE, 0.0) / total if total else None,
        # the window's idle seconds in and outside the harness's search calls, and
        # its tail: the last call's end to the window's (the answers' dedupe, the sync)
        "idle_s_in_window_by_harness_span": idle_by_span(path, prefix="lmibench.",
                                                          within=WINDOW),
        "window_tail_s": (window["ts"] + window["dur"] - last_call_end) / 1e6,
    }


def main(argv=None) -> int:
    import torch

    from lmibench import spec

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--out", default=str(ROOT / "build" / "spans"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, f"{args.workload}.seed{args.seed}.json")
    bench = spec.load_benchmark()
    result, trace = traced_run(bench, spec.cell(bench, args.workload), args.seed,
                               args.seconds, "cuda:0", path,
                               lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(result), flush=True)
    out = {"workload": args.workload, "seed": args.seed,
           "card": torch.cuda.get_device_name(0), **span_table(result, trace, path)}
    for name, ms in sorted(out["span_ms_per_call"].items(), key=lambda kv: -kv[1]):
        print(f"span {name:28s} {ms:9.4f} ms a call", file=sys.stderr)
    for name, ms in sorted(out["idle_ms_per_call_in_search"].items(), key=lambda kv: -kv[1]):
        print(f"idle {name:28s} {ms:9.4f} ms a call", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
