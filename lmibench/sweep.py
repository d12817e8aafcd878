"""The serving sweep: latency of an open-loop traffic mix at a few offered rates.

    python3 -m lmibench.sweep --config laion10m-int8 --traffic serve --seed 5 --seconds 10 \
        --rates 600 900 1200 1500

One set-up, then for each rate (requests a second) the cell's open loop
with its mutator for ``--seconds``, and one JSON line: p50, p95 and p99
of the requests (from when each was due), how late the generator ran,
and whether a backlog grew (the median latency of the last fifth of the
requests against the first fifth).  The knee is the highest rate whose
p95 meets the limit with no growing backlog; a cell runs at about four
fifths of it.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np

from lmibench import harness, spec


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nearest_rank(xs, p: float) -> float:
    xs = sorted(xs)
    return xs[max(math.ceil(p * len(xs)) - 1, 0)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    config, traffic = spec.config(args.config), spec.traffic(args.traffic)
    c = harness.Cell(config, traffic, args.seed, "cuda:0", log)
    for i, rate in enumerate(args.rates):
        c.traffic = {**traffic, "rate_per_s": rate}
        harness.start_server(c, {})
        harness.open_loop(c, c.traffic.get("warmup_s", 1.0), stream=100 + i, spans=False,
                          keep=False)
        w = harness.open_loop(c, args.seconds, stream=200 + i, spans=False, keep=False)
        lat = np.asarray(w.latencies_s) * 1e3
        fifth = max(len(lat) // 5, 1)
        st = c.server.stats()
        print(json.dumps({
            "rate_per_s": rate, "requests": len(lat), "unanswered": w.unanswered,
            "p50_ms": nearest_rank(lat, 0.5), "p95_ms": nearest_rank(lat, 0.95),
            "p99_ms": nearest_rank(lat, 0.99),
            "first_fifth_p50_ms": float(np.median(lat[:fifth])),
            "last_fifth_p50_ms": float(np.median(lat[-fifth:])),
            "lateness_max_ms": 1e3 * max(w.lateness_s),
            "queries_a_dispatch": st["queries"] / max(st["batches"], 1),
            "insert_ms_p50": 1e3 * float(np.median(w.insert_s)) if w.insert_s else None,
        }), flush=True)
    c.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
