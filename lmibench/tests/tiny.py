"""A cell at a size the CPU holds: the harness end to end on the port's
plain CPU path, for the tests."""

from __future__ import annotations

from lmibench import harness, spec

CONFIG = {"name": "tiny", "rows": 20_000, "dim": 64, "store": "int8", "n_buckets": 12,
          "model": "MLP-4", "hidden": 32, "chunk_size": 256, "clusters": 16, "noise": 0.45}
SERVE = {"rate_per_s": 40.0, "request_queries": 16, "max_batch": 256, "warmup_s": 0.3,
         "mutations": {"every_ms": 100.0, "insert_rows": 8, "delete_rows": 4}}


def traffic(kind: str) -> dict:
    t = {**spec.traffic(kind), "queries": 400}
    return {**t, **SERVE} if kind == "serve" else t


def config(store: str = "int8") -> dict:
    return {**CONFIG, "store": store}


#: each traffic mix's cell: the serving cell is not in BENCHMARK.json
#: (PERF.md, Open questions) and is run here under its own name
CELLS = {"laion10m-int8.batch": ("laion10m-int8", "batch"),
         "laion10m-f32.batch": ("laion10m-f32", "batch"),
         "laion10m-int8.serve": ("laion10m-int8", "serve")}


def run(workload: str, store: str = "int8", seconds: float = 1.0, trace: bool = False,
        seed: int = 2**31 + 7, limits=None, overrides=None):
    """``harness.run`` of ``workload``'s traffic over the tiny corpus on
    the CPU; returns ``(result line, numbers, limits)``."""
    bench = spec.load_benchmark()
    conf, mix = CELLS[workload]
    cell = {"name": workload, "config": conf, "traffic": mix, "chips": 1}
    return harness.run(bench, cell, seed, seconds, trace, "cpu", lambda m: None,
                       config=config(store), traffic=traffic(mix),
                       limits=limits if limits is not None else spec.limits(workload),
                       overrides=overrides)
