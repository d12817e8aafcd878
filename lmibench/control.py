"""Readings that the limits of ``lmibench/limits/<workload>.json`` are set from.

    python3 -m lmibench.control --config laion10m-int8 --traffic batch --seconds 3 \
        --seeds 11 12 13 --control-seeds 11 12

For every seed: the cell's set-up, a short window of the program as the
benchmark runs it, and for the control seeds a second window of the
control, the program with its lower-precision path on: ``rerank=False``,
so its distances and order come from the scan's bf16 products instead of
the exact float32 rerank.  Both are compared with the reference exactly
as a run's answers are, and one JSON line a seed gives both sets of
numbers.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from lmibench import check, harness, spec
from lmibench.reference.exact import Reference

CONTROL = {"rerank": False}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def readings(config: dict, traffic: dict, seed: int, seconds: float, with_control: bool,
             device="cuda:0", log=log) -> dict:
    """``{"program": numbers, "control": numbers or None}`` of one seed."""
    c = harness.Cell(config, traffic, seed, device, log)
    serving = traffic["kind"] == "open_loop"
    wins = {}
    for side, over in [("program", {})] + ([("control", CONTROL)] if with_control else []):
        if serving:
            harness.start_server(c, over)
            harness.open_loop(c, traffic.get("warmup_s", 1.0), stream=1, spans=False,
                              keep=False)
            wins[side] = (harness.open_loop(c, seconds, stream=0, spans=False, keep=True), over)
        else:
            harness.closed_loop(c, 0.0, over, spans=False, warm=True)
            wins[side] = (harness.closed_loop(c, seconds, over, spans=False), over)
    muts, ins_rows, params, pool = c.muts, c.ins_rows, c.params, c.pool
    c.free()
    ref = Reference(params, config, device)
    ref.load_corpus(seed)
    for _, _, ids, first in muts.inserts:
        ref.add_inserted(torch.as_tensor(ins_rows[first : first + len(ids)]), ids)
    pool_t = torch.as_tensor(pool, device=ref.device)
    out = {"program": None, "control": None}
    for side, (w, over) in wins.items():
        kn = {**traffic, **over}
        out[side] = check.compare(ref, pool_t, kn["visits"], kn["k"], w.answers,
                                  muts if serving else None, w.probes, w.unanswered)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = p.parse_args(argv)
    config, traffic = spec.config(args.config), spec.traffic(args.traffic)
    for seed in args.seeds:
        r = readings(config, traffic, seed, args.seconds, seed in args.control_seeds)
        print(json.dumps({"config": args.config, "traffic": args.traffic, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
