"""Run one cell of ``BENCHMARK.json`` once, on the card this process sees.

    python3 -m lmibench.run --workload laion10m-int8.batch --seed 7 --seconds 10 --trace 0

The last line of standard output is the result (one JSON object); the
last lines of standard error are the numbers the comparison read, each
beside its limit.  The run fails, and prints no result, without CUDA or
with fewer cards than the cell asks for, and if JAX or the JAX package
is loaded in this process once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from lmibench import harness, spec

#: top-level module names that must not be loaded (compared whole: the
#: port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "learnedmetricindex_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"[run] {args.workload} needs {cell['chips']} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    log(f"[run] {args.workload} seed {args.seed} seconds {args.seconds} trace {args.trace}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    result, numbers, limits = harness.run(bench, cell, args.seed, args.seconds,
                                          bool(args.trace), "cuda:0", log)
    # after the window, so that set-up does not pay for the subprocess
    log(f"[run] card: {power_limit()}")
    found = forbidden_modules()
    if found:
        log(f"[run] loaded in this process, and must not be: {', '.join(found)}")
        return 3
    for name in numbers:
        log(f"check {name} {numbers[name]!r} limit {limits[name]!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
