#!/usr/bin/env python3
"""The port's one-device build against another checkout's, on one NVIDIA GPU.

    python3 tools/torch_build_ab.py OTHER_CHECKOUT [--rows 10000000] [--turns 4]

Times ``LearnedIndexBuilder.build()`` of this tree and of
``OTHER_CHECKOUT`` (for example a ``git archive`` of the parent commit)
on the flagship corpus of ``chip_smoke.py::phase_build_path``
(``make_corpus``: 10M×768 int8 with f32 row scales, seed 2023) at both
of its configurations, ``[120]`` and ``[10, 10]``.  Each turn is a
process of its own that imports one checkout's package and draws the
corpus anew; the turns alternate other, this, this, other (``--turns``
of them).  Prints one JSON line a turn (``build_t``, ``cluster_t``,
coverage rounds and a digest of ``data_prediction`` for each
configuration) and a summary line, and writes all of them to
``chiprun_out/build_ab.json``; the summary says whether every turn
built the same index.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONFIGS = ([120], [10, 10])


def one_turn(checkout: Path, rows: int) -> dict:
    """Both builds with ``checkout``'s package, in this process."""
    sys.path.insert(0, str(checkout))
    import numpy as np
    import torch

    import chip_smoke as cs
    import learnedmetricindex_tpu_torch as lmi

    cs.check(Path(lmi.__file__).resolve().is_relative_to(checkout.resolve()),
             f"{lmi.__file__} is not {checkout}'s package")
    dev = torch.device("cuda", 0)
    data = cs.make_corpus(dev, rows, 10_000, 120)
    out = {"checkout": str(checkout)}
    for cats in CONFIGS:
        cfg = lmi.BuildConfiguration(
            ["kmeans"], [4], ["MLP-4"], [0.01], cats, seed=2023, batch_size=1024,
            chunk_size=2048, dtype="bfloat16", class_weights="balanced", update_rule="minibatch",
        )
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        builder = lmi.LearnedIndexBuilder((data["corpus"], data["row_scales"]), cfg, device=dev)
        _, pred, n_buckets, build_t, cluster_t = builder.build()
        torch.cuda.synchronize()
        out["x".join(map(str, cats))] = {
            "build_t": build_t, "cluster_t": cluster_t, "wall_s": time.perf_counter() - t0,
            "rounds": builder.rounds, "n_buckets": int(n_buckets),
            "pred_sha1": hashlib.sha1(np.ascontiguousarray(pred).tobytes()).hexdigest()}
        del builder, pred
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=lambda a: Path(a).resolve(), help="the checkout to compare with")
    p.add_argument("--rows", type=int, default=10_000_000)
    p.add_argument("--turns", type=int, default=4)
    p.add_argument("--one", type=Path, help=argparse.SUPPRESS)  # a turn's own process
    args = p.parse_args()
    if args.one is not None:
        print(json.dumps(one_turn(args.one, args.rows)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    turns = [(args.other, ROOT)[(t + 1) // 2 % 2] for t in range(args.turns)]  # o, t, t, o, ...
    results = []
    for checkout in turns:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), str(args.other),
                               "--rows", str(args.rows), "--one", str(checkout)],
                              capture_output=True, text=True, cwd=checkout)
        if proc.returncode:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            return proc.returncode
        results.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    summary = {"card": smi, "rows": args.rows}
    for name in ("x".join(map(str, c)) for c in CONFIGS):
        for who, root in (("other", args.other), ("this", ROOT)):
            mine = [r[name] for r in results if r["checkout"] == str(root)]
            summary[f"{name} {who} build_t"] = [m["build_t"] for m in mine]
            summary[f"{name} {who} cluster_t"] = [m["cluster_t"] for m in mine]
        digests = {r[name]["pred_sha1"] for r in results}
        summary[f"{name} same index"] = len(digests) == 1
    print(json.dumps(summary))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "build_ab.json").write_text(json.dumps({"turns": results, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
