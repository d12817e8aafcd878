#!/usr/bin/env python3
"""Where the scan kernel's wide-list time goes, on one NVIDIA GPU.

    python3 tools/torch_scan_split.py [--rounds 3]

The card's machine has no ``ncu``, so this splits the time by removing
work: it builds ``learnedmetricindex_tpu_torch/csrc/scan_pairs.cu`` and a
copy whose wide-list selection (``select_tile_merge``) only clears its
group marks, into ``build/scan_split/`` (both split and merged as the
wrapper does, with ``csrc/scan_merge.cu``), and times both in one process,
in alternating rounds, on the inputs of ``tools/torch_scan_ab.py``: the
packed flagship (10k queries) in modes bf16, int8 and f32 at ``k_scan``
16, 36 and 106, and f32 over the virtual store (256 queries) at 106,
1024 and 1106.  The copy's lists stay empty, so its results are wrong and
are not read, and past 1024 it runs one round where the tree runs two;
the difference at one round is what selection costs.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import torch_scan_ab as ab  # noqa: E402
from learnedmetricindex_tpu_torch.ops import cuda_build  # noqa: E402

WORK = ROOT / "build" / "scan_split"
STUB = """{
  for (int q = threadIdx.x; q < Smem<KMAX>::QB; q += THREADS) s.q_grp[q] = 0;
}"""


def without_selection(source: str) -> str:
    """``source`` with the body of ``select_tile_merge`` replaced by STUB."""
    start = source.index("{", source.index("__device__ void select_tile_merge("))
    depth = 0
    for end in range(start, len(source)):
        depth += {"{": 1, "}": -1}.get(source[end], 0)
        if depth == 0:
            return source[:start] + STUB + source[end + 1:]
    raise ValueError("select_tile_merge has no closing brace")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3, help="timed rounds per kernel and case")
    args = p.parse_args()
    smi = cs.phase_device()
    WORK.mkdir(parents=True, exist_ok=True)
    tree = ROOT / ab.SOURCE
    stub = WORK / "no_selection.cu"
    stub.write_text(without_selection(tree.read_text()))
    sources = {"tree": tree, "no selection": stub}
    builds = [(WORK / f"{i}.so", src) for i, src in enumerate(sources.values())]
    builds.append((WORK / "merge.so", ROOT / ab.MERGE_SOURCE))
    procs = [subprocess.Popen([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out),
                               str(src)], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
             for out, src in builds]
    for proc in procs:
        _, err = proc.communicate()
        cs.check(proc.returncode == 0, f"nvcc failed: {err.decode()[-2000:]}")
    sides = {name: ab.bind(WORK / f"{i}.so", src, WORK / "merge.so")
             for i, (name, src) in enumerate(sources.items())}
    store, virtual, queries, order = ab.flagship_stores(torch.device("cuda", 0))
    cases = [("packed", store, queries, order, mode, k) for k in (16, 36, 106)
             for mode in ("bf16", "int8", "f32")]
    cases += [("virtual", virtual, queries[:256], order[:256], "f32", k) for k in (106, 1024, 1106)]
    names = list(sides)
    for layout, st, q, o, mode, k in cases:
        runs = {n: ab.launcher(side, st, q, o, mode, k) for n, side in sides.items()}
        ms = {n: [] for n in runs}
        for r in range(args.rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                ms[n].append(cs.cuda_ms(runs[n], 3))
        cs.log(f"[split] {layout} {mode} k_scan {k} ({q.shape[0]} queries; mean of 3 launches a "
               f"round): " + "; ".join(f"{n} {' '.join(f'{t:.3f}' for t in v)} ms"
                                       for n, v in ms.items()) + f"  [{smi}]")
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
