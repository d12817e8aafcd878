#!/usr/bin/env python3
"""Whole searches of the flagship index with this tree's scan kernel and
another checkout's, on one NVIDIA GPU.

    python3 tools/torch_search_ab.py OTHER_CHECKOUT [--cases default:100:f32 default:100
                                                      highest:100] [--rounds 4]

Builds the flagship once (``chip_smoke.make_corpus``: 10M×768 int8, 10k
queries; ``chip_smoke.flagship_index``: the hand-set MLP-4 index over 120
buckets and its packed store), then times ``LearnedIndex.search`` of the
10k queries at visit 4 for each ``precision:k`` case (``precision:k:f32``:
over the flagship's rows as an f32 store, ``chip_smoke.dequantized_store``,
31 GB: the store ``BuildConfiguration(dtype="float32")`` builds;
``precision:k:virtual``: over a virtual store of the int8 corpus,
``LearnedIndex.get_bucket_store`` of the corpus tensor), host clock around
the call (it ends in a device→host copy), with the scan kernel's library
built from this tree's ``learnedmetricindex_tpu_torch/csrc/scan_pairs.cu``
and from ``OTHER_CHECKOUT``'s (for example a ``git archive`` of the parent
commit), in alternating rounds (other, this, this, other, ...), the mean of
3 searches a round after a warm-up search a side.  Everything else in the
search (navigation, plan, split, merge kernel, rerank) is this tree's on
both sides; the other checkout's scan source must have this tree's C
interface (``lmi_scan_pairs`` with the body argument, ``lmi_scan_body``).
Both sides' results are held to each other: ids of each query's list
equal as sets on at least 0.999 of the queries, distances within 1e-5
(the rerank recomputes them in f32); at the default precision, where one
side's scan may run another body than the other's and sum its bf16
products in another order, at the bf16 bar of ``chip_smoke.py`` (0.99 of
the lists, 3e-3).  Prints one ``[search-ab]`` line a
case with the card's name and power limit and writes
``chiprun_out/search_ab.json``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from learnedmetricindex_tpu_torch.ops import cuda_build, scan_kernel  # noqa: E402

SOURCE = Path("learnedmetricindex_tpu_torch/csrc/scan_pairs.cu")
OUT = ROOT / "chiprun_out"


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout whose scan kernel is the other side")
    p.add_argument("--cases", nargs="+", default=["default:100:f32", "default:100", "highest:100"],
                   help="precision:k of each timed search (precision:k:f32 over the f32 store, "
                        "precision:k:virtual over a virtual store of the int8 corpus)")
    p.add_argument("--rounds", type=int, default=4, help="timed rounds a side and case")
    args = p.parse_args()
    smi = cs.phase_device()
    sources = {"other": args.other.resolve() / SOURCE, "this": ROOT / SOURCE}
    text = sources["other"].read_text()
    cs.check("lmi_scan_body" in text and "int* body" in text,
             f"{args.other}: its scan source lacks this tree's C interface")
    t0 = time.perf_counter()
    cuda_build.build_many(list(sources.values()))
    cs.log(f"[search-ab] both scan libraries built in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    data = cs.make_corpus(dev, 10_000_000, 10_000, 120)
    index, data_prediction, store, _ = cs.flagship_index(dev, data, smi)
    queries = data["queries"]
    nq = queries.shape[0]
    stores = {"int8": store}
    if any(case.endswith(":f32") for case in args.cases):
        stores["f32"] = cs.dequantized_store(store)
    if any(case.endswith(":virtual") for case in args.cases):
        stores["virtual"] = index.get_bucket_store((data["corpus"], data["row_scales"]),
                                                   data_prediction)
        cs.check(stores["virtual"].virtual, "get_bucket_store of the corpus tensor is virtual")

    def search(side, precision, k, st="int8"):
        scan_kernel.SOURCE = sources[side]  # the library _kernel_round loads
        return index.search(None, queries, None, queries, data_prediction, n_buckets=4, k=k,
                            store=stores[st], precision=precision)

    out = {"device": smi, "cases": {}}
    for case in args.cases:
        precision, k, *over = case.split(":")
        k, st = int(k), (over or ["int8"])[0]
        what = f"{precision}, n_buckets=4, k={k}, {st} store"
        res = {side: search(side, precision, k, st) for side in ("other", "this")}  # warm-up
        same = np.mean([set(a) == set(b) for a, b in zip(res["this"][1], res["other"][1])])
        err = float(np.abs(np.sort(res["this"][0], 1) - np.sort(res["other"][0], 1)).max())
        bar = (cs.BF16_SAME_IDS, cs.BF16_ATOL) if precision == "default" else (0.999, 1e-5)
        cs.check(same >= bar[0] and err <= bar[1],
                 f"{case}: the two sides' results differ ({same:.4f} of the lists equal, "
                 f"max|Δd| {err:.3g})")
        ran = {}  # one search's scan launches, and of those on a wgmma body
        for side in ("other", "this"):
            b = scan_kernel.LAUNCHES, scan_kernel.WGMMA_LAUNCHES
            search(side, precision, k, st)
            ran[side] = (scan_kernel.LAUNCHES - b[0], scan_kernel.WGMMA_LAUNCHES - b[1])
        secs = {side: [] for side in ("other", "this")}
        for r in range(args.rounds):
            for side in (("other", "this") if r % 2 == 0 else ("this", "other")):
                times = []
                for _ in range(3):
                    t0 = time.perf_counter()
                    search(side, precision, k, st)
                    times.append(time.perf_counter() - t0)
                secs[side].append(float(np.mean(times)))
        med = {side: float(np.median(t)) for side, t in secs.items()}
        cs.log(f"[search-ab] search precision={what}, {nq} queries "
               f"(mean of 3 a round, {args.rounds} rounds in turns): "
               + "; ".join(f"{side} {' '.join(f'{t:.4f}' for t in ts)} s, median {med[side]:.4f}"
                           for side, ts in secs.items())
               + f"; this/other {med['this'] / med['other']:.4f}; scan launches a search "
               f"(all, on a wgmma body): other {ran['other']}, this {ran['this']}; results: "
               f"{same:.4f} of the lists the same ids, max|Δd| {err:.3g}  [{smi}]")
        out["cases"][case] = {"rounds_s": secs, "median_s": med, "launches": ran,
                              "same_lists": float(same), "max_abs_diff": err}
    scan_kernel.SOURCE = sources["this"]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "search_ab.json").write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
