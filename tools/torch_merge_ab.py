#!/usr/bin/env python3
"""The split scan's merge kernel against another checkout's, on one NVIDIA GPU.

    python3 tools/torch_merge_ab.py OTHER_CHECKOUT [--sides other this] [--rounds 6]
                                    [--groups 8 16 64 128] [--shapes a B C D E]

Builds ``learnedmetricindex_tpu_torch/csrc/scan_merge.cu`` of this tree and
of ``OTHER_CHECKOUT`` (for example a ``git archive`` of the parent commit)
and this tree's scan kernel with the port's nvcc flags, makes the flagship
(``chip_smoke.make_corpus``: 10M×768 int8, 10k queries;
``chip_smoke.flagship_index``: the hand-set index over 120 buckets and its
packed store) and the item lists that the split path's scan leaves at the
shapes of ``chip_smoke.MERGE_SHAPES``: (a) the first 1,024 queries, bf16,
``k_scan`` 16, the wrapper's segments (the stand-in for the serving
dispatch's plan, which needs the built and mutated index of
``chip_smoke.py``'s dynamic path); (B) the flagship's rows as an f32 store
(``chip_smoke.dequantized_store``, 31 GB), f32, ``k_scan`` 106; (C) the
10k queries, bf16, ``k_scan`` 16, segments of 20 chunks; (D) the same with
the wrapper's segments; (E) the first 1,024 queries, bf16, ``k_scan`` 106
(a 1,024-query ``search(k=100)``).  Both merge kernels take the same
lists.  At each shape, in turns (other, this, this, other,
...), each side's device time of 50 launches queued behind a spin, and of
50 launches back to back, by CUDA events (``chip_smoke.queued_ms``,
``cuda_ms``), the outputs allocated once outside; both sides' lists
bit-equal to the plain version; the plain version, ``smallest_k`` over the
lists side by side (laid out outside the timing) and the bound by bytes
beside them.  Where no pair splits (D), this tree's wrapper launches no
merge at all (checked through ``scan_kernel.scan_pairs``); its kernel on
those lists is timed all the same.  ``--groups``: this tree's kernel also
with each number of query slots a block (the plan's items staged, where
they fit), in the same turns, bits held; at lists wider than
``scan_kernel.MERGE_WARP_MAX_K`` also with every split pair streamed from
device memory (a plan that stages nothing: ``MergePlan(8, 0, 0)``).
``--sides other``: the other checkout alone.  Prints ``[merge-ab]``
lines with the card's name and power limit and writes
``chiprun_out/merge_ab.json``.
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
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import torch_scan_ab as ab  # noqa: E402
from learnedmetricindex_tpu_torch.index.bucket_store import scan_inputs  # noqa: E402
from learnedmetricindex_tpu_torch.ops import cuda_build, scan_kernel  # noqa: E402
from learnedmetricindex_tpu_torch.ops.select import smallest_k  # noqa: E402

OUT = ROOT / "chiprun_out"
REPS = 50
STREAMED = "this, every split pair streamed"
#: shape → (store, queries, k, mode, forced segment)
SHAPES = {"a": ("int8", 1024, 16, "bf16", None), "B": ("f32", None, 106, "f32", None),
          "C": ("int8", None, 16, "bf16", 20), "D": ("int8", None, 16, "bf16", None),
          "E": ("int8", 1024, 106, "bf16", None)}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="the checkout whose merge kernel is the other side")
    p.add_argument("--sides", nargs="+", default=["other", "this"], choices=["other", "this"])
    p.add_argument("--rounds", type=int, default=6, help="timed rounds a side and shape")
    p.add_argument("--groups", nargs="*", type=int, default=[8, 16, 64, 128],
                   help="query slots a block of this tree's kernel, timed beside its plan")
    p.add_argument("--shapes", nargs="+", default=list(SHAPES), choices=list(SHAPES))
    args = p.parse_args()
    smi = cs.phase_device()
    sources = {"other": args.other.resolve() / ab.MERGE_SOURCE, "this": ROOT / ab.MERGE_SOURCE}
    sides = list(args.sides)
    t0 = time.perf_counter()
    built = cuda_build.build_many([scan_kernel.SOURCE] + [sources[s] for s in sides])
    libs = {side: ab.bind_merge(path, sources[side])
            for side, (path, _) in zip(sides, built[1:])}
    cs.log(f"[merge-ab] the scan and {len(libs)} merge libraries built in "
           f"{time.perf_counter() - t0:.1f} s; " + ", ".join(
               f"{side}: {'takes a plan' if planned else 'the interface before the plan'}"
               for side, (_, planned) in libs.items()))
    dev = torch.device("cuda", 0)
    data = cs.make_corpus(dev, 10_000_000, 10_000, 120)
    index, _, store, _ = cs.flagship_index(dev, data, smi)
    queries = data["queries"]
    order, _ = index.compute_bucket_order(queries, 4, keep_on_device=True)
    del data
    out = {"device": smi, "shapes": {}}
    stores = {"int8": store}
    for shape in args.shapes:
        st_name, nq, k, mode, segment = SHAPES[shape]
        if st_name not in stores:
            stores[st_name] = cs.dequantized_store(store)
        st = stores[st_name]
        q, o = (queries, order) if nq is None else (queries[:nq], order[:nq])
        out["shapes"][shape] = one_shape(shape, st, q, o, k, mode, segment, libs, args, smi)
        torch.cuda.empty_cache()
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "merge_ab.json").write_text(json.dumps(out, indent=1))


def one_shape(shape, store, queries, order, k, mode, segment, libs, args, smi) -> dict:
    """Both sides (and this side's other plans) at one shape, in turns."""
    what = cs.MERGE_SHAPES[shape]
    _, sargs = scan_inputs(store, queries, order, 128, mode)
    split = cs.split_plan(sargs, k, mode, segment)
    wrapper_merges = None
    if "this" in libs and segment is None:  # what the wrapper launches at this shape
        before = scan_kernel.MERGE_LAUNCHES, scan_kernel.SPLIT_LAUNCHES
        scan_kernel.scan_pairs(*sargs, k=k, qtile=128, chunk=store.chunk, mode=mode)
        torch.cuda.synchronize()
        wrapper_merges = (scan_kernel.MERGE_LAUNCHES - before[0],
                          scan_kernel.SPLIT_LAUNCHES - before[1])
        cs.check(wrapper_merges[0] == wrapper_merges[1]
                 == int(split["items"] > split["pairs"]),
                 f"{what}: the wrapper made {wrapper_merges} merges and splits")
    item_d, item_s, pair_items = cs.merge_items(store, sargs, split, k, mode)
    rd, rs = scan_kernel.merge_split_lists_reference(item_d, item_s, pair_items)
    out_d, out_s = torch.empty_like(rd), torch.empty_like(rs)
    runs = {}
    for side, (lib, planned) in libs.items():
        runs[side] = (lambda lib=lib, planned=planned: ab.merge_call(
            lib, planned, item_d, item_s, pair_items, out_d, out_s, split["max_items"]))
    if "this" in libs:
        cap = scan_kernel.merge_plan(k, 128, split["max_items"]).cap
        plans = {f"this, {group} slots a block":
                 scan_kernel.MergePlan(group, cap, scan_kernel.merge_smem_bytes(group, cap, k))
                 for group in args.groups if group <= 128}
        if k > scan_kernel.MERGE_WARP_MAX_K:
            plans[STREAMED] = scan_kernel.MergePlan(scan_kernel.MERGE_WARPS, 0, 0)
        for name, plan in plans.items():
            if plan.smem <= scan_kernel.MERGE_SMEM_MAX:
                runs[name] = (lambda plan=plan: ab.merge_call(
                    libs["this"][0], True, item_d, item_s, pair_items, out_d, out_s, plan=plan))
    for name, run in runs.items():
        out_d.fill_(float("nan"))
        out_s.fill_(-7)
        cs.check(run() == 0, f"{what}: {name}: the merge launch failed")
        torch.cuda.synchronize()
        cs.check(torch.equal(out_d.view(torch.int32), rd.view(torch.int32))
                 and torch.equal(out_s, rs), f"{what}: {name}: lists differ from the plain version")
    queued = {name: [] for name in runs}
    back = {name: [] for name in runs}
    names = list(runs)
    for r in range(args.rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            queued[name].append(cs.queued_ms(runs[name], REPS))
            back[name].append(cs.cuda_ms(runs[name], REPS))
    med = {name: float(np.median(t)) for name, t in queued.items()}
    p_ms = cs.cuda_ms(lambda: scan_kernel.merge_split_lists_reference(item_d, item_s,
                                                                        pair_items), 3)
    flat_d, _ = scan_kernel.lists_side_by_side(item_d, item_s, pair_items)
    lib_ms = cs.cuda_ms(lambda: smallest_k(flat_d, k), 5)
    nbytes = cs.merge_bytes(item_d, pair_items)
    bound_ms = nbytes / cs.HBM_BYTES_PER_S * 1e3
    ratio = (f"; this/other {med['this'] / med['other']:.4f}"
             if {"this", "other"} <= set(med) else "")
    wrapper = ("" if wrapper_merges is None else
               f"; this tree's wrapper at this shape: {wrapper_merges[0]} merge launch(es)")
    cs.log(f"[merge-ab] {what}: {cs.split_text(split)}; bound {bound_ms:.4f} ms by bytes "
           f"({nbytes / 1e6:.2f} MB); plain {p_ms:.3f} ms, smallest_k over the lists side by "
           f"side {lib_ms:.3f} ms; this tree's {cs.merge_plan_text(k, split['max_items'])}"
           f"{wrapper}  [{smi}]")
    for name in runs:
        cs.log(f"[merge-ab]   {name}: queued {' '.join(f'{t:.4f}' for t in queued[name])} ms, "
               f"median {med[name]:.4f} ({bound_ms / med[name]:.1%} of the bound); back to "
               f"back median {float(np.median(back[name])):.4f} ms; bit-equal to the plain "
               f"version")
    cs.log(f"[merge-ab] {what}: medians {json.dumps({n: round(v, 5) for n, v in med.items()})}"
           f"{ratio}  [{smi}]")
    return {"pairs": split["pairs"], "items": split["items"], "max_items": split["max_items"],
            "bytes": nbytes, "bound_ms": bound_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "queued_ms": queued, "back_to_back_ms": back, "median_ms": med,
            "wrapper_merges": wrapper_merges}


if __name__ == "__main__":
    main()
