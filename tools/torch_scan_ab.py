#!/usr/bin/env python3
"""The port's scan against another checkout's, on one NVIDIA GPU.

    python3 tools/torch_scan_ab.py OTHER_CHECKOUT [--k 16 106 1024 1106] [--rounds 6]
                                   [--shares 1 0.5 0.25 0.125] [--sass-only]

Builds ``learnedmetricindex_tpu_torch/csrc/scan_pairs.cu`` (and, where
the checkout has it, ``csrc/scan_merge.cu``) of this tree and of
``OTHER_CHECKOUT`` (for example a ``git archive`` of the parent commit)
with the port's nvcc flags into ``build/scan_ab/``; compares the SASS of
every scan kernel instance the two have in common (addresses and
register names left as they are, branch targets masked), writes the
diff of each that differs to ``build/scan_ab/`` and names the instances
that only this tree's build has; then times both sides
in one process on the same inputs, alternating which goes first, and
checks that both give the same bits (distances and slots) at every
``k``, except where only one side takes a wgmma body (bf16 or f32 over an
int8 packed store at ``k_scan`` <= 32, bf16, int8 and f32 over it at 33 to
128, int8 over it at <= 32, bf16 over an f32 packed store at 33 to 128,
bf16 and f32 over a row map of an int8 corpus at <= 32, as
its library's ``lmi_scan_body`` says): wgmma sums in
another order than ``mma.sync``, so there both sides are held to each
other at the bar of the mode (``chip_smoke.compare_candidates``: in int8
bit-equal, the integer sums being exact; in f32 also each side's
distances against float64) and the lists that are bit-equal are counted.  Each side runs as its checkout's wrapper does: a checkout with
the merge kernel splits each launch's pairs into items of the segment
length ``ops/scan_kernel.py::segment_length`` picks from its library's
occupancy (``lmi_scan_body``, or ``lmi_scan_blocks_per_sm`` in a checkout
without the wgmma body), scans them and merges them; one
without it (the interface before the split) launches one block a pair.

* the flagship (``chip_smoke.make_corpus``: 10M×768 int8, 120
  nearest-centroid buckets, a packed store, 10k queries visiting 4, qtile
  128) in modes bf16, int8 and f32, at each ``k`` up to 128, each line
  naming the body each side's launch took;
* bf16 and f32 over a virtual store of the same corpus (the id grid,
  ``LearnedIndex.get_bucket_store`` of the corpus tensor) with all 10k
  queries at each ``k`` up to 32 (the default and ``highest`` searches'
  scans: the row-map bodies), where this side's lists are also held to
  its own packed store's, bit for bit (the packed store holds the
  corpus's bytes and scales); f32 over that virtual store with the first
  256 queries (``search(k=1100)``'s scan in ``chip_smoke.phase_virtual``),
  at every ``k``; past 1024 in rounds of at most 1024
  (``scan_kernel.scan_in_rounds``), one launch a round.

Then f32 over the flagship's rows as an f32 store
(``chip_smoke.dequantized_store``, 31 GB) at each ``k`` up to 128: the
same bits on both sides, unless a side still has the CUDA-core FMA body
(``scan_f32_kernel``), which takes f32 query rows and rounds otherwise,
or only one side takes the six-term wgmma body (``k_scan`` <= 32), which
sums in another order than ``mma.sync``; then held to the f32 parity bar
(``chip_smoke.compare_candidates``) and each side's distances to float64
(``chip_smoke.float64_error``).  Then
bf16 over f32 rows (the default search over an f32 store, the CLI's
scan): over that 31 GB store at each ``k`` up to 128 (``k_scan`` 106 is
its ``search(k=100)``), and at ``k_scan`` 16 over the flagship corpus's
first 1M rows in their buckets as an f32 store (3.1 GB, the CLI's shape:
``--synthetic 1000000``, 120 buckets, chunk 2048, 10k queries visiting
4); the same bits where both sides take the same body, else held to
each other at the bf16 bar (``bodies_agree``).

``--shares``: the segment-length probe.  This tree's scan at the
segment length each share of a slot's fair share gives, and over whole
buckets, in turns, at the flagship (10k queries; bf16 and int8 at
k_scan 16, bf16 at 106) and at one serving dispatch (its first 1,024
queries; bf16 and int8 at 16); bits equal at every share.

Both sources must take ``lmi_scan_pairs``'s arguments with or without the
row-map and floor pointers (without them, the earlier interface, only the
packed cases up to 1024 run) and with or without the store's row count
and the body (``n_rows``, ``body``: the wgmma body's interface).
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import re
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs  # noqa: E402
from learnedmetricindex_tpu_torch.ops import cuda_build, quantize, scan_kernel  # noqa: E402

SOURCE = Path("learnedmetricindex_tpu_torch/csrc/scan_pairs.cu")
MERGE_SOURCE = Path("learnedmetricindex_tpu_torch/csrc/scan_merge.cu")
WORK = ROOT / "build" / "scan_ab"
WHOLE = 10**9  # a segment longer than any bucket: one item a pair


def build(sources: dict) -> None:
    """``{name}.so`` and ``{name}.cubin`` of each scan source, and
    ``{name}_merge.so`` where the checkout has the merge kernel, all
    nvcc processes at once."""
    nvcc, flags = cuda_build._nvcc(), cuda_build.NVCC_FLAGS
    cubin_flags = flags[: flags.index("-shared")]
    procs = []
    for name, src in sources.items():
        jobs = [([*flags, "-o", str(WORK / f"{name}.so")], src),
                ([*cubin_flags, "-cubin", "-o", str(WORK / f"{name}.cubin")], src)]
        merge = src.parents[2] / MERGE_SOURCE
        if merge.exists():
            jobs.append(([*flags, "-o", str(WORK / f"{name}_merge.so")], merge))
        for cmd, path in jobs:
            procs.append(subprocess.Popen([nvcc, *cmd, str(path)], stdout=subprocess.DEVNULL,
                                          stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate()
        cs.check(p.returncode == 0, f"nvcc failed: {err.decode()[-2000:]}")


def sass(cubin: Path) -> dict:
    """Instruction lines per kernel, encodings and offsets dropped; a scan
    kernel instance under its name from ``scan_mma_kernel`` (or
    ``scan_wgmma_kernel``, ``scan_wgmma_f32_kernel``,
    ``scan_wgmma_f32mode_kernel``, ``scan_wgmma_wide_kernel``,
    ``scan_wgmma_f32x_kernel``, ``scan_wgmma_s8_kernel``,
    ``scan_wgmma_s8_wide_kernel``, ``scan_wgmma_f32mode_wide_kernel``,
    ``scan_wgmma_f32_wide_kernel``) on."""
    cuobjdump = Path(cuda_build._nvcc()).with_name("cuobjdump")
    txt = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True, text=True,
                         check=True).stdout
    funcs = {}
    for part in txt.split("Function : ")[1:]:
        name, body = part.split("\n", 1)
        lines = []
        for ln in body.splitlines():
            ln = re.sub(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/", "", ln).strip()
            if not ln or ln[0] in ".-":
                continue
            if re.search(r"\b(BRA|BSSY|CALL|JMP|BRX)\b", ln):
                ln = re.sub(r"\b0x[0-9a-f]{3,}\b", "ADDR", ln)
            lines.append(re.sub(r"\s+", " ", ln))
        # from the kernel's own name on: nvcc names an anonymous namespace
        # after the source file, so the two builds' prefixes differ
        name = name.strip()
        for kernel in ("scan_mma_kernel", "scan_wgmma_kernel", "scan_wgmma_f32_kernel",
                       "scan_wgmma_f32mode_kernel", "scan_wgmma_wide_kernel",
                       "scan_wgmma_f32x_kernel", "scan_wgmma_s8_kernel",
                       "scan_wgmma_s8_wide_kernel", "scan_wgmma_f32mode_wide_kernel",
                       "scan_wgmma_f32_wide_kernel"):
            if kernel in name:
                name = name[name.find(kernel):]
                break
        funcs[name] = lines
    return funcs


def cli_shape_store(store, n: int = 1_000_000):
    """The rows of the int8 ``store`` whose object ids are the corpus's
    first ``n``, dequantized into an f32 store in the same buckets (chunk
    as the store's): the CLI's shape from the flagship's corpus."""
    ids = store.chunk_ids.reshape(-1).long()
    per_chunk = np.repeat(np.arange(store.n_buckets), np.diff(store.bucket_chunk_start))
    slot_bucket = torch.as_tensor(per_chunk, device=ids.device).repeat_interleave(store.chunk)
    keep = (ids > 0) & (ids <= n)
    rows = quantize.dequantize_rows(store.chunk_data[keep], store.chunk_scales[keep])
    return BucketStore.build_packed_device(rows, slot_bucket[keep].cpu().numpy(), store.n_buckets,
                                           chunk=store.chunk)


def flagship_stores(dev):
    """The flagship's packed store, a virtual store over the same corpus,
    the queries and their nearest-centroid visits."""
    data = cs.make_corpus(dev, 10_000_000, 10_000, 120)
    corpus, scales, queries, cent = (data[k] for k in ("corpus", "row_scales", "queries",
                                                       "centroids"))
    half_sq = 0.5 * (cent * cent).sum(1)
    bucket = torch.empty(corpus.shape[0], dtype=torch.int64, device=dev)
    for s0 in range(0, corpus.shape[0], 500_000):
        x = corpus[s0 : s0 + 500_000].float() * scales[s0 : s0 + 500_000, None]
        bucket[s0 : s0 + 500_000] = (x @ cent.T - half_sq).argmax(1)
    store = BucketStore.build_packed_device(corpus, bucket.cpu().numpy(), 120, chunk=2048,
                                            row_scales=scales)
    virtual = BucketStore.build_virtual(corpus, bucket.cpu().numpy(), 120, chunk=2048,
                                        row_scales=scales)
    order = torch.topk(queries @ cent.T - half_sq, 4, dim=1).indices.int()
    return store, virtual, queries, order


class Side(NamedTuple):
    """One checkout's libraries and the interface its source declares."""

    lib: ctypes.CDLL
    mapped: bool  # takes the row-map and floor pointers
    fma_body: bool  # f32 over an f32 store takes f32 query rows (the FMA body)
    merge: Optional[ctypes.CDLL]  # the merge kernel: this side splits its pairs
    wgmma: bool  # has the wgmma body (and takes the store's row count and the body)
    merge_plan: bool  # its merge takes a plan (scan_kernel.merge_plan: group, cap, smem)


def bind_merge(library: Path, source: Path) -> tuple:
    """Load the merge ``library`` built from ``source`` with the argument
    types its interface declares: ``(library, takes a plan)``."""
    lib = ctypes.CDLL(str(library))
    planned = "int group" in source.read_text()
    if planned:
        scan_kernel._bind_merge(lib)
    else:  # the interface before the plan
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.lmi_scan_merge.argtypes = [vp] * 5 + [ci] * 3 + [vp]
        lib.lmi_scan_merge.restype = ci
    return lib, planned


def merge_call(lib, planned: bool, item_d, item_s, pair_items, out_d, out_s, max_items=None,
               plan: Optional[scan_kernel.MergePlan] = None) -> int:
    """One launch of a merge library (``bind_merge``) on the current
    stream, through its own interface; ``plan`` overrides the plan
    ``scan_kernel.merge_plan`` gives for ``max_items``."""
    _, qtile, k = item_d.shape
    args = (item_d.data_ptr(), item_s.data_ptr(), pair_items.data_ptr(), out_d.data_ptr(),
            out_s.data_ptr(), pair_items.shape[0] - 1, qtile, k)
    if planned:
        args += tuple(plan or scan_kernel.merge_plan(k, qtile, max_items))
    return lib.lmi_scan_merge(*args, torch.cuda.current_stream().cuda_stream)


def bind(library: Path, source: Path, merge: Optional[Path] = None,
         merge_source: Path = ROOT / MERGE_SOURCE) -> Side:
    """Load the scan ``library`` built from ``source`` (and the merge
    kernel's, built from ``merge_source``, where given) and set their
    argument types for the interfaces the sources declare."""
    text = source.read_text()
    mapped = "const void* row_ids" in text
    wgmma = "scan_wgmma_kernel" in text
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib = ctypes.CDLL(str(library))
    if wgmma:
        scan_kernel._bind(lib)
    else:
        lib.lmi_scan_pairs.argtypes = [vp] * (14 if mapped else 11) + [ci] * 8 + [vp]
        lib.lmi_scan_pairs.restype = ci
    merge_lib, planned = None, False
    if merge is not None:
        if not wgmma:
            lib.lmi_scan_blocks_per_sm.argtypes = [ci, ci, ci, ctypes.POINTER(ci)]
            lib.lmi_scan_blocks_per_sm.restype = ci
        merge_lib, planned = bind_merge(merge, merge_source)
    return Side(lib, mapped, "scan_f32_kernel" in text, merge_lib, wgmma, planned)


def side_body(side: Side, store, mode: str, k: int, row_ids,
              floored: bool = False) -> Optional[scan_kernel.Body]:
    """The body ``side``'s library picks for a launch at ``k`` (under
    floors), or None where the side has no wgmma body."""
    if not side.wgmma:
        return None
    return scan_kernel.scan_body(side.lib, store, mode, k, row_ids, floored)


def side_kind(side: Side, store, mode: str, k: int, row_ids) -> int:
    """The body ``side``'s first launch at ``k`` takes, as an index of
    ``scan_kernel.BODY_NAMES`` (0, the mma.sync body, where the side has
    no wgmma body)."""
    body = side_body(side, store, mode, k, row_ids)
    return body.kind if body is not None else 0


def bodies_text(kinds: dict) -> str:
    """The bodies ``kinds`` names, side by side, for an ``[ab]`` line."""
    return "; bodies " + ", ".join(f"{n} {scan_kernel.BODY_NAMES[b]}" for n, b in kinds.items())


def side_slots(side: Side, store, mode: str, k: int, row_ids, floored: bool = False) -> int:
    """``side``'s slots on the card for a launch at ``k``: its library's
    occupancy, through its own interface."""
    if side.wgmma:
        return side_body(side, store, mode, k, row_ids, floored).slots
    blocks = ctypes.c_int(0)
    err = side.lib.lmi_scan_blocks_per_sm(k, scan_kernel.MODES[mode],
                                          scan_kernel._STORE_TYPES[store.dtype],
                                          ctypes.byref(blocks))
    cs.check(err == 0 and blocks.value > 0, f"occupancy query failed: cudaError {err}")
    return torch.cuda.get_device_properties(store.device).multi_processor_count * blocks.value


def launcher(side: Side, store, queries, order, mode: str, k: int, segment=None,
             share=scan_kernel.SEGMENT_SHARE):
    """``run()``: ``side``'s scan of ``queries`` visiting ``order`` with the
    wrapper's arguments (null row map and floors in the first round where
    the interface has them), in rounds past 1024; f32 query rows where
    the FMA body meets an f32 store.  A side with the merge kernel splits
    each launch's pairs (``segment`` chunks a segment, or the length
    ``share`` gives) and merges them."""
    _, (q, qidx, pb, ptr, chunk_of, st, sc, qs, row_ids) = scan_inputs(store, queries, order, 128,
                                                                       mode)
    fma = side.fma_body and mode == "f32" and st.dtype == torch.float32
    laid_out = {}

    def operand(body):  # the query rows of the body a launch takes
        qd = body.qd if body is not None and body.wgmma else 0
        if qd not in laid_out:
            laid_out[qd] = q if fma else scan_kernel.operand_queries(q, mode, st.dtype, qd)
        return laid_out[qd]

    terms = 3 if mode == "f32" and not fma else 1
    cs.check(side.mapped or (row_ids is None and k <= scan_kernel.MAX_K),
             "the other interface takes no row map and no floor")
    stream = torch.cuda.current_stream().cuda_stream

    def scan(q_idx, p_bucket, p_ptr, w, floor):
        n_pairs = p_bucket.shape[0]
        pair_order = torch.argsort((p_ptr[1:] - p_ptr[:-1])[p_bucket.long()], descending=True,
                                   stable=True).to(torch.int32)
        out_d = torch.empty((n_pairs, 128, w), device=st.device)
        out_s = torch.empty((n_pairs, 128, w), dtype=torch.int32, device=st.device)
        fd, fp = floor if floor is not None else (None, None)
        extra = tuple(t.data_ptr() if t is not None else None for t in (row_ids, fd, fp))
        body = side_body(side, st, mode, w, row_ids, floor is not None)
        qo = operand(body)
        ran = ctypes.c_int(body.kind if body is not None else 0)
        err = side.lib.lmi_scan_pairs(
            qo.data_ptr(), qs.data_ptr() if qs is not None else None, q_idx.data_ptr(),
            p_bucket.data_ptr(), pair_order.data_ptr(), p_ptr.data_ptr(), chunk_of.data_ptr(),
            st.data_ptr(), sc.data_ptr() if sc is not None else None,
            *(extra if side.mapped else ()), out_d.data_ptr(), out_s.data_ptr(), n_pairs, 128, w,
            st.shape[1], qo.shape[1] // terms, 2048, scan_kernel.MODES[mode],
            scan_kernel._STORE_TYPES[st.dtype],
            *((st.shape[0], ctypes.byref(ran)) if side.wgmma else ()), stream)
        if body is not None:
            cs.check(ran.value == body.kind, f"the library takes body {ran.value}, the "
                     f"queries are laid out for {body.kind}")
        cs.check(err == 0, f"launch failed: cudaError {err}")
        return out_d, out_s

    def merge(item_d, item_s, pair_items, max_items=None):
        n_pairs = pair_items.shape[0] - 1
        out_d = torch.empty((n_pairs, 128, item_d.shape[2]), device=st.device)
        out_s = torch.empty(out_d.shape, dtype=torch.int32, device=st.device)
        err = merge_call(side.merge, side.merge_plan, item_d, item_s, pair_items, out_d, out_s,
                         max_items)
        cs.check(err == 0, f"merge launch failed: cudaError {err}")
        return out_d, out_s

    def one(q_idx, p_bucket, w, floor):
        if side.merge is None:
            return scan(q_idx, p_bucket, ptr, w, floor)
        ptr_h, pb_h, live = scan_kernel.host_plan(ptr, p_bucket, q_idx, 128)
        seg = segment
        if seg is None:
            floored = floor is not None
            body = side_body(side, st, mode, w, row_ids, floored)
            seg = scan_kernel.segment_length(
                ptr_h, pb_h, live, width=scan_kernel.list_width(w),
                slots=side_slots(side, st, mode, w, row_ids, floored), share=share,
                wgmma_block=body.block_queries if body is not None and body.wgmma else 0)
        return scan_kernel.scan_split(lambda qi, b, p, f: scan(qi, b, p, w, f), merge, q_idx,
                                      floor, ptr_h, pb_h, seg, qtile=128, chunk=2048)

    if k <= scan_kernel.MAX_K:
        return lambda: one(qidx, pb, k, None)
    n_slots = st.shape[0] if row_ids is None else row_ids.shape[0]
    positions = scan_kernel.chunk_positions(ptr, chunk_of, n_slots // 2048)
    return lambda: scan_kernel.scan_in_rounds(one, qidx, pb, positions, k=k, qtile=128, chunk=2048)


def probe_shares(side: Side, store, queries, order, shares, rounds: int, smi: str) -> None:
    """This tree's scan at the segment length of each share and over whole
    buckets, in turns: the flagship in bf16 and int8 at k_scan 16 and in
    bf16 at 106 (list width 128, one block an SM), one 1,024-query
    dispatch in bf16 and int8 at 16; the same bits at every share."""
    n_all = queries.shape[0]
    for nq, mode, k in ((n_all, "bf16", 16), (n_all, "int8", 16), (n_all, "bf16", 106),
                        (1024, "bf16", 16), (1024, "int8", 16)):
        q, o = queries[:nq], order[:nq]
        _, sargs = scan_inputs(store, q, o, 128, mode)
        runs, segs = {}, {}
        ptr_h, pb_h, live = scan_kernel.host_plan(sargs[3], sargs[2], sargs[1], 128)
        slots = side_slots(side, sargs[5], mode, k, None)
        body = side_body(side, sargs[5], mode, k, None)
        block = body.block_queries if body is not None and body.wgmma else 0
        for share in (*shares, None):
            seg = WHOLE if share is None else scan_kernel.segment_length(
                ptr_h, pb_h, live, width=scan_kernel.list_width(k), slots=slots, share=share,
                wgmma_block=block)
            name = "whole buckets" if share is None else f"share {share:g}"
            segs[name] = (seg, len(scan_kernel.split_pairs(ptr_h, pb_h, seg).item_pair))
            runs[name] = launcher(side, store, q, o, mode, k, segment=seg)
        del sargs
        outs = {n: tuple(t.clone() for t in run()) for n, run in runs.items()}
        first = next(iter(outs.values()))
        cs.check(all(torch.equal(a, b) for out in outs.values() for a, b in zip(out, first)),
                 f"share probe {mode} {nq} queries: the shares give different bits")
        del outs
        ms = {n: [] for n in runs}
        names = list(runs)
        for r in range(rounds):
            for n in (names if r % 2 == 0 else names[::-1]):
                ms[n].append(cs.cuda_ms(runs[n], 3 if nq > 1024 else 10))
        cs.log(f"[share] {mode} k_scan {k}, {nq} queries, {slots} slots ({rounds} rounds in "
               f"turns, same bits): "
               + "; ".join(f"{n} (segments of {segs[n][0] if segs[n][0] < WHOLE else 'all'} "
                           f"chunks, {segs[n][1]} items) median {float(np.median(t)):.3f} ms "
                           f"[{' '.join(f'{x:.3f}' for x in t)}]" for n, t in ms.items())
               + f"  [{smi}]")
        torch.cuda.empty_cache()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="root of the other checkout")
    p.add_argument("--k", type=int, nargs="+", default=[16, 106, 1024, 1106],
                   help="k_scan values (the packed flagship runs those up to 128)")
    p.add_argument("--rounds", type=int, default=6, help="timed rounds per library and case")
    p.add_argument("--shares", type=float, nargs="*", default=[],
                   help="the segment-length probe's shares of a slot's fair share")
    p.add_argument("--sass-only", action="store_true",
                   help="build both sides, compare their SASS, and stop")
    args = p.parse_args()
    smi = cs.phase_device()
    WORK.mkdir(parents=True, exist_ok=True)
    sources = {"other": args.other.resolve() / SOURCE, "this": ROOT / SOURCE}
    build(sources)
    other, this = sass(WORK / "other.cubin"), sass(WORK / "this.cubin")
    common = sorted(n for n in set(other) & set(this) if n.startswith(("scan_mma_kernel",
                                                                        "scan_wgmma_")))
    differ = []
    for name in common:
        if other[name] != this[name]:
            diff = difflib.unified_diff(other[name], this[name], "other", "this", lineterm="")
            (WORK / f"{name}.diff").write_text("\n".join(diff) + "\n")
            differ.append(name)
    only = sorted(n for n in set(this) - set(other) if n.startswith(("scan_mma_kernel",
                                                                     "scan_wgmma_")))
    cs.log(f"[sass] {len(common)} scan kernel instances in both builds ({len(other)} and "
           f"{len(this)} kernels in all): {len(common) - len(differ)} identical"
           + (f"; differ: {', '.join(differ)}" if differ else "")
           + (f"; only in this build: {', '.join(only)}" if only else ""))
    if args.sass_only:
        return

    dev = torch.device("cuda", 0)
    store, virtual, queries, order = flagship_stores(dev)
    sides = {}
    for name, src in sources.items():
        merge = WORK / f"{name}_merge.so"
        sides[name] = bind(WORK / f"{name}.so", src, merge if merge.exists() else None,
                           src.parents[2] / MERGE_SOURCE)
    cs.log("[ab] " + "; ".join(
        f"{n}: {'splits its pairs and merges' if sd.merge else 'one block a pair'}"
        for n, sd in sides.items()))
    if args.shares:
        cs.check(sides["this"].merge is not None, "the share probe needs this tree's merge kernel")
        probe_shares(sides["this"], store, queries, order, args.shares, args.rounds, smi)
    mapped = all(sd.mapped for sd in sides.values())
    cases = [("packed", store, queries, order, mode, k) for k in args.k if k <= 128
             for mode in ("bf16", "int8", "f32")]
    if mapped:
        cases += [("virtual", virtual, queries, order, mode, k) for k in args.k if k <= 32
                  for mode in ("bf16", "f32")]
        cases += [("virtual", virtual, queries[:256], order[:256], "f32", k) for k in args.k]
    for layout, st, q, o, mode, k in cases:
        runs = {n: launcher(sd, st, q, o, mode, k) for n, sd in sides.items()}
        outs = {n: tuple(t.clone() for t in run()) for n, run in runs.items()}
        sargs = scan_inputs(st, q, o, 128, mode)[1]
        kinds = {n: side_kind(sd, sargs[5], mode, k, sargs[8]) for n, sd in sides.items()}
        del sargs
        packed_bits = ""
        if layout == "virtual" and k <= 32:  # this side's row map against its packed store
            pd, ps = launcher(sides["this"], store, q, o, mode, k)()
            td, ts = outs["this"]
            same = ((td.view(torch.int32) == pd.view(torch.int32)) & (ts == ps)).all(dim=2)
            cs.check(kinds["this"] == 0 or bool(same.all()),
                     f"virtual {mode} k={k}: this side's row-map lists differ from its packed "
                     f"store's")
            packed_bits = f"; this side's lists against its packed store: {int(same.sum())} of " \
                          f"{same.numel()} bit-equal"
            del pd, ps
        if (kinds["this"] > 0) != (kinds["other"] > 0):
            # over a row map, float64 reads the packed store's rows of the same slots
            agree = bodies_agree(outs, f"{layout} {mode} k={k}", mode,
                                 store if layout == "virtual" else st, q, o)
        else:
            same = all(torch.equal(x, y) for x, y in zip(outs["other"], outs["this"]))
            cs.check(same, f"{layout} {mode} k={k}: the two sides give different bits")
            agree = "same bits"
        agree += packed_bits + bodies_text(kinds)
        del outs
        in_turns(runs, f"{layout} {mode} k_scan {k} ({q.shape[0]} queries", agree,
                 3 if layout == "virtual" else 5, args.rounds, smi)
    del virtual
    f32 = cs.dequantized_store(store)
    fma = any(sd.fma_body for sd in sides.values())
    for k in (k for k in args.k if k <= 128):
        runs = {n: launcher(sd, f32, queries, order, "f32", k) for n, sd in sides.items()}
        outs = {n: tuple(t.clone() for t in run()) for n, run in runs.items()}
        sargs = scan_inputs(f32, queries, order, 128, "f32")[1]
        kinds = {n: side_kind(sd, sargs[5], "f32", k, None) for n, sd in sides.items()}
        del sargs
        if kinds["this"] != kinds["other"] and not fma:
            agree = bodies_agree(outs, f"f32 store k={k}", "f32", f32, queries, order)
            agree += bodies_text(kinds)
        elif fma:
            err, gap = cs.compare_candidates(*outs["this"], *outs["other"], "f32",
                                             f"f32 store k={k}: this against other")
            plan, sargs = scan_inputs(f32, queries, order, 128, "f32")
            f64 = {n: cs.float64_error(f32, sargs[0], plan, *outs[n]) for n in outs}
            del sargs
            agree = (f"agree at the f32 parity bar, max|Δd| {err:.3g} (at swapped slots "
                     f"{gap:.3g}); against float64, the first 16 pairs' candidates: this "
                     f"{f64['this']:.3g}, other {f64['other']:.3g}")
        else:
            cs.check(all(torch.equal(x, y) for x, y in zip(outs["other"], outs["this"])),
                     f"f32 store k={k}: the two sides give different bits")
            agree = "same bits"
        del outs
        in_turns(runs, f"f32 store f32 k_scan {k} ({queries.shape[0]} queries", agree, 5,
                 args.rounds, smi)
    cli = cli_shape_store(store)
    f32_what = f"f32 store ({f32.chunk_data.numel() * 4 / 1e9:.1f} GB)"
    for what, st, k in ([(f32_what, f32, k) for k in args.k if k <= 128]
                        + [(f"CLI shape f32 store ({cli.chunk_data.numel() * 4 / 1e9:.1f} GB)",
                            cli, 16)]):
        runs = {n: launcher(sd, st, queries, order, "bf16", k) for n, sd in sides.items()}
        outs = {n: tuple(t.clone() for t in run()) for n, run in runs.items()}
        sargs = scan_inputs(st, queries, order, 128, "bf16")[1]
        kinds = {n: side_kind(sd, sargs[5], "bf16", k, None) for n, sd in sides.items()}
        del sargs
        if kinds["this"] != kinds["other"]:
            agree = bodies_agree(outs, f"{what} bf16 k={k}")
        else:
            cs.check(all(torch.equal(x, y) for x, y in zip(outs["other"], outs["this"])),
                     f"{what} bf16 k={k}: the two sides give different bits")
            agree = "same bits"
        agree += bodies_text(kinds)
        del outs
        in_turns(runs, f"{what} bf16 k_scan {k} ({queries.shape[0]} queries", agree, 5,
                 args.rounds, smi)


def bodies_agree(outs: dict, what: str, mode: str = "bf16", store=None, queries=None,
                 order=None) -> str:
    """The two sides' lists where one ran a wgmma body and the other the
    mma.sync body: held to each other at the bar of the mode (bf16, or the
    f32 parity bar in f32, where each side's distances are also held to
    float64: ``chip_smoke.float64_error`` over the first 16 pairs); how
    many (pair, query slot) lists are bit-equal, distances and slots."""
    (td, ts), (od, os_) = outs["this"], outs["other"]
    err, gap = cs.compare_candidates(td, ts, od, os_, mode, f"{what}: this against other")
    equal = ((td.view(torch.int32) == od.view(torch.int32)) & (ts == os_)).all(dim=2)
    f64 = ""
    if mode == "f32":
        plan, sargs = scan_inputs(store, queries, order, 128, "f32")
        errs = {n: cs.float64_error(store, sargs[0], plan, *outs[n]) for n in outs}
        f64 = (f"; against float64, the first 16 pairs' candidates: this {errs['this']:.3g}, "
               f"other {errs['other']:.3g}")
    return (f"other bodies, agree at the {mode} bar, max|Δd| {err:.3g} (at swapped slots "
            f"{gap:.3g}); {int(equal.sum())} of {equal.numel()} lists bit-equal{f64}")


def in_turns(runs: dict, what: str, agree: str, reps: int, rounds: int, smi: str) -> None:
    """Time ``runs["other"]`` and ``runs["this"]`` in alternating rounds
    (CUDA events, the mean of ``reps`` launches a round) and log both."""
    ms = {n: [] for n in runs}
    for r in range(rounds):
        for n in (("other", "this") if r % 2 == 0 else ("this", "other")):
            ms[n].append(cs.cuda_ms(runs[n], reps))
    med = {n: float(np.median(t)) for n, t in ms.items()}
    cs.log(f"[ab] {what}; mean of {reps} launches a round, {rounds} rounds, {agree}): "
           + "; ".join(f"{n} {' '.join(f'{t:.3f}' for t in ts)} ms, median {med[n]:.3f}"
                       for n, ts in ms.items())
           + f"; this/other {med['this'] / med['other']:.4f}  [{smi}]")
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
