#!/usr/bin/env python3
"""The port's scan kernel against another checkout's, on one NVIDIA GPU.

    python3 tools/torch_scan_ab.py OTHER_CHECKOUT [--k 16 106 1024 1106] [--rounds 6]

Builds ``learnedmetricindex_tpu_torch/csrc/scan_pairs.cu`` of this tree
and of ``OTHER_CHECKOUT`` (for example a ``git archive`` of the parent
commit) with the port's nvcc flags into ``build/scan_ab/``; compares the
SASS of the list-width-32 instances (bf16, int8 and f32 over an int8
store; addresses and register names left as they are, branch targets
masked) and writes each diff to ``build/scan_ab/``; then times both
libraries in one process on the same inputs, alternating which goes
first, and checks that both give the same bits (distances and slots) at
every ``k``:

* the flagship (``chip_smoke.make_corpus``: 10M×768 int8, 120
  nearest-centroid buckets, a packed store, 10k queries visiting 4, qtile
  128) in modes bf16, int8 and f32, at each ``k`` up to 128;
* f32 over a virtual store of the same corpus (the id grid), the first
  256 queries (``search(k=1100)``'s scan in ``chip_smoke.phase_virtual``),
  at every ``k``; past 1024 in rounds of at most 1024
  (``scan_kernel.scan_in_rounds``), one launch a round.

Then f32 over the flagship's rows as an f32 store
(``chip_smoke.dequantized_store``, 31 GB) at each ``k`` up to 128.  A
checkout whose source still has the CUDA-core FMA body for it
(``scan_f32_kernel``) takes f32 query rows there, this tree the
three-term rows of ``operand_queries``; the two round differently, so
that case is held to the f32 parity bar (``chip_smoke.compare_candidates``)
and each side's distances to float64 (``chip_smoke.float64_error``), not
to equal bits.

Both sources must take ``lmi_scan_pairs``'s arguments with or without the
row-map and floor pointers; without them (the earlier interface) only the
packed cases up to 1024 run.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from learnedmetricindex_tpu_torch.index.bucket_store import BucketStore, scan_inputs  # noqa: E402
from learnedmetricindex_tpu_torch.ops import cuda_build, scan_kernel  # noqa: E402

SOURCE = Path("learnedmetricindex_tpu_torch/csrc/scan_pairs.cu")
WORK = ROOT / "build" / "scan_ab"
INSTANCES = ("scan_mma_kernelILi1EaLi32E", "scan_mma_kernelILi2EaLi32E",
             "scan_mma_kernelILi0EaLi32E")


def build(sources: dict) -> None:
    nvcc, flags = cuda_build._nvcc(), cuda_build.NVCC_FLAGS
    cubin_flags = flags[: flags.index("-shared")]
    procs = []
    for name, src in sources.items():
        for cmd in ([*flags, "-o", str(WORK / f"{name}.so")],
                    [*cubin_flags, "-cubin", "-o", str(WORK / f"{name}.cubin")]):
            procs.append(subprocess.Popen([nvcc, *cmd, str(src)], stdout=subprocess.DEVNULL,
                                          stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate()
        cs.check(p.returncode == 0, f"nvcc failed: {err.decode()[-2000:]}")


def sass(cubin: Path) -> dict:
    """Instruction lines per kernel, encodings and offsets dropped."""
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
        funcs[name.strip()] = lines
    return funcs


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


def bind(lib, source: Path) -> tuple:
    """Set ``lmi_scan_pairs``'s argument types for the interface ``source``
    declares: (whether it takes the row-map and floor pointers, whether
    f32 over an f32 store takes f32 query rows: the FMA body)."""
    text = source.read_text()
    mapped = "const void* row_ids" in text
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.lmi_scan_pairs.argtypes = [vp] * (14 if mapped else 11) + [ci] * 8 + [vp]
    lib.lmi_scan_pairs.restype = ci
    return mapped, "scan_f32_kernel" in text


def launcher(lib, mapped: bool, fma_body: bool, store, queries, order, mode: str, k: int):
    """``run()``: ``lib``'s kernel over the scan of ``queries`` visiting
    ``order`` with the wrapper's arguments (null row map and floors in the
    first round where the interface has them), in rounds past 1024; f32
    query rows where ``fma_body`` meets an f32 store."""
    _, (q, qidx, pb, ptr, chunk_of, st, sc, qs, row_ids) = scan_inputs(store, queries, order, 128,
                                                                       mode)
    fma = fma_body and mode == "f32" and st.dtype == torch.float32
    qo = q if fma else scan_kernel.operand_queries(q, mode, st.dtype)
    terms = 3 if mode == "f32" and not fma else 1
    cs.check(mapped or (row_ids is None and k <= scan_kernel.MAX_K),
             "the other interface takes no row map and no floor")

    def one(q_idx, p_bucket, w, floor):
        n_pairs = p_bucket.shape[0]
        pair_order = torch.argsort((ptr[1:] - ptr[:-1])[p_bucket.long()], descending=True,
                                   stable=True).to(torch.int32)
        out_d = torch.empty((n_pairs, 128, w), device=st.device)
        out_s = torch.empty((n_pairs, 128, w), dtype=torch.int32, device=st.device)
        fd, fp = floor if floor is not None else (None, None)
        extra = tuple(t.data_ptr() if t is not None else None for t in (row_ids, fd, fp))
        err = lib.lmi_scan_pairs(
            qo.data_ptr(), qs.data_ptr() if qs is not None else None, q_idx.data_ptr(),
            p_bucket.data_ptr(), pair_order.data_ptr(), ptr.data_ptr(), chunk_of.data_ptr(),
            st.data_ptr(), sc.data_ptr() if sc is not None else None,
            *(extra if mapped else ()), out_d.data_ptr(), out_s.data_ptr(), n_pairs, 128, w,
            st.shape[1], qo.shape[1] // terms, 2048, scan_kernel.MODES[mode],
            scan_kernel._STORE_TYPES[st.dtype], torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"launch failed: cudaError {err}")
        return out_d, out_s

    if k <= scan_kernel.MAX_K:
        return lambda: one(qidx, pb, k, None)
    n_slots = st.shape[0] if row_ids is None else row_ids.shape[0]
    positions = scan_kernel.chunk_positions(ptr, chunk_of, n_slots // 2048)
    return lambda: scan_kernel.scan_in_rounds(one, qidx, pb, positions, k=k, qtile=128, chunk=2048)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="root of the other checkout")
    p.add_argument("--k", type=int, nargs="+", default=[16, 106, 1024, 1106],
                   help="k_scan values (the packed flagship runs those up to 128)")
    p.add_argument("--rounds", type=int, default=6, help="timed rounds per library and case")
    args = p.parse_args()
    smi = cs.phase_device()
    WORK.mkdir(parents=True, exist_ok=True)
    sources = {"other": args.other.resolve() / SOURCE, "this": ROOT / SOURCE}
    build(sources)
    other, this = sass(WORK / "other.cubin"), sass(WORK / "this.cubin")
    for tag in INSTANCES:
        a = next(v for k, v in other.items() if tag in k)
        b = next(v for k, v in this.items() if tag in k)
        diff = list(difflib.unified_diff(a, b, "other", "this", lineterm=""))
        (WORK / f"{tag}.diff").write_text("\n".join(diff) + "\n")
        changed = sum(1 for ln in diff[2:] if ln[:1] in "+-")
        cs.log(f"[sass] {tag}: other {len(a)} instructions, this {len(b)}, "
               f"{'identical' if a == b else f'{changed} lines differ'}")

    dev = torch.device("cuda", 0)
    store, virtual, queries, order = flagship_stores(dev)
    libs = {}
    for name, src in sources.items():
        lib = ctypes.CDLL(str(WORK / f"{name}.so"))
        libs[name] = (lib, *bind(lib, src))
    mapped = all(m for _, m, _ in libs.values())
    cases = [("packed", store, queries, order, mode, k) for k in args.k if k <= 128
             for mode in ("bf16", "int8", "f32")]
    if mapped:
        cases += [("virtual", virtual, queries[:256], order[:256], "f32", k) for k in args.k]
    for layout, st, q, o, mode, k in cases:
        runs = {n: launcher(lib, m, f, st, q, o, mode, k) for n, (lib, m, f) in libs.items()}
        outs = {n: tuple(t.clone() for t in run()) for n, run in runs.items()}
        same = all(torch.equal(x, y) for x, y in zip(outs["other"], outs["this"]))
        cs.check(same, f"{layout} {mode} k={k}: the two kernels give different bits")
        del outs
        in_turns(runs, f"{layout} {mode} k_scan {k} ({q.shape[0]} queries", "same bits",
                 3 if layout == "virtual" else 5, args.rounds, smi)
    del virtual
    f32 = cs.dequantized_store(store)
    for k in (k for k in args.k if k <= 128):
        runs = {n: launcher(lib, m, f, f32, queries, order, "f32", k)
                for n, (lib, m, f) in libs.items()}
        outs = {n: tuple(t.clone() for t in run()) for n, run in runs.items()}
        err, gap = cs.compare_candidates(*outs["this"], *outs["other"], "f32",
                                         f"f32 store k={k}: this against other")
        plan, sargs = scan_inputs(f32, queries, order, 128, "f32")
        f64 = {n: cs.float64_error(f32, sargs[0], plan, *outs[n]) for n in outs}
        del outs, sargs
        in_turns(runs, f"f32 store f32 k_scan {k} ({queries.shape[0]} queries",
                 f"agree at the f32 parity bar, max|Δd| {err:.3g} (at swapped slots {gap:.3g}); "
                 f"against float64, the first 16 pairs' candidates: this {f64['this']:.3g}, "
                 f"other {f64['other']:.3g}", 5, args.rounds, smi)


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
