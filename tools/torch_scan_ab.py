#!/usr/bin/env python3
"""The port's scan kernel against another checkout's, on one NVIDIA GPU.

    python3 tools/torch_scan_ab.py OTHER_CHECKOUT [--rounds 6]

Builds ``learnedmetricindex_tpu_torch/csrc/scan_pairs.cu`` of this tree
and of ``OTHER_CHECKOUT`` (for example a ``git archive`` of the parent
commit) with the port's nvcc flags into ``build/scan_ab/``; compares the
SASS of the bf16 and int8 instances at list widths 32 and 64 (addresses
and register names left as they are, branch targets masked) and writes
each diff to ``build/scan_ab/``; then times both libraries in one
process on the same flagship inputs (``chip_smoke.make_corpus``: 10M×768
int8, 120 nearest-centroid buckets, 10k queries visiting 4, ``k_scan``
16, qtile 128), alternating which goes first, and checks that both give
the same bits.  Both sources must share the C interface of bf16 and int8
mode.
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
             "scan_mma_kernelILi1EaLi64E", "scan_mma_kernelILi2EaLi64E")


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


def flagship_store(dev):
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
    order = torch.topk(queries @ cent.T - half_sq, 4, dim=1).indices.int()
    return store, queries, order


def launcher(lib, store, queries, order, mode: str):
    """One launch of ``lib``'s kernel with the wrapper's arguments."""
    _, (q, qidx, pb, ptr, chunk_of, st, sc, qs) = scan_inputs(store, queries, order, 128, mode)
    qo = scan_kernel.operand_queries(q, mode, st.dtype)
    n_pairs = pb.shape[0]
    pair_order = torch.argsort((ptr[1:] - ptr[:-1])[pb.long()], descending=True,
                               stable=True).to(torch.int32)
    out_d = torch.empty((n_pairs, 128, 16), device=st.device)
    out_s = torch.empty((n_pairs, 128, 16), dtype=torch.int32, device=st.device)

    def run():
        err = lib.lmi_scan_pairs(
            qo.data_ptr(), qs.data_ptr() if qs is not None else None, qidx.data_ptr(),
            pb.data_ptr(), pair_order.data_ptr(), ptr.data_ptr(), chunk_of.data_ptr(),
            st.data_ptr(), sc.data_ptr(), out_d.data_ptr(), out_s.data_ptr(), n_pairs, 128, 16,
            st.shape[1], qo.shape[1], 2048, scan_kernel.MODES[mode], 2,
            torch.cuda.current_stream().cuda_stream)
        cs.check(err == 0, f"launch failed: cudaError {err}")
        return out_d, out_s
    return run


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", type=Path, help="root of the other checkout")
    p.add_argument("--rounds", type=int, default=6, help="timed rounds per library and mode")
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
    store, queries, order = flagship_store(dev)
    libs = {}
    for name in sources:
        libs[name] = ctypes.CDLL(str(WORK / f"{name}.so"))
        scan_kernel._bind(libs[name])
    for mode in ("bf16", "int8"):
        runs = {n: launcher(lib, store, queries, order, mode) for n, lib in libs.items()}
        outs = {n: tuple(t.clone() for t in run()) for n, run in runs.items()}
        same = all(torch.equal(x, y) for x, y in zip(outs["other"], outs["this"]))
        cs.check(same, f"{mode}: the two kernels give different bits")
        ms = {n: [] for n in runs}
        for r in range(args.rounds):
            for n in (("other", "this") if r % 2 == 0 else ("this", "other")):
                ms[n].append(cs.cuda_ms(runs[n], 5))
        med = {n: float(np.median(t)) for n, t in ms.items()}
        cs.log(f"[ab] {mode} (mean of 5 launches a round, {args.rounds} rounds, same bits): "
               + "; ".join(f"{n} {' '.join(f'{t:.3f}' for t in ts)} ms, median {med[n]:.3f}"
                           for n, ts in ms.items())
               + f"; this/other {med['this'] / med['other']:.4f}  [{smi}]")


if __name__ == "__main__":
    main()
