"""Build and load the port's hand-written CUDA kernels.

Each source under ``csrc/`` has a plain C interface.  ``nvcc`` compiles
it for ``sm_90a`` into a shared library in the gitignored
``build/torch_kernels/``, keyed by a hash of the source and the flags so
that an edited kernel never loads a stale build, and ``ctypes`` loads
it.  There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: Dict[Path, ctypes.CDLL] = {}  # source → loaded library

#: nvcc processes started by :func:`build_many` in this process: a kernel
#: takes every size (rows, chunks, queries) at run time, so growing or
#: compacting a store must leave this unchanged
BUILDS = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    return str(path) if path.exists() else "nvcc"


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}_{h.hexdigest()[:16]}.so"


def build_many(sources: Sequence[Path]) -> List[Tuple[Path, float]]:
    """Compile every source that has no build yet, all ``nvcc`` processes
    started together.  Returns ``(library path, seconds compiling)`` per
    source (0.0 when it was already built).  The compiler's resource
    report (registers, shared memory, spills) is kept beside each
    library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        lib = library_path(src)
        if lib.exists():
            jobs.append((src, lib, None, None, 0.0))
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        global BUILDS
        BUILDS += 1
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((src, lib, tmp, proc, time.perf_counter()))
    out, failed = [], []
    for src, lib, tmp, proc, t0 in jobs:
        if proc is None:
            out.append((lib, 0.0))
            continue
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) building {src}:\n{stderr}")
            continue
        lib.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, lib)
        out.append((lib, seconds))
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of ``source``, built and loaded at first use (later
    calls neither hash nor stat the source: a launch costs only the
    ctypes call); ``bind`` sets its functions' argument and result
    types."""
    lib = _loaded.get(source)
    if lib is None:
        path, _ = build_many([source])[0]
        lib = ctypes.CDLL(str(path))
        bind(lib)
        _loaded[source] = lib
    return lib
