"""ctypes bindings for the host-side layout engine (the port's copy of
``learnedmetricindex_tpu/native``: the same functions and results).

``lmi_native.cpp`` is compiled with the system C++ compiler at first use
into the gitignored ``build/torch_native/`` of the checkout, keyed by a
hash of the source, never into the package.  Every entry point has a
numpy fallback that gives the same results, taken when no compiler or
library is available, so the port works without a toolchain; the
library does the layout passes (grouped slot fills, bucket-id ravel)
in single O(n) loops where the fallback sorts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "lmi_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    """Where the library built from this source lives."""
    return BUILD_DIR / f"liblmi_native_{hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]}.so"


def _compile(lib_path: Path) -> bool:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    for cxx in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", "-o", str(tmp), str(SOURCE)],
                check=True, capture_output=True, timeout=120,
            )
        except (OSError, subprocess.SubprocessError):
            continue
        os.replace(tmp, lib_path)
        return True
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = library_path()
    if not path.exists() and not _compile(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.lmi_fill_slots.argtypes = [i64p, ctypes.c_int64, i64p, i64p, i32p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.lmi_fill_slots_1based.argtypes = [i64p, ctypes.c_int64, i64p, i64p, i32p]
    lib.lmi_bincount.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p]
    lib.lmi_ravel_rows.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def fill_slots(
    group_ids: np.ndarray,
    seg_starts: np.ndarray,
    total: int,
    labels: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Stable grouped layout fill.

    Returns ``(slot_rows (total,) int32 with -1 padding, labels_out or
    None)`` where group ``g``'s rows land at
    ``seg_starts[g] + rank-within-group`` in original order.
    """
    group_ids = np.ascontiguousarray(group_ids, dtype=np.int64)
    seg_starts = np.ascontiguousarray(seg_starts, dtype=np.int64)
    n = len(group_ids)
    slot_rows = np.full(total, -1, dtype=np.int32)
    labels_out = None
    lib = _load()
    if lib is not None:
        cursors = np.zeros(len(seg_starts), dtype=np.int64)
        if labels is not None:
            labels_c = np.ascontiguousarray(labels, dtype=np.int32)
            labels_out = np.full(total, -1, dtype=np.int32)
            lib.lmi_fill_slots(group_ids, n, seg_starts, cursors, slot_rows,
                               labels_c.ctypes.data_as(ctypes.c_void_p),
                               labels_out.ctypes.data_as(ctypes.c_void_p))
        else:
            lib.lmi_fill_slots(group_ids, n, seg_starts, cursors, slot_rows, None, None)
        return slot_rows, labels_out

    # ---- numpy fallback ----
    order = np.argsort(group_ids, kind="stable")
    counts = np.bincount(group_ids, minlength=len(seg_starts))
    src_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = seg_starts[group_ids[order]] + (np.arange(n) - src_starts[group_ids[order]])
    slot_rows[slots] = order
    if labels is not None:
        labels_out = np.full(total, -1, dtype=np.int32)
        labels_out[slots] = np.asarray(labels, dtype=np.int32)[order]
    return slot_rows, labels_out


def fill_slots_1based(group_ids: np.ndarray, seg_starts: np.ndarray, total: int) -> np.ndarray:
    """Grouped fill of 1-based row ids (bucket-store chunk-id grid)."""
    group_ids = np.ascontiguousarray(group_ids, dtype=np.int64)
    seg_starts = np.ascontiguousarray(seg_starts, dtype=np.int64)
    n = len(group_ids)
    ids_out = np.zeros(total, dtype=np.int32)
    lib = _load()
    if lib is not None:
        cursors = np.zeros(len(seg_starts), dtype=np.int64)
        lib.lmi_fill_slots_1based(group_ids, n, seg_starts, cursors, ids_out)
        return ids_out
    slot_rows, _ = fill_slots(group_ids, seg_starts, total)
    valid = slot_rows >= 0
    ids_out[valid] = slot_rows[valid] + 1
    return ids_out


def bincount(group_ids: np.ndarray, n_groups: int) -> np.ndarray:
    group_ids = np.ascontiguousarray(group_ids, dtype=np.int64)
    lib = _load()
    if lib is not None:
        counts = np.zeros(n_groups, dtype=np.int64)
        lib.lmi_bincount(group_ids, len(group_ids), n_groups, counts)
        return counts
    return np.bincount(group_ids, minlength=n_groups).astype(np.int64)


def ravel_rows(pred: np.ndarray, dims) -> np.ndarray:
    """Row-major ravel of multi-level predictions → dense bucket ids."""
    pred = np.ascontiguousarray(pred, dtype=np.int64)
    dims = tuple(int(x) for x in dims)
    strides = np.ones(len(dims), dtype=np.int64)
    for i in range(len(dims) - 2, -1, -1):
        strides[i] = strides[i + 1] * dims[i + 1]
    lib = _load()
    if lib is not None:
        out = np.empty(pred.shape[0], dtype=np.int64)
        lib.lmi_ravel_rows(pred, pred.shape[0], pred.shape[1], strides, out)
        return out
    return np.ravel_multi_index(tuple(pred[:, lvl] for lvl in range(pred.shape[1])), dims)
