"""Row gathers: hand-written CUDA kernels and their plain PyTorch
versions (counterpart of ``learnedmetricindex_tpu/ops/gather_kernel.py``).

``gather_rows(table, idx)`` is ``table[clamp(idx, 0, N-1)]`` on rows,
bit for bit, for any dtype whose rows are a whole number of 4-byte
words (:func:`gather_rows_ok`).  Callers mask the rows of out-of-range
indices themselves, as with the JAX package's gathers.

``gather_pairs(cand_d, cand_s, pair_rows, V)`` is the merge's gather:
both candidate tables of the scan, row ``clamp(pair_rows[i])`` of each
into row ``i`` of ``(Q, V·k)`` outputs, with ``+inf`` / ``-1`` where
``pair_rows[i] < 0``, in one launch (the JAX merge's "one interleaved
row gather instead of two", without its int32 bit view).

* :func:`gather_rows_reference`, :func:`gather_pairs_reference` — the
  plain PyTorch versions.
* :func:`gather_rows`, :func:`gather_pairs` — the wrappers.  CPU tensors
  run the plain version; CUDA tensors launch ``csrc/gather_rows.cu``
  (built with ``nvcc`` for ``sm_90a`` at first use into
  ``build/torch_kernels/``) or raise.
* ``LAUNCHES``, ``PAIR_LAUNCHES`` — how many times each wrapper launched
  its kernel.

The search calls :func:`gather_pairs` under ``LMI_GATHER_MODE=kernel``
(``index/bucket_store.py::merge_pairs``), as the JAX package does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from learnedmetricindex_tpu_torch.ops import cuda_build

#: kernel launches made by :func:`gather_rows` (never by the plain version)
LAUNCHES = 0
#: kernel launches made by :func:`gather_pairs` (never by the plain version)
PAIR_LAUNCHES = 0

SOURCE = cuda_build.CSRC / "gather_rows.cu"


def build() -> Tuple[Path, float]:
    """Compile the kernels if this source has no build yet: ``(library
    path, seconds compiling)``."""
    return cuda_build.build_many([SOURCE])[0]


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.lmi_gather_rows.argtypes = [vp, vp, ci, vp, cll, ci, cll, vp]
    lib.lmi_gather_rows.restype = ci
    lib.lmi_gather_pairs.argtypes = [vp, vp, vp, ci, vp, vp, cll, ci, ci, vp]
    lib.lmi_gather_pairs.restype = ci


def _launch(device: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, switching the
    current device only where it is another one."""
    if device.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    with torch.cuda.device(device):
        return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def gather_rows_ok(table: torch.Tensor) -> bool:
    """The kernel copies 4-byte words: a row must be a whole number of them."""
    return table.dim() == 2 and (table.shape[1] * table.element_size()) % 4 == 0


def _check_index(idx: torch.Tensor, device: torch.device, what: str) -> None:
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{what} takes 1-D int32 or int64 indices")
    if idx.device != device:
        raise ValueError(f"{what}: the indices must be on the table's device")


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if not gather_rows_ok(table):
        raise ValueError(
            "gather_rows takes a 2-D table whose rows are a multiple of 4 bytes, "
            f"got {tuple(table.shape)} {table.dtype}"
        )
    if table.shape[0] < 1 or table.shape[0] >= 2**31:
        raise ValueError(f"gather_rows takes 1 <= N < 2**31 table rows, got {table.shape[0]}")
    _check_index(idx, table.device, "gather_rows")


def gather_rows_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``table[idx.clamp(0, N-1)]``, ``(M, d)``."""
    _check(table, idx)
    return table[idx.long().clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(N, d)[(M,)] -> (M, d)`` with ``idx`` clamped to ``[0, N)``: the
    CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if table.device.type == "cpu":
        return gather_rows_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows runs on cpu or cuda, not {table.device}")
    _check(table, idx)
    if not table.is_contiguous():
        raise ValueError("gather_rows: the table must be contiguous")
    if not idx.is_contiguous():
        idx = idx.contiguous()
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if idx.shape[0] == 0:
        return out
    lib = cuda_build.load(SOURCE, _bind)
    err = _launch(
        table.device, lib.lmi_gather_rows,
        table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), out.data_ptr(),
        idx.shape[0], table.shape[0], table.shape[1] * table.element_size(),
    )
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _check_pairs(cand_d: torch.Tensor, cand_s: torch.Tensor, pair_rows: torch.Tensor,
                 V: int) -> None:
    if cand_d.dim() != 2 or cand_d.dtype != torch.float32 or cand_s.dtype != torch.int32:
        raise ValueError("gather_pairs takes (R, k) f32 distances and (R, k) int32 slots")
    if cand_s.shape != cand_d.shape or cand_s.device != cand_d.device:
        raise ValueError("gather_pairs: distances and slots must match in shape and device")
    if not 1 <= cand_d.shape[0] < 2**31 or not 1 <= cand_d.shape[1] < 2**31:
        raise ValueError(f"gather_pairs takes 1 <= R, k < 2**31, got {tuple(cand_d.shape)}")
    _check_index(pair_rows, cand_d.device, "gather_pairs")
    if V < 1 or pair_rows.shape[0] % V:
        raise ValueError(f"gather_pairs: {pair_rows.shape[0]} rows are not Q·V for V={V}")


def gather_pairs_reference(
    cand_d: torch.Tensor, cand_s: torch.Tensor, pair_rows: torch.Tensor, V: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: ``(Q, V·k)`` distances and slots, row
    ``clamp(pair_rows[i], 0, R-1)`` of each table, ``+inf`` / ``-1``
    where ``pair_rows[i] < 0``."""
    _check_pairs(cand_d, cand_s, pair_rows, V)
    rows = pair_rows.long().clamp(0, cand_d.shape[0] - 1)
    ok = (pair_rows >= 0)[:, None]
    Q, width = pair_rows.shape[0] // V, V * cand_d.shape[1]
    d = torch.where(ok, cand_d[rows], torch.inf).reshape(Q, width)
    s = torch.where(ok, cand_s[rows], -1).reshape(Q, width)
    return d, s


def gather_pairs(
    cand_d: torch.Tensor, cand_s: torch.Tensor, pair_rows: torch.Tensor, V: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The merge's gather (see module docstring): one CUDA launch for
    CUDA tensors, the plain version for CPU tensors.  Same arguments and
    results as :func:`gather_pairs_reference`."""
    if cand_d.device.type == "cpu":
        return gather_pairs_reference(cand_d, cand_s, pair_rows, V)
    if cand_d.device.type != "cuda":
        raise ValueError(f"gather_pairs runs on cpu or cuda, not {cand_d.device}")
    _check_pairs(cand_d, cand_s, pair_rows, V)
    if not (cand_d.is_contiguous() and cand_s.is_contiguous()):
        raise ValueError("gather_pairs: the candidate tables must be contiguous")
    if not pair_rows.is_contiguous():
        pair_rows = pair_rows.contiguous()
    R, k = cand_d.shape
    Q = pair_rows.shape[0] // V
    out_d = torch.empty((Q, V * k), dtype=torch.float32, device=cand_d.device)
    out_s = torch.empty((Q, V * k), dtype=torch.int32, device=cand_d.device)
    if Q == 0:
        return out_d, out_s
    lib = cuda_build.load(SOURCE, _bind)
    err = _launch(
        cand_d.device, lib.lmi_gather_pairs,
        cand_d.data_ptr(), cand_s.data_ptr(), pair_rows.data_ptr(),
        int(pair_rows.dtype == torch.int64), out_d.data_ptr(), out_s.data_ptr(),
        pair_rows.shape[0], R, k,
    )
    if err != 0:
        raise RuntimeError(f"gather_pairs kernel launch failed: cudaError {err}")
    global PAIR_LAUNCHES
    PAIR_LAUNCHES += 1
    return out_d, out_s
