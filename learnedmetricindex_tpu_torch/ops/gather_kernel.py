"""Row gather: a hand-written CUDA kernel and its plain PyTorch version
(counterpart of ``learnedmetricindex_tpu/ops/gather_kernel.py``).

``gather_rows(table, idx)`` is ``table[clamp(idx, 0, N-1)]`` on rows,
bit for bit, for any dtype whose rows are a whole number of 4-byte
words (:func:`gather_rows_ok`).  Callers mask the rows of out-of-range
indices themselves, as with the JAX package's gathers.

* :func:`gather_rows_reference` — the plain PyTorch version.
* :func:`gather_rows` — the wrapper.  CPU tensors run the plain version;
  CUDA tensors launch ``csrc/gather_rows.cu`` (built with ``nvcc`` for
  ``sm_90a`` at first use into ``build/torch_kernels/``) or raise.
* ``LAUNCHES`` — how many times the wrapper launched the kernel.

The search uses it only under ``LMI_GATHER_MODE=kernel``
(``index/bucket_store.py``), as the JAX package does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from learnedmetricindex_tpu_torch.ops import cuda_build

#: kernel launches made by :func:`gather_rows` (never by the plain version)
LAUNCHES = 0

SOURCE = cuda_build.CSRC / "gather_rows.cu"


def build() -> Tuple[Path, float]:
    """Compile the kernel if this source has no build yet: ``(library
    path, seconds compiling)``."""
    return cuda_build.build_many([SOURCE])[0]


def _bind(lib: ctypes.CDLL) -> None:
    vp = ctypes.c_void_p
    lib.lmi_gather_rows.argtypes = [vp, vp, ctypes.c_int, vp, ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_longlong, vp]
    lib.lmi_gather_rows.restype = ctypes.c_int


def gather_rows_ok(table: torch.Tensor) -> bool:
    """The kernel copies 4-byte words: a row must be a whole number of them."""
    return table.dim() == 2 and (table.shape[1] * table.element_size()) % 4 == 0


def _check(table: torch.Tensor, idx: torch.Tensor) -> None:
    if not gather_rows_ok(table):
        raise ValueError(
            "gather_rows takes a 2-D table whose rows are a multiple of 4 bytes, "
            f"got {tuple(table.shape)} {table.dtype}"
        )
    if table.shape[0] < 1 or table.shape[0] >= 2**31:
        raise ValueError(f"gather_rows takes 1 <= N < 2**31 table rows, got {table.shape[0]}")
    if idx.dim() != 1 or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError("gather_rows takes 1-D int32 or int64 indices")
    if idx.device != table.device:
        raise ValueError("gather_rows: idx must be on the table's device")


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
    idx = idx.contiguous()
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    if idx.shape[0] == 0:
        return out
    lib = cuda_build.load(SOURCE, _bind)
    with torch.cuda.device(table.device):
        err = lib.lmi_gather_rows(
            table.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64), out.data_ptr(),
            idx.shape[0], table.shape[0], table.shape[1] * table.element_size(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
