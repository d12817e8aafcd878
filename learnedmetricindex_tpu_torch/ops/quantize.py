"""Row-scaled int8 quantization (counterpart of
``learnedmetricindex_tpu/ops/quantize.py``).

Symmetric per row: ``scale = max(max|x|, 1e-12) / 127`` and
``q = clip(round(x / scale), -127, 127)``.  Every step is one correctly
rounded f32 operation (round half to even), so the results are
bit-equal to the numpy and jax versions on any device.
"""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-12
QMAX = 127


def row_scales(x: torch.Tensor) -> torch.Tensor:
    """(n, d) floats → (n,) f32 per-row scales."""
    amax = torch.clamp_min(x.float().abs().amax(dim=-1), EPS)
    # a tensor divisor: torch turns division by a Python scalar into a
    # multiply by its reciprocal, which is off by one ulp at times
    return amax / torch.full_like(amax, QMAX)


def quantize_with_scales(x: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(n, d) floats + (n,) scales → (n, d) int8."""
    q = torch.round(x.float() / scales[..., None])
    return torch.clamp(q, -QMAX, QMAX).to(torch.int8)


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, d) floats → (int8 values, (n,) f32 scales)."""
    scales = row_scales(x)
    return quantize_with_scales(x, scales), scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """(…, d) int8 + (…,) scales → f32."""
    return q.float() * scales[..., None]
