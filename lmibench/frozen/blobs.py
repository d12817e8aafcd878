"""The corpus regime and the row quantization, frozen.

``BlobGenerator`` is copied from ``learnedmetricindex_tpu_torch/data.py``
and ``quantize_rows`` / ``dequantize_rows`` from
``learnedmetricindex_tpu_torch/ops/quantize.py``, both at commit
b3ffd3826c26c05cb00d092b6ec25ccd26c9f8e8.  The generator is the regime of
the JAX package's ``bench.py`` corpus: unit-norm points around
``n_clusters`` random unit centres with Gaussian noise of
``noise / sqrt(d)`` a coordinate.  Rows come in blocks from one
``torch.Generator`` on the device, so the same seed and the same
sequence of calls give the same bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

QMAX = 127
EPS = 1e-12


class BlobGenerator:
    """Draws rows of one mixture from a ``torch.Generator`` on ``device``."""

    def __init__(self, n_clusters: int, d: int, seed: int, noise: float, *, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        centers = torch.randn(n_clusters, d, generator=self.generator, device=self.device)
        self.centers = centers / centers.norm(dim=1, keepdim=True)
        self.scale = noise / d**0.5

    def rows(self, n: int) -> torch.Tensor:
        """(n, d) f32 unit-norm rows."""
        k, d = self.centers.shape
        assign = torch.randint(0, k, (n,), generator=self.generator, device=self.device)
        x = torch.randn(n, d, generator=self.generator, device=self.device)
        x = x.mul_(self.scale).add_(self.centers[assign])
        return x.div_(x.norm(dim=1, keepdim=True))


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n, d) floats -> (int8 values, (n,) f32 scales): symmetric per row,
    ``scale = max(max|x|, 1e-12) / 127``, ``q = clip(round(x / scale))``."""
    amax = torch.clamp_min(x.float().abs().amax(dim=-1), EPS)
    # a tensor divisor: division by a Python scalar becomes a multiply by
    # its reciprocal, which is off by one ulp at times
    scales = amax / torch.full_like(amax, QMAX)
    q = torch.clamp(torch.round(x.float() / scales[:, None]), -QMAX, QMAX).to(torch.int8)
    return q, scales


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    return q.float() * scales[..., None]
