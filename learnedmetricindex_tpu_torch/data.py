"""Seeded synthetic corpora generated on the device.

The regime of the JAX package's benchmark corpus (``bench.py``,
``RowGenerator``): unit-norm points around ``n_clusters`` random unit
centers with Gaussian noise of ``noise / √d`` per coordinate.  The bits
differ from the JAX generator's (different PRNG); the distribution is
the same.  Rows come in blocks, so a corpus far larger than one f32 copy
on the device can be produced and consumed block by block.
"""

from __future__ import annotations

import torch


class BlobGenerator:
    """Draws rows of one mixture from a ``torch.Generator`` on ``device``;
    the same seed and the same sequence of calls give the same rows."""

    def __init__(self, n_clusters: int, d: int, seed: int, noise: float, *, device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        centers = torch.randn(
            n_clusters, d, generator=self.generator, device=self.device
        )
        self.centers = centers / centers.norm(dim=1, keepdim=True)
        self.scale = noise / d**0.5

    def rows(self, n: int) -> torch.Tensor:
        """(n, d) f32 unit-norm rows."""
        k, d = self.centers.shape
        assign = torch.randint(0, k, (n,), generator=self.generator, device=self.device)
        x = torch.randn(n, d, generator=self.generator, device=self.device)
        x = x.mul_(self.scale).add_(self.centers[assign])
        return x.div_(x.norm(dim=1, keepdim=True))
