"""Stacked MLP classifiers (counterpart of
``learnedmetricindex_tpu/models/mlp.py``).

All node models of one tree level share one shape, so they live in one
module with a leading model axis: weights ``(M, in, out)``, biases
``(M, out)``.  The forward evaluates every model on the same queries
with one batched matmul per layer, as ``stacked_mlp_apply`` does.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

#: model type → hidden-layer widths (same table as the JAX package,
#: copied because that module imports jax).
MLP_REGISTRY: Dict[str, List[int]] = {
    "MLP": [128],
    "MLP-2": [64],
    "MLP-3": [256],
    "MLP-4": [512],
    "MLP-5": [256, 128],
    "MLP-6": [32],
    "MLP-7": [16],
    "MLP-8": [8],
    "MLP-9": [8, 16],
}


def layer_dims(model_type: str, input_dim: int, output_dim: int) -> List[int]:
    if model_type not in MLP_REGISTRY:
        raise ValueError(f"Model type {model_type} not supported.")
    return [input_dim, *MLP_REGISTRY[model_type], output_dim]


class StackedMLP(nn.Module):
    """``n_models`` same-shape MLPs; ``forward(x (Q, d))`` → logits
    ``(n_models, Q, out)``."""

    def __init__(self, weights: Sequence[torch.Tensor], biases: Sequence[torch.Tensor]):
        super().__init__()
        if len(weights) != len(biases) or not weights:
            raise ValueError("need one bias per weight and at least one layer")
        self.weights = nn.ParameterList(
            [nn.Parameter(w, requires_grad=False) for w in weights]
        )
        self.biases = nn.ParameterList(
            [nn.Parameter(b, requires_grad=False) for b in biases]
        )

    @classmethod
    def init(
        cls,
        n_models: int,
        model_type: str,
        input_dim: int,
        output_dim: int,
        *,
        generator: torch.Generator,
        device,
    ) -> "StackedMLP":
        """``torch.nn.Linear``'s default init, ``U(-1/√fan_in, 1/√fan_in)``
        for weights and biases, drawn from ``generator`` on its own
        device and then moved to ``device``."""
        dims = layer_dims(model_type, input_dim, output_dim)
        gdev = generator.device
        ws, bs = [], []
        for fan_in, fan_out in zip(dims[:-1], dims[1:]):
            bound = 1.0 / fan_in**0.5
            w = torch.empty(n_models, fan_in, fan_out, device=gdev)
            b = torch.empty(n_models, fan_out, device=gdev)
            ws.append(w.uniform_(-bound, bound, generator=generator).to(device))
            bs.append(b.uniform_(-bound, bound, generator=generator).to(device))
        return cls(ws, bs)

    @classmethod
    def from_numpy(cls, params: Sequence[Dict[str, np.ndarray]], device) -> "StackedMLP":
        """Carry stacked JAX parameters (``[{"w": (M, in, out), "b": (M,
        out)}, ...]`` as numpy arrays) across."""
        return cls(
            [torch.tensor(np.asarray(p["w"], np.float32), device=device) for p in params],
            [torch.tensor(np.asarray(p["b"], np.float32), device=device) for p in params],
        )

    def to_numpy(self) -> List[Dict[str, np.ndarray]]:
        return [
            {"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
            for w, b in zip(self.weights, self.biases)
        ]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            # (Q, d) @ (M, d, k) broadcasts to (M, Q, k); later layers are
            # (M, Q, d) @ (M, d, k) — one batched matmul per layer
            h = torch.matmul(h, w) + b[:, None, :]
            if i < last:
                h = torch.relu(h)
        return h
