from learnedmetricindex_tpu_torch.models.mlp import MLP_REGISTRY, StackedMLP

__all__ = ["MLP_REGISTRY", "StackedMLP"]
