from learnedmetricindex_tpu_torch.models.mlp import MLP_REGISTRY, StackedMLP
from learnedmetricindex_tpu_torch.models.train import NeuralNetwork, train_until_covered

__all__ = ["MLP_REGISTRY", "StackedMLP", "NeuralNetwork", "train_until_covered"]
