"""Operators of the port: quantization, the fused bucket-scan kernel,
tie-exact top-k selection and the exact kNN oracle."""

from learnedmetricindex_tpu_torch.ops.kmeans import kmeans, kmeans_nodes
from learnedmetricindex_tpu_torch.ops.knn import exact_knn, recall

__all__ = ["exact_knn", "recall", "kmeans", "kmeans_nodes"]
