"""Operators of the port: quantization, the fused bucket-scan kernel,
tie-exact top-k selection and the exact kNN oracle."""
