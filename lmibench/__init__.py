"""The benchmark of ``learnedmetricindex_tpu_torch`` on NVIDIA H100 cards.

``python3 -m lmibench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``.  Nothing here imports JAX or the
JAX package; ``lmibench.reference`` imports nothing of the port either.
"""
