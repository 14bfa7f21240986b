"""The benchmark of ``dtqn_tpu_torch`` (see ``BENCHMARK.json`` and
``perfbench/run.py``).  It imports nothing of the JAX package."""
