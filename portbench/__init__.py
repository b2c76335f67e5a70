"""portbench: the benchmark of the PyTorch + CUDA port (medplib_tpu_torch).

Nothing in this package imports jax, the JAX package or, under
`portbench/reference/`, the port. `run.py` runs one cell once; the cells,
configurations, traffic mixes and per-layer metrics are files found by the
names that BENCHMARK.json gives.
"""
