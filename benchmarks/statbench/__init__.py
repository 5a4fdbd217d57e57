"""The benchmark harness of statmc_tpu_torch (see benchmarks/run.py)."""
