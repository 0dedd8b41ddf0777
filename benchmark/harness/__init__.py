"""The benchmark harness: one run of one cell of ``BENCHMARK.json``."""
