"""The benchmark of mvsformerplusplus_tpu_torch (BENCHMARK.json): harness,
configurations, traffic, metric readers and the plain reference."""
