"""The benchmark of rampvo_tpu_torch (see BENCHMARK.json and PERF.md)."""
