"""Benchmark of the PyTorch/CUDA port on one H100 (see PERF.md and BENCHMARK.json)."""
