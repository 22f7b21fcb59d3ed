"""The benchmark of tpinn_torch on NVIDIA cards (see BENCHMARK.json and
``python3 -m benchmark.run --help``)."""
