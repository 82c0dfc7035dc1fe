"""The benchmark of the PyTorch/CUDA port (``repro_torch``): one command
runs one cell once (``python3 -m portbench.run``); cells, configurations,
traffic mixes, drivers and per-layer metric readers are files of their
own, found by the names in ``BENCHMARK.json``."""
