"""The benchmark of tpujoin_torch, the PyTorch and CUDA port: a harness
driven by BENCHMARK.json (``run.py``), the plain reference of the join and
the comparisons that decide ``correct``, the roofline yardstick, and one
file a configuration, traffic mix, call, key generator and metric."""
