"""The benchmark of the PyTorch/CUDA port (``satellite_approximation_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``; ``portbench/core.py`` says how a cell's
files are found by name.
"""
