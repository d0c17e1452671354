"""hetbench: the benchmark of repro_torch (the PyTorch and CUDA port).

One run measures one cell of BENCHMARK.json:

    python3 hetbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Cells, configurations, traffic mixes, per-layer metrics and limits are
files found by name (configs/, traffic/, metrics/, cells/); reference/
holds the plain float32 model the outputs are judged against.
"""
