"""The benchmark of minilp_tpu_torch, the PyTorch/CUDA port, on one H100:
`python3 -m lpbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
(`lpbench/run.py`).  Its cells and metrics are listed in `BENCHMARK.json`."""
