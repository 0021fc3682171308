"""dilibench: the benchmark of the PyTorch/CUDA port of DILI
(`repro_torch`).  `python dilibench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` runs one cell of `BENCHMARK.json` once; see
README.md."""
