"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one command
runs one cell once (``python3 perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``)."""
