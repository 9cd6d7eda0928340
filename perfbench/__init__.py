"""The benchmark of the PyTorch and CUDA port (``repro_torch``): one cell a
run, ``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``."""
