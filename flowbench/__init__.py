"""The benchmark of the PyTorch / CUDA port (``repro_torch``): its served
P->D path under LongBench traffic on one H100. Run a cell with
``python3 flowbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``;
PERF.md says what each metric and cell measures."""
