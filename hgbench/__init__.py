"""hgbench: the benchmark of allset_tpu_torch, the PyTorch and CUDA port,
on one NVIDIA H100. See README.md; one run of one cell is
``python3 -m hgbench.run --workload NAME --seed N --seconds S --trace 0|1``."""
