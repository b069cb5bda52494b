"""One torch CPU thread in each test process.

Pytest imports every test module in each xdist worker before any test
runs, so this module's body caps torch's intra-op threads for the whole
worker: six workers with torch's default of one thread per core would
oversubscribe the cores, and the port's tests, whose tensors are small,
gain nothing from more threads. The port's spawned ranks
(``allset_tpu_torch/parallel/distributed.py::spawn``) set one thread too.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_one_cpu_thread_in_this_worker():
    assert torch.get_num_threads() == 1
