"""allset_tpu_torch: the PyTorch and CUDA port of allset_tpu for one NVIDIA H100.

The JAX package ``allset_tpu`` stays the reference; this package mirrors
its layout and module names, imports torch and numpy, and never jax.
Every Pallas kernel on the ported path has a hand-written CUDA kernel
under ``csrc/`` (built with nvcc for sm_90a at first use, see
``ops/_kernels.py``) beside a plain PyTorch version of the same function:
CUDA tensors launch the kernel, CPU tensors take the plain version.

Ported so far: the AllSetTransformer training step (SetGNN, pma=True,
self-loop split, masked NLL, torch Adam) and its three kernels: the
sorted segment-sum (K1) and the fused PMA epilogue forward (K2) and
backward (K3).

Layout:
  graph/     Incidence (host build + sorted orders), Batch, transforms
  data/      synthetic hypergraph generators
  ops/       segment-sum, exchange (dir_spmm), PMA epilogue, kernel build
  nn/        TorchDense, MLP, PMA, HalfNLHconv
  models/    SetGNN
  train/     masked NLL and the Adam training step
  utils/     parameter bridge from the JAX package
"""

import torch

# f32 matmuls on the card run in full f32, not TF32: the port is held to
# the JAX package's f32 numbers (this is PyTorch's default; set it so).
torch.backends.cuda.matmul.allow_tf32 = False

__version__ = "0.1.0"

from allset_tpu_torch.graph import (  # noqa: E402,F401
    Batch,
    HyperData,
    Incidence,
    add_self_loops,
    coalesce,
    norm_construction,
)
from allset_tpu_torch.models import SetGNN, SetGNNConfig  # noqa: E402,F401
