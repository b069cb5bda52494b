"""allset_tpu_torch: the PyTorch and CUDA port of allset_tpu for one NVIDIA H100.

The JAX package ``allset_tpu`` stays the reference; this package mirrors
its layout and module names, imports torch and numpy, and never jax.
Every Pallas kernel on the ported path has a hand-written CUDA kernel
under ``csrc/`` (built with nvcc for sm_90a at first use, see
``ops/_kernels.py``) beside a plain PyTorch version of the same function:
CUDA tensors launch the kernel, CPU tensors take the plain version.

Ported so far: AllSetTransformer and AllDeepSets in every mode of the JAX
CLI (SetGNN on the self-loop split or the unsplit exchange; GPR,
LearnMask, All_num_layers=0; masked NLL, torch Adam), the conv zoo
(HCHA/HGNN, HNHN, UniGNN with its five convs, UniGCNII, MLP), the
clique-expansion baselines (CEGCN, CEGAT), HyperGCN (fast and reapprox)
and the statistical runs protocol with its CLI (``python -m
allset_tpu_torch.cli``), through the sorted segment-sum (K1), PMA's
score+pack (K4 global max, K5 packed table), the fused PMA epilogue
forward and backward, for one run (K2, K3) and for R runs folded into the
width (K2R, K3R), the LayerNorm pair (B12, B13), the row gather (B10),
the sorted gather through shared memory (B9) and K1 with the gather
inside (B11), which the exchange runs. The TPU round's other experiments
(B1-B8) have their kernels too, run by ``experiments/``.

Layout:
  graph/     Incidence (host build + sorted orders), Batch, transforms, splits
  data/      synthetic hypergraph generators and their registry
  ops/       segment-sum (with the gather inside), row gather, segment ops,
             exchange (dir_spmm), PMA score+pack and epilogue, LayerNorm,
             the one-hot segment-sum and streaming experiments, kernel build
  nn/        TorchDense, NormLayer, MLP, PMA, HalfNLHconv, PReLU
  models/    SetGNN, HCHA, HNHN, UniGNN/UniGCNII, MLPModel/LegacyHGNN,
             CEGCN/CEGAT, HyperGCN
  train/     Trainer (runs protocol), presets, experiment factory
  utils/     parameter bridge from the JAX package
  experiments/  the benchmarks/ scripts' kernels on the card, one module each
  cli.py     the experiment command line
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
