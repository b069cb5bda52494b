"""Parameter initializers reproducing the reference's init semantics.

Counterpart of ``allset_tpu/nn/init.py``. Every kernel here is laid out
``[in, out]`` as in the JAX package (see ``utils/jax_bridge.py``), and
every draw takes an explicit ``torch.Generator``:

  * torch ``nn.Linear`` default: weight AND bias ~ U(+-1/sqrt(fan_in));
  * glorot (reference ``src/layers.py:31-34``): U(+-sqrt(6/(fan_in+fan_out)))
    on PMA's lin_K / lin_V kernels;
  * xavier_uniform_ with torch's fan rule on the PMA seed ``att_r`` of
    shape (1, heads, C): fan_in = heads*C, fan_out = C;
  * U(+-bound) with an explicit bound: HyperGCN's layers.

Runs: ``generator`` may be a list of R generators, one per statistical
run; the draw then has a leading [R] axis, and slice r is what a single
model drawing from generator r gets (each generator sees the same draws
in the same order).
"""

from __future__ import annotations

import math
from typing import Sequence, Union

import torch

Generators = Union[torch.Generator, Sequence[torch.Generator]]


def _uniform(shape, bound: float, generator: Generators) -> torch.Tensor:
    if isinstance(generator, torch.Generator):
        return torch.empty(shape).uniform_(-bound, bound, generator=generator)
    return torch.stack([_uniform(shape, bound, g) for g in generator])


def torch_linear_kernel(shape, generator: Generators) -> torch.Tensor:
    """U(+-1/sqrt(fan_in)) on an [in, out] kernel."""
    fan_in = shape[0]
    return _uniform(shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, generator)


def torch_linear_bias(fan_in: int, shape, generator: Generators) -> torch.Tensor:
    """torch Linear bias: U(+-1/sqrt(fan_in)) with the layer's fan_in."""
    return _uniform(shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, generator)


def glorot_uniform(shape, generator: Generators) -> torch.Tensor:
    """U(+-sqrt(6/(fan_in+fan_out))) on a 2-D [in, out] kernel."""
    return _uniform(shape, math.sqrt(6.0 / (shape[0] + shape[1])), generator)


def xavier_uniform_torch_fans(shape, generator: Generators) -> torch.Tensor:
    """xavier_uniform_ with torch's fan rule for arbitrary rank:
    fan_in = shape[1] * prod(shape[2:]), fan_out = shape[0] * prod(shape[2:])."""
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive
    fan_out = shape[0] * receptive
    return _uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def uniform_symmetric(shape, bound: float, generator: Generators) -> torch.Tensor:
    """U(+-bound): the HyperGCN layer init (reference ``src/utils.py:27-30``)."""
    return _uniform(shape, bound, generator)
