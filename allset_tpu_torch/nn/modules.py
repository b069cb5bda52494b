"""Core neural modules: TorchDense, MLP, PMA (attention pooling), HalfNLHconv.

Counterpart of ``allset_tpu/nn/modules.py`` for the AllSetTransformer
path. Parameter names and shapes follow the JAX package's flax names, so
a ``state_dict`` key is the flax path joined by dots (see
``utils/jax_bridge.py``); kernels keep the flax layout ``[in, out]``.
Parameters are float32; ``dtype`` is the activation dtype.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from allset_tpu_torch.graph.incidence import Direction
from allset_tpu_torch.nn.init import (
    glorot_uniform,
    torch_linear_bias,
    torch_linear_kernel,
    xavier_uniform_torch_fans,
)
from allset_tpu_torch.ops.cuda_pma import pma_epilogue
from allset_tpu_torch.ops.exchange import dir_spmm

NEGATIVE_SLOPE = 0.2  # PMA's leaky_relu on the seed scores


def packed_width(HC: int, H: int) -> int:
    """Width of PMA's packed exchange table [values HC | denominators H |
    zero pad]: the next multiple of 8, so rows are whole 16-byte vectors."""
    return -(-(HC + H) // 8) * 8


class TorchDense(nn.Module):
    """Dense layer with torch ``nn.Linear`` default init; kernel [in, out].

    bf16 rounding points of the JAX layer: the product is rounded to the
    activation dtype, then the bias is added in that dtype."""

    def __init__(self, fan_in: int, features: int, generator: torch.Generator,
                 kernel_init=torch_linear_kernel,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.kernel = nn.Parameter(kernel_init((fan_in, features), generator))
        self.bias = nn.Parameter(torch_linear_bias(fan_in, (features,), generator))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel
        if self.dtype is not None:
            x, k = x.to(self.dtype), k.to(self.dtype)
        y = x @ k
        return y + self.bias.to(y.dtype)


class LNParams(nn.Module):
    """LayerNorm parameters ('scale', 'bias'), consumed by the fused
    epilogue."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class MLPParams(nn.Module):
    """Parameters of an equal-width MLP ('lin{i}'), stacked for the fused
    epilogue as [L, F, F] kernels and [L, F] biases."""

    def __init__(self, hidden: int, out: int, num_layers: int,
                 generator: torch.Generator):
        super().__init__()
        for i in range(num_layers):
            width = out if i == num_layers - 1 else hidden
            self.add_module(f"lin{i}", TorchDense(hidden, width, generator))
        self.num_layers = num_layers

    def stacked(self):
        lins = [getattr(self, f"lin{i}") for i in range(self.num_layers)]
        return (torch.stack([m.kernel for m in lins]),
                torch.stack([m.bias for m in lins]))


class MLP(nn.Module):
    """The classifier MLP. One layer is a linear map (TorchDense)."""

    def __init__(self, in_dim: int, out: int, num_layers: int,
                 generator: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        if num_layers != 1:
            raise NotImplementedError(
                "MLP with hidden layers (normalization, dropout) comes with "
                "the AllDeepSets port (ROADMAP Queue 1 item 6)"
            )
        self.lin0 = TorchDense(in_dim, out, generator, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin0(x)


class PMA(nn.Module):
    """Pooling by Multihead Attention with a learned seed per head, in the
    global-softmax mode (reference ``src/layers.py:42-199``):

      alpha = leaky_relu(x_K . att_r, 0.2)   per-head seed scores [N, H]
      e     = exp(alpha - max(colmax(alpha), 0))   one shift per head
      agg   = sum over each destination of [x_V * e | e]   (dir_spmm)
      out   = ln1(z + relu(rFF(z))),  z = ln0(agg_vals / agg_den + att_r)

    A global shift per head is exactly the softmax in real arithmetic; it
    makes e a per-source quantity, so the weighting happens on the source
    table before the gather. lin_K enters only through alpha, so it is
    folded into one [in, H] kernel: Wa = W_K @ proj, ba = b_K @ proj.
    """

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, num_layers: int,
                 heads: int, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None, fold_relu: bool = False):
        super().__init__()
        if out_dim != hid_dim or num_layers not in (1, 2):
            raise NotImplementedError(
                "PMA needs out_dim == hid_dim and a 1- or 2-layer rFF"
            )
        H, C = heads, hid_dim // heads
        HC = H * C
        self.heads = heads
        self.dtype, self.fold_relu = dtype, fold_relu
        self.lin_K = TorchDense(in_dim, HC, generator, kernel_init=glorot_uniform)
        self.lin_V = TorchDense(in_dim, HC, generator, kernel_init=glorot_uniform)
        self.att_r = nn.Parameter(xavier_uniform_torch_fans((1, H, C), generator))
        self.ln0 = LNParams(HC)
        self.rFF = MLPParams(HC, out_dim, num_layers, generator)
        self.ln1 = LNParams(out_dim)

    def forward(self, x: torch.Tensor, d: Direction) -> torch.Tensor:
        H = self.heads
        HC = self.att_r.numel()
        C = HC // H
        att_flat = self.att_r.reshape(HC)
        col = torch.arange(HC, device=x.device)[:, None] // C
        blk = col == torch.arange(H, device=x.device)[None, :]
        proj = torch.where(blk, att_flat[:, None], torch.zeros((), device=x.device))
        Wa = self.lin_K.kernel @ proj  # [in_dim, H], f32 parameter math
        ba = self.lin_K.bias @ proj  # [H]
        xc = x.to(self.dtype) if self.dtype is not None else x
        # one GEMM for [values | seed scores]
        Wf = torch.cat([self.lin_V.kernel, Wa], dim=1)
        yf = xc @ Wf.to(xc.dtype)
        x_V = yf[:, :HC] + self.lin_V.bias.to(yf.dtype)
        alpha = F.leaky_relu(yf[:, HC:].float() + ba, NEGATIVE_SLOPE)
        # shift over ALL source rows (N-slot hole rows included on E->V)
        gmax = alpha.detach().amax(dim=0).clamp_min(0.0)
        e = torch.exp(alpha - gmax).to(x_V.dtype)  # <= 1
        # per-head column expansion as a broadcast: its backward is a plain
        # sum over C (repeat_interleave's may scatter with atomics)
        e_cols = e[:, :, None].expand(-1, H, C).reshape(-1, HC)
        parts = [x_V * e_cols, e]
        pad = packed_width(HC, H) - HC - H
        if pad:
            parts.append(x_V.new_zeros(x_V.shape[0], pad))
        agg = dir_spmm(torch.cat(parts, dim=1), d)
        Wrff, brff = self.rFF.stacked()
        return pma_epilogue(agg, att_flat, self.ln0.scale, self.ln0.bias, Wrff,
                            brff, self.ln1.scale, self.ln1.bias, H,
                            self.fold_relu)


class HalfNLHconv(nn.Module):
    """One directed half-layer of multiset message passing (reference
    ``src/layers.py:582-656``); the attention branch (PMA pooling, the
    AllSetTransformer half-layer). The Deep Sets branch comes with the
    AllDeepSets port."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, num_layers: int,
                 heads: int, generator: torch.Generator,
                 dtype: Optional[torch.dtype] = None, fold_relu: bool = False):
        super().__init__()
        self.prop = PMA(in_dim, hid_dim, out_dim, num_layers, heads, generator,
                        dtype=dtype, fold_relu=fold_relu)

    def forward(self, x: torch.Tensor, d: Direction) -> torch.Tensor:
        return self.prop(x, d)
