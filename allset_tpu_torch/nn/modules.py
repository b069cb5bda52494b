"""Core neural modules: TorchDense, NormLayer, MLP, PMA (attention
pooling), HalfNLHconv.

Counterpart of ``allset_tpu/nn/modules.py`` for SetGNN (the
AllSetTransformer and AllDeepSets half-layers). Parameter names and
shapes follow the JAX package's flax names, so a ``state_dict`` key is
the flax path joined by dots (see ``utils/jax_bridge.py``); kernels keep
the flax layout ``[in, out]``.
Parameters are float32; ``dtype`` is the activation dtype.

Statistical runs: built with a list of R generators (one per run), every
parameter carries a leading [R] axis, the counterpart of the JAX
package's vmapped parameter tree. Activations are then [rows, R, F]; a
shared input [rows, F] (the features, before any dropout) is accepted
too. The score+pack kernels, the sparse exchange and the fused epilogue
see the runs folded into the width, [rows, R * F], and the LayerNorm
kernels take [rows, R, F] with [R, F] parameters: one launch serves all
runs, and each run's values come out as a single run's would. Every
other dense op (GEMMs, the plain versions' LayerNorm, score and pack
math) runs run by run on contiguous [rows, F] tensors, so its shapes,
and with them the library's choice of kernel and summation order, do not
depend on R: a run gives the same bits whether it is trained alone or
folded with others.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from allset_tpu_torch.graph.incidence import Direction
from allset_tpu_torch.nn.init import (
    Generators,
    glorot_uniform,
    torch_linear_bias,
    torch_linear_kernel,
    xavier_uniform_torch_fans,
)
from allset_tpu_torch.ops.cuda_ln import layer_norm
from allset_tpu_torch.ops.cuda_pack import pma_pack
from allset_tpu_torch.ops.cuda_pma import pma_epilogue, pma_epilogue_runs
from allset_tpu_torch.ops.exchange import dir_spmm


def runs_of(generator: Generators) -> Optional[int]:
    """None for one generator (no runs axis), else the number of runs."""
    return None if isinstance(generator, torch.Generator) else len(generator)


def _lead(generator: Generators) -> tuple:
    R = runs_of(generator)
    return () if R is None else (R,)


def per_run(x: torch.Tensor, R: int) -> list:
    """Run r's input as a contiguous [rows, F] tensor: a slice of x [rows,
    R, F], or a shared x [rows, F] itself."""
    if x.dim() == 2:
        return [x] * R
    return [t.contiguous() for t in x.unbind(1)]


def runs_apply(fn, x: torch.Tensor, *params: torch.Tensor) -> torch.Tensor:
    """fn(x_r, *params[r]) for every run -> stacked [rows, R, out]; params
    carry the leading [R] axis."""
    R = params[0].shape[0]
    per = zip(per_run(x, R), *(p.unbind(0) for p in params))
    return torch.stack([fn(*a) for a in per], dim=1)


def dropout(x: torch.Tensor, p: float, train: bool, generator=None) -> torch.Tensor:
    """Inverted dropout, the identity unless ``train``. With a list of R
    generators (runs), run r's mask is drawn from generator r with the
    shape a single run draws, [N, F]; a shared x [N, F] becomes [N, R, F]."""
    if not train or p == 0.0:
        return x
    if isinstance(generator, (list, tuple)):
        shape = (x.shape[0], x.shape[-1])
        keep = torch.stack([torch.rand(shape, generator=g, device=x.device) >= p
                            for g in generator], dim=1)
        if x.dim() == 2:
            x = x[:, None]
    else:
        keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return x * keep.to(x.dtype) / (1.0 - p)


def packed_width(HC: int, H: int) -> int:
    """Width of PMA's packed exchange table [values HC | denominators H |
    zero pad]: the next multiple of 8, so rows are whole 16-byte vectors."""
    return -(-(HC + H) // 8) * 8


class TorchDense(nn.Module):
    """Dense layer with torch ``nn.Linear`` default init; kernel [in, out],
    and a bias unless ``use_bias=False``.

    bf16 rounding points of the JAX layer: the product is rounded to the
    activation dtype, then the bias is added in that dtype."""

    def __init__(self, fan_in: int, features: int, generator: Generators,
                 kernel_init=torch_linear_kernel,
                 dtype: Optional[torch.dtype] = None, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(kernel_init((fan_in, features), generator))
        if use_bias:
            self.bias = nn.Parameter(torch_linear_bias(fan_in, (features,), generator))
        self.use_bias, self.dtype = use_bias, dtype

    def _dense(self, x, k, b=None):
        if self.dtype is not None:
            x, k = x.to(self.dtype), k.to(self.dtype)
        y = x @ k
        return y if b is None else y + b.to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = (self.kernel, self.bias) if self.use_bias else (self.kernel,)
        if self.kernel.dim() == 2:
            return self._dense(x, *params)
        return runs_apply(self._dense, x, *params)


class LNParams(nn.Module):
    """LayerNorm parameters ('scale', 'bias'), consumed by the fused
    epilogue."""

    def __init__(self, dim: int, lead: tuple = ()):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(lead + (dim,)))
        self.bias = nn.Parameter(torch.zeros(lead + (dim,)))


class MLPParams(nn.Module):
    """Parameters of an equal-width MLP ('lin{i}'), stacked for the fused
    epilogue as [(R,) L, F, F] kernels and [(R,) L, F] biases."""

    def __init__(self, hidden: int, out: int, num_layers: int,
                 generator: Generators):
        super().__init__()
        for i in range(num_layers):
            width = out if i == num_layers - 1 else hidden
            self.add_module(f"lin{i}", TorchDense(hidden, width, generator))
        self.num_layers = num_layers

    def stacked(self):
        lins = [getattr(self, f"lin{i}") for i in range(self.num_layers)]
        at = lins[0].bias.dim() - 1  # 1 with a runs axis
        return (torch.stack([m.kernel for m in lins], dim=at),
                torch.stack([m.bias for m in lins], dim=at))


class NormLayer(nn.Module):
    """'ln' (flax LayerNorm: f32 statistics, fast variance, 'scale' and
    'bias'; the B12/B13 kernels, ``ops/cuda_ln.py``) or 'None' (identity,
    no parameters). 'bn' raises. With R runs the parameters are [R, F] and
    one launch serves every run of x [rows, R, F] (or a shared [rows, F])."""

    def __init__(self, kind: str, dim: int, lead: tuple = (),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kind == "bn":
            raise NotImplementedError(
                "normalization='bn' (batch statistics) is not ported yet "
                "(ROADMAP Queue 1 item 13)"
            )
        if kind not in ("ln", "None", "none", None):
            raise ValueError(f"unknown normalization {kind!r}")
        self.kind, self.dtype = kind, dtype
        if kind == "ln":  # the flax submodule's automatic name
            self.LayerNorm_0 = LNParams(dim, lead)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind != "ln":
            return x
        ln = self.LayerNorm_0
        return layer_norm(x, ln.scale, ln.bias, self.dtype)


class MLP(nn.Module):
    """The reference MLP (``src/layers.py:496-579``): the input norm
    (``input_norm``) or the identity, then for each hidden layer lin ->
    relu -> norm -> dropout, then the final linear. One layer is a linear
    map (TorchDense)."""

    def __init__(self, in_dim: int, hidden: int, out: int, num_layers: int,
                 generator: Generators, dtype: Optional[torch.dtype] = None,
                 normalization: str = "ln", dropout: float = 0.0,
                 input_norm: bool = False):
        super().__init__()
        self.num_layers, self.p = num_layers, dropout
        if input_norm:
            self.input_norm = NormLayer(normalization, in_dim, _lead(generator), dtype=dtype)
        for i in range(num_layers - 1):
            self.add_module(f"lin{i}", TorchDense(in_dim if i == 0 else hidden, hidden,
                                                  generator, dtype=dtype))
            self.add_module(f"norm{i}", NormLayer(normalization, hidden,
                                                  _lead(generator), dtype=dtype))
        last = num_layers - 1
        self.add_module(f"lin{last}", TorchDense(in_dim if last == 0 else hidden, out,
                                                 generator, dtype=dtype))

    def forward(self, x: torch.Tensor, train: bool = False, generator=None) -> torch.Tensor:
        if hasattr(self, "input_norm"):
            x = self.input_norm(x)
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"lin{i}")(x))
            x = getattr(self, f"norm{i}")(x)
            x = dropout(x, self.p, train, generator)
        return getattr(self, f"lin{self.num_layers - 1}")(x)


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
    folded into one [in, H] kernel: Wa = W_K @ proj, ba = b_K @ proj. One
    GEMM gives yf = [x_V | alpha | 0], padded with zero kernel columns to
    the packed width; the score+pack kernels (K4, K5) turn it into the
    packed table [x_V * e | e | 0].

    With R runs the GEMMs run run by run and their outputs are stacked
    [rows, R, WP]; K4/K5 fold them to [rows, R*WP] for the exchange and the
    fused epilogue (K2R/K3R); the output is [M, R, out].
    """

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, num_layers: int,
                 heads: int, generator: Generators,
                 dtype: Optional[torch.dtype] = None, fold_relu: bool = False):
        super().__init__()
        if out_dim != hid_dim or num_layers < 1:
            raise NotImplementedError("PMA needs out_dim == hid_dim and an rFF of 1 or more layers")
        H, C = heads, hid_dim // heads
        HC = H * C
        self.heads = heads
        self.dtype, self.fold_relu = dtype, fold_relu
        self.lin_K = TorchDense(in_dim, HC, generator, kernel_init=glorot_uniform)
        self.lin_V = TorchDense(in_dim, HC, generator, kernel_init=glorot_uniform)
        self.att_r = nn.Parameter(xavier_uniform_torch_fans((1, H, C), generator))
        self.ln0 = LNParams(HC, _lead(generator))
        self.rFF = MLPParams(HC, out_dim, num_layers, generator)
        self.ln1 = LNParams(out_dim, _lead(generator))
        self.runs = runs_of(generator)

    def _scores(self, x, WK, bK, WV, att_flat):
        """One run's [lin_V | Wa] GEMM, padded with zero kernel columns to
        the packed width -> (yf [N, WP] without biases, ba [H])."""
        H = self.heads
        HC = att_flat.shape[0]
        C = HC // H
        col = torch.arange(HC, device=x.device)[:, None] // C
        blk = col == torch.arange(H, device=x.device)[None, :]
        proj = torch.where(blk, att_flat[:, None], torch.zeros((), device=x.device))
        Wa = WK @ proj  # [in_dim, H], f32 parameter math
        ba = bK @ proj  # [H]
        xc = x.to(self.dtype) if self.dtype is not None else x
        Wf = torch.cat([WV, Wa, WV.new_zeros(WV.shape[0], packed_width(HC, H) - HC - H)],
                       dim=1)
        return xc @ Wf.to(xc.dtype), ba

    def forward(self, x: torch.Tensor, d: Direction) -> torch.Tensor:
        R = self.runs
        HC = self.lin_V.kernel.shape[-1]
        att_flat = self.att_r.reshape(self.att_r.shape[:-3] + (HC,))  # [(R,) HC]
        params = (self.lin_K.kernel, self.lin_K.bias, self.lin_V.kernel, att_flat)
        Wrff, brff = self.rFF.stacked()
        epi = (att_flat, self.ln0.scale, self.ln0.bias, Wrff, brff, self.ln1.scale,
               self.ln1.bias, self.heads, self.fold_relu)
        if R is None:
            yf, ba = self._scores(x, *params)
            return pma_epilogue(dir_spmm(pma_pack(yf, self.lin_V.bias, ba, self.heads), d),
                                *epi)
        outs = [self._scores(x_r, *p) for x_r, *p in
                zip(per_run(x, R), *(t.unbind(0) for t in params))]
        yf = torch.stack([o[0] for o in outs], dim=1)  # [N, R, WP]
        ba = torch.stack([o[1] for o in outs])  # [R, H]
        w = pma_pack(yf, self.lin_V.bias, ba, self.heads)  # runs folded: [N, R*WP]
        agg = dir_spmm(w, d)
        return pma_epilogue_runs(agg, *epi).view(agg.shape[0], R, -1)


class HalfNLHconv(nn.Module):
    """One directed half-layer of multiset message passing (reference
    ``src/layers.py:582-656``).

    attention=True  -> PMA pooling (the AllSetTransformer half-layer);
    attention=False -> Deep Sets rho(sum phi(x)): relu(f_enc MLP) ->
                       dropout -> dir_spmm(norm, aggr) -> relu(f_dec MLP).
                       With num_layers == 0 the MLPs are the identity but
                       the relus remain (``src/layers.py:631-634``). The
                       branch ends in a relu, so a folded inter-stage relu
                       would be idempotent: ``fold_relu`` is not read.

    Deep Sets with R runs: the exchange takes the runs folded into the
    width, [rows, R*F], and ``norm`` may carry a runs axis [R, nnz_pad]
    (LearnMask)."""

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, num_layers: int,
                 heads: int, generator: Generators,
                 dtype: Optional[torch.dtype] = None, fold_relu: bool = False,
                 attention: bool = True, dropout: float = 0.5,
                 normalization: str = "ln", input_norm: bool = False,
                 norm_grad: bool = False):
        super().__init__()
        self.attention = attention
        if attention:
            self.prop = PMA(in_dim, hid_dim, out_dim, num_layers, heads, generator,
                            dtype=dtype, fold_relu=fold_relu)
            return
        self.runs, self.p, self.norm_grad = runs_of(generator), dropout, norm_grad
        if num_layers > 0:
            kw = dict(generator=generator, dtype=dtype, normalization=normalization,
                      dropout=dropout, input_norm=input_norm)
            self.f_enc = MLP(in_dim, hid_dim, hid_dim, num_layers, **kw)
            self.f_dec = MLP(hid_dim, hid_dim, out_dim, num_layers, **kw)

    def forward(self, x: torch.Tensor, d: Direction, norm=None, aggr: str = "add",
                train: bool = False, generator=None) -> torch.Tensor:
        """x [rows, F] ([rows, R, F] or a shared [rows, F] with runs); the
        Deep Sets branch reduces with ``norm`` (execution order) by
        ``aggr``."""
        if self.attention:
            return self.prop(x, d)
        R = self.runs
        if hasattr(self, "f_enc"):
            x = self.f_enc(x, train, generator)
        x = dropout(torch.relu(x), self.p, train, generator)
        if R is not None and x.dim() == 2:  # shared by the runs
            x = x[:, None].expand(-1, R, -1)
        rows, F = x.shape[0], x.shape[-1]
        x = dir_spmm(x.reshape(rows, -1), d, norm=norm, reduce=aggr, norm_grad=self.norm_grad)
        if R is not None:
            x = x.view(x.shape[0], R, F)
        if hasattr(self, "f_dec"):
            x = self.f_dec(x, train, generator)
        return torch.relu(x)
