"""Core neural modules: TorchDense, NormLayer, MLP, PMA (attention
pooling), HalfNLHconv, PReLU, and the zoo's helpers head_expand and
normalize_l2.

Counterpart of ``allset_tpu/nn/modules.py`` for SetGNN (the
AllSetTransformer and AllDeepSets half-layers) and the conv zoo. Parameter
names and shapes follow the JAX package's flax names, so a ``state_dict`` key is
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
runs, and each run's values come out as a single run's would. So do the
f32 dense products on the card that ``ops/cuda_dense.py`` takes (its
kernels read [rows, R, K] and write [rows, R, N] in place). Every other
dense op (the other GEMMs, the plain versions' LayerNorm, score and pack
math) runs run by run on contiguous [rows, F] tensors, so its shapes,
and with them the library's choice of kernel and summation order, do not
depend on R: a run gives the same bits whether it is trained alone or
folded with others.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch import nn

from allset_tpu_torch.graph.incidence import Direction, SegOrder
from allset_tpu_torch.nn.init import (
    Generators,
    glorot_uniform,
    torch_linear_bias,
    torch_linear_kernel,
    xavier_uniform_torch_fans,
)
from allset_tpu_torch.ops import cuda_dense
from allset_tpu_torch.ops.cuda_ln import layer_norm
from allset_tpu_torch.ops.cuda_pack import NEGATIVE_SLOPE, pma_pack
from allset_tpu_torch.ops.cuda_pma import DEN_FLOOR, pma_epilogue, pma_epilogue_runs
from allset_tpu_torch.ops.exchange import dir_gather, dir_reduce, dir_spmm
from allset_tpu_torch.ops.segment import gather_rows, segment_softmax
from allset_tpu_torch.parallel.sharded import (ShardedDirection, sharded_epilogue_active,
                                               sharded_pma_epilogue)


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


def row_scale(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [rows, ...] times a per-row scale s [rows], in x's dtype."""
    return x * s.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


def fold(x: torch.Tensor, R: Optional[int]) -> torch.Tensor:
    """The table a sparse op takes: x [rows, F] alone, or with R runs x
    [rows, R, F] (a shared [rows, F] repeated per run) as [rows, R*F]."""
    if R is None:
        return x
    if x.dim() == 2:
        x = x[:, None].expand(-1, R, -1)
    return x.reshape(x.shape[0], -1)


def unfold(y: torch.Tensor, R: Optional[int]) -> torch.Tensor:
    """[rows, R*F] -> [rows, R, F] with runs; y itself without."""
    return y if R is None else y.view(y.shape[0], R, -1)


def head_expand(a: torch.Tensor, C: int) -> torch.Tensor:
    """Per-head column expansion ``repeat(a, C)`` along the last axis: a
    [..., H] -> [..., H*C] (JAX ``_head_expand``, exact either way)."""
    return a.repeat_interleave(C, dim=-1)


def normalize_l2(x: torch.Tensor) -> torch.Tensor:
    """Row-normalize along the last axis (reference
    ``src/models.py:590-596``); zero rows stay zero."""
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    scale = torch.where(norm > 0, 1.0 / norm, torch.zeros((), dtype=norm.dtype,
                                                           device=norm.device))
    return x * scale


class PReLU(nn.Module):
    """flax ``nn.PReLU``: one learned slope 'negative_slope' (a scalar,
    [R] with runs), initialised to 0.01; x where x >= 0, else slope * x."""

    def __init__(self, lead: tuple = ()):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.full(lead, 0.01))

    @staticmethod
    def _prelu(x, a):
        return torch.where(x >= 0, x, a.to(x.dtype) * x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.negative_slope
        return self._prelu(x, a) if a.dim() == 0 else runs_apply(self._prelu, x, a)


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
    activation dtype, then the bias is added in that dtype. An f32 product
    on the card that ``cuda_dense.route`` admits runs on its kernels."""

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
        if self.dtype is None and cuda_dense.route(x, self.kernel):
            return cuda_dense.runs_dense(x, self.kernel, self.bias if self.use_bias else None)
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


BN_MOMENTUM = 0.9  # flax momentum == 1 - torch momentum
BN_EPS = 1e-5


def _bn_normalize(x, mu, var, scale, bias, out_dtype):
    """flax's _normalize: (x - mu) * (rsqrt(var + eps) * scale) + bias in
    f32, then ``out_dtype``."""
    return ((x.float() - mu) * (torch.rsqrt(var + BN_EPS) * scale) + bias).to(out_dtype)


class _BatchNormTrain(torch.autograd.Function):
    """BatchNorm's training forward and its backward, run by run on
    contiguous [rows, F] tables: (y, batch mean, batch variance). The
    statistics are flax's: f32, the fast variance E[x^2] - E[x]^2 clamped
    at 0. Only x and the [(R,) F] vectors are kept for the backward, which
    recomputes xhat = (x - mu) * rstd and takes

        dx = rstd * (gs - mean(gs) - xhat * mean(gs * xhat)),  gs = g * scale

    (the derivative of either variance form), dscale = sum(g * xhat),
    dbias = sum(g); a shared x sums its runs' dx."""

    @staticmethod
    def forward(ctx, x, scale, bias, out_dtype):
        runs = scale.dim() == 2
        xs = per_run(x, scale.shape[0]) if runs else [x]
        sb = zip(scale.unbind(0), bias.unbind(0)) if runs else [(scale, bias)]
        ys, mus, vars_ = [], [], []
        for xr, (s, b) in zip(xs, sb):
            x32 = xr.float()
            mu = x32.mean(dim=0)
            var = ((x32 * x32).mean(dim=0) - mu * mu).clamp_min(0.0)
            ys.append(_bn_normalize(xr, mu, var, s, b, out_dtype))
            mus.append(mu)
            vars_.append(var)
        if runs:
            y, mu, var = torch.stack(ys, dim=1), torch.stack(mus), torch.stack(vars_)
        else:
            y, mu, var = ys[0], mus[0], vars_[0]
        ctx.save_for_backward(x, scale, mu, var)
        ctx.mark_non_differentiable(mu, var)
        return y, mu, var

    @staticmethod
    def backward(ctx, gy, _gmu, _gvar):
        x, scale, mu, var = ctx.saved_tensors
        runs = scale.dim() == 2
        R = scale.shape[0] if runs else 1
        xs = per_run(x, R) if runs else [x]
        gys = [t.contiguous() for t in gy.unbind(1)] if runs else [gy]
        params = zip(scale.unbind(0), mu.unbind(0), var.unbind(0)) if runs else [(scale, mu, var)]
        dxs, dss, dbs = [], [], []
        for xr, g, (s, m, v) in zip(xs, gys, params):
            rstd = torch.rsqrt(v + BN_EPS)
            xhat = (xr.float() - m) * rstd
            g = g.float()
            gs = g * s
            dxs.append(rstd * (gs - gs.mean(dim=0) - xhat * (gs * xhat).mean(dim=0)))
            dss.append((g * xhat).sum(dim=0))
            dbs.append(g.sum(dim=0))
        if not runs:
            return dxs[0].to(x.dtype), dss[0], dbs[0], None
        dx = torch.stack(dxs, dim=1) if x.dim() == 3 else sum(dxs[1:], dxs[0])
        return dx.to(x.dtype), torch.stack(dss), torch.stack(dbs), None


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over the rows:
    parameters 'scale' (ones) and 'bias' (zeros), running statistics in
    the buffers 'mean' (zeros) and 'var' (ones), the flax names.

    Training (``train=True``) normalises with the batch statistics,
    reduced in f32 with the fast variance E[x^2] - E[x]^2 clamped at 0
    (:class:`_BatchNormTrain`), and updates the running ones as flax does:
    ``ra = 0.9 ra + 0.1 batch``, the variance biased (torch's BatchNorm1d
    differs on both: its momentum convention and an unbiased running
    variance). Evaluation normalises with the running statistics. The
    output is in ``dtype``, or in x's dtype promoted with f32 when
    ``dtype`` is None, as flax promotes with its f32 parameters.

    With R runs the parameters and statistics are [R, F]: run r's
    statistics come from run r's rows of x [rows, R, F], each run reduced
    on its own contiguous [rows, F] table, so a run gives the same bits
    folded or alone; a shared x [rows, F] gives every run the same
    statistics. ``frozen`` (set by :func:`frozen_batch_stats`) keeps the
    running statistics as they are: a recomputed forward must not update
    them twice."""

    def __init__(self, dim: int, lead: tuple = (), dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(lead + (dim,)))
        self.bias = nn.Parameter(torch.zeros(lead + (dim,)))
        self.register_buffer("mean", torch.zeros(lead + (dim,)))
        self.register_buffer("var", torch.ones(lead + (dim,)))
        self.dtype, self.frozen = dtype, False

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        out_dtype = self.dtype or torch.promote_types(x.dtype, torch.float32)
        if train:
            y, mu, var = _BatchNormTrain.apply(x, self.scale, self.bias, out_dtype)
            if not self.frozen:
                with torch.no_grad():
                    self.mean.copy_(BN_MOMENTUM * self.mean + (1 - BN_MOMENTUM) * mu)
                    self.var.copy_(BN_MOMENTUM * self.var + (1 - BN_MOMENTUM) * var)
            return y
        stats = (self.mean, self.var, self.scale, self.bias)
        if self.scale.dim() == 1:
            return _bn_normalize(x, *stats, out_dtype)
        return runs_apply(lambda xr, *p: _bn_normalize(xr, *p, out_dtype), x, *stats)


@contextlib.contextmanager
def frozen_batch_stats(model: nn.Module):
    """Inside: every BatchNorm of ``model`` leaves its running statistics
    as they are (a recomputed forward under remat)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    was = [m.frozen for m in bns]
    for m in bns:
        m.frozen = True
    try:
        yield
    finally:
        for m, f in zip(bns, was):
            m.frozen = f


class NormLayer(nn.Module):
    """'ln' (flax LayerNorm: f32 statistics, fast variance, 'scale' and
    'bias'; the B12/B13 kernels, ``ops/cuda_ln.py``), 'bn' (flax
    BatchNorm with batch statistics, :class:`BatchNorm`, plain PyTorch as
    the JAX package computes it with flax, outside any Pallas kernel) or
    'None' (identity, no parameters). With R runs the parameters are [R,
    F] and x is [rows, R, F] (or a shared [rows, F]); one B12/B13 launch
    serves every run."""

    def __init__(self, kind: str, dim: int, lead: tuple = (),
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if kind not in ("bn", "ln", "None", "none", None):
            raise ValueError(f"unknown normalization {kind!r}")
        self.kind, self.dtype = kind, dtype
        if kind == "ln":  # the flax submodules' automatic names
            self.LayerNorm_0 = LNParams(dim, lead)
        elif kind == "bn":
            self.BatchNorm_0 = BatchNorm(dim, lead, dtype)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if self.kind == "bn":
            return self.BatchNorm_0(x, train)
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
            x = self.input_norm(x, train)
        for i in range(self.num_layers - 1):
            x = torch.relu(getattr(self, f"lin{i}")(x))
            x = getattr(self, f"norm{i}")(x, train)
            x = dropout(x, self.p, train, generator)
        return getattr(self, f"lin{self.num_layers - 1}")(x)


class PMA(nn.Module):
    """Pooling by Multihead Attention with a learned seed per head
    (reference ``src/layers.py:42-199``):

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

    With R runs the GEMM runs run by run and the outputs are stacked
    [rows, R, WP] (in f32 on the card: one ``cuda_dense.runs_dense`` over
    the runs' stacked kernels, where it admits the product); K4/K5 fold
    them to [rows, R*WP] for the exchange and the fused epilogue
    (K2R/K3R); the output is [M, R, out].

    On an edge-partitioned Direction (``parallel/sharded.py``) whose
    shapes the epilogue's kernels take (``sharded_epilogue_active``, the
    same shape predicate) the epilogue runs per shard inside the exchange
    (``sharded_pma_epilogue``); on any other the sharded exchange feeds the
    epilogue above, as in the JAX module (``allset_tpu/nn/modules.py:308-320,
    391-404``).

    The JAX module's parity options (``allset_tpu/nn/modules.py:241-247``)
    take its routes: neither uses the score+pack, and both compose the
    epilogue (LayerNorms through B12/B13, the rFF as GEMMs) in place of
    K2/K3. ``softmax_mode='segment'`` is the reference's per-segment-max
    softmax: the packed [x_V | alpha] rows gathered by source
    (``dir_gather``), ``segment_softmax`` by destination and the weighted
    rows summed (``dir_reduce``); it needs an unsplit Direction.
    ``return_attention`` makes the forward return (out, attn), attn[i, h]
    entry i's softmax weight in its destination segment ([nnz_pad, H], 0
    at padding in segment mode; with runs [nnz_pad, R, H]). With runs
    these options go run by run.
    """

    def __init__(self, in_dim: int, hid_dim: int, out_dim: int, num_layers: int,
                 heads: int, generator: Generators,
                 dtype: Optional[torch.dtype] = None, fold_relu: bool = False,
                 softmax_mode: str = "global", return_attention: bool = False):
        super().__init__()
        if out_dim != hid_dim or num_layers < 1:
            raise NotImplementedError("PMA needs out_dim == hid_dim and an rFF of 1 or more layers")
        if softmax_mode not in ("global", "segment"):
            raise ValueError(f"unknown softmax_mode {softmax_mode!r}")
        H, C = heads, hid_dim // heads
        HC = H * C
        self.heads = heads
        self.dtype, self.fold_relu = dtype, fold_relu
        self.softmax_mode, self.return_attention = softmax_mode, return_attention
        self.lin_K = TorchDense(in_dim, HC, generator, kernel_init=glorot_uniform)
        self.lin_V = TorchDense(in_dim, HC, generator, kernel_init=glorot_uniform)
        self.att_r = nn.Parameter(xavier_uniform_torch_fans((1, H, C), generator))
        self.ln0 = LNParams(HC, _lead(generator))
        self.rFF = MLPParams(HC, out_dim, num_layers, generator)
        self.ln1 = LNParams(out_dim, _lead(generator))
        self.runs = runs_of(generator)

    def _fused(self, WK, bK, WV, att_flat):
        """One run's [lin_V | Wa] kernel, padded with zero columns to the
        packed width, and ba -> (Wf [in_dim, WP], ba [H]), f32 parameter
        math."""
        H = self.heads
        HC = att_flat.shape[0]
        C = HC // H
        col = torch.arange(HC, device=WK.device)[:, None] // C
        blk = col == torch.arange(H, device=WK.device)[None, :]
        proj = torch.where(blk, att_flat[:, None], torch.zeros((), device=WK.device))
        Wa = WK @ proj  # [in_dim, H]
        ba = bK @ proj  # [H]
        Wf = torch.cat([WV, Wa, WV.new_zeros(WV.shape[0], packed_width(HC, H) - HC - H)],
                       dim=1)
        return Wf, ba

    def _product(self, x, Wf):
        """One run's [lin_V | Wa] GEMM -> yf [N, WP] without biases."""
        xc = x.to(self.dtype) if self.dtype is not None else x
        return xc @ Wf.to(xc.dtype)

    def _scores(self, x, WK, bK, WV, att_flat):
        """One run's [lin_V | Wa] GEMM -> (yf [N, WP] without biases, ba
        [H])."""
        Wf, ba = self._fused(WK, bK, WV, att_flat)
        return self._product(x, Wf), ba

    def _params(self):
        """Every parameter, with the leading [R] axis where there are runs;
        the rFF's as lists of (kernel, bias) layer by layer."""
        HC = self.lin_V.kernel.shape[-1]
        lins = [getattr(self.rFF, f"lin{i}") for i in range(self.rFF.num_layers)]
        return dict(WK=self.lin_K.kernel, bK=self.lin_K.bias, WV=self.lin_V.kernel,
                    bV=self.lin_V.bias, att=self.att_r.reshape(self.att_r.shape[:-3] + (HC,)),
                    g0=self.ln0.scale, b0=self.ln0.bias, g1=self.ln1.scale, b1=self.ln1.bias,
                    Ws=[m.kernel for m in lins], bs=[m.bias for m in lins])

    def _composed(self, x, d: Direction, p: dict):
        """One run through the JAX module's composed route -> (out [M, out],
        attn [nnz_pad, H])."""
        H = self.heads
        HC = p["att"].shape[0]
        C = HC // H
        yf, ba = self._scores(x, p["WK"], p["bK"], p["WV"], p["att"])
        x_V = yf[:, :HC] + p["bV"].to(yf.dtype)
        alpha = torch.nn.functional.leaky_relu(yf[:, HC:HC + H].float() + ba, NEGATIVE_SLOPE)
        if self.softmax_mode == "segment":
            if d.sl_mode != "none":
                raise ValueError("PMA softmax_mode='segment' needs an unsplit Direction")
            g = dir_gather(torch.cat([x_V, alpha.to(x_V.dtype)], dim=1), d)
            x_j, a_j = g[:, :HC], g[:, HC:].float()
            mask = torch.arange(g.shape[0], device=g.device) < d.nnz
            attn = segment_softmax(a_j, d.dst, d.num_dst, mask=mask,
                                   order=SegOrder(None, d.indptr, d.plan))
            out = dir_reduce(x_j * head_expand(attn.to(x_j.dtype), C), d, "add")
        else:
            gmax = alpha.detach().amax(dim=0).clamp_min(0.0)
            e = torch.exp(alpha - gmax).to(x_V.dtype)
            pad = x_V.new_zeros(x_V.shape[0], packed_width(HC, H) - HC - H)
            agg = dir_spmm(torch.cat([x_V * head_expand(e, C), e, pad], dim=1), d)
            denom = agg[:, HC:HC + H].clamp_min(DEN_FLOOR)
            out = agg[:, :HC] / head_expand(denom, C)
            attn = gather_rows(e, d.src).float() / gather_rows(denom, d.dst).float()
        out = layer_norm(out + p["att"].to(out.dtype), p["g0"], p["b0"], self.dtype)
        h = out
        for i, (k, b) in enumerate(zip(p["Ws"], p["bs"])):  # the rFF, dropout 0, no norm
            if self.dtype is not None:
                h, k = h.to(self.dtype), k.to(self.dtype)
            h = h @ k
            h = h + b.to(h.dtype)
            if i < len(p["Ws"]) - 1:
                h = torch.relu(h)
        out = layer_norm(out + torch.relu(h).to(out.dtype), p["g1"], p["b1"], self.dtype)
        return (torch.relu(out) if self.fold_relu else out), attn

    def forward(self, x: torch.Tensor, d: Direction):
        R = self.runs
        if self.softmax_mode == "segment" or self.return_attention:
            if isinstance(d, ShardedDirection):
                raise NotImplementedError("PMA's softmax_mode='segment' and return_attention "
                                          "need a single-device Direction")
            p = self._params()
            if R is None:
                out, attn = self._composed(x, d, p)
            else:
                per = [self._composed(x_r, d, {k: ([t[r] for t in v] if isinstance(v, list)
                                                   else v[r]) for k, v in p.items()})
                       for r, x_r in enumerate(per_run(x, R))]
                out = torch.stack([o for o, _ in per], dim=1)
                attn = torch.stack([a for _, a in per], dim=1)
            return (out, attn) if self.return_attention else out
        HC = self.lin_V.kernel.shape[-1]
        att_flat = self.att_r.reshape(self.att_r.shape[:-3] + (HC,))  # [(R,) HC]
        params = (self.lin_K.kernel, self.lin_K.bias, self.lin_V.kernel, att_flat)
        Wrff, brff = self.rFF.stacked()
        epi = (att_flat, self.ln0.scale, self.ln0.bias, Wrff, brff, self.ln1.scale,
               self.ln1.bias, self.heads, self.fold_relu)
        # an edge-partitioned Direction whose shapes the epilogue's kernels
        # take runs the epilogue per shard, inside the exchange
        sharded = isinstance(d, ShardedDirection) and sharded_epilogue_active(
            d, HC, self.heads, Wrff.shape[-3], self.ln1.scale.shape[-1], R or 1)
        if R is None:
            Wf, ba = self._fused(*params)
            if self.dtype is None and cuda_dense.route(x, Wf):
                yf = cuda_dense.runs_dense(x, Wf)
            else:
                yf = self._product(x, Wf)
            w = pma_pack(yf, self.lin_V.bias, ba, self.heads)
            if sharded:
                return sharded_pma_epilogue(w, d, *epi)
            return pma_epilogue(dir_spmm(w, d), *epi)
        fused = [self._fused(*p) for p in zip(*(t.unbind(0) for t in params))]
        Wf = torch.stack([f[0] for f in fused])  # [R, in_dim, WP]
        ba = torch.stack([f[1] for f in fused])  # [R, H]
        if self.dtype is None and cuda_dense.route(x, Wf):
            yf = cuda_dense.runs_dense(x, Wf)  # [N, R, WP]
        else:
            yf = torch.stack([self._product(x_r, f[0]) for x_r, f in zip(per_run(x, R), fused)],
                             dim=1)
        w = pma_pack(yf, self.lin_V.bias, ba, self.heads)  # runs folded: [N, R*WP]
        if sharded:
            out = sharded_pma_epilogue(w, d, *epi, runs=True)
            return out.view(out.shape[0], R, -1)
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
