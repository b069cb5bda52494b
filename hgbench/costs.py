"""The yardstick's arithmetic: the card's peaks, each kernel's bytes and
operations at a cell's shapes, and the model's matrix products.

Frozen copies, at commit b978a993e545, of ``chip_smoke.py``'s ``HBM``,
``PEAK``, ``epi_cost``, ``dw_ops``, ``seg_cost``, ``gather_cost``,
``spmm_cost``, ``ln_cost``, ``k3_small_partials`` and ``k3_part_costs``,
of K4's and K5's costs in its ``time_pack``, and of the chunk plans of
``allset_tpu_torch/ops/cuda_pma.py`` they read (``wg_chunk_plan``,
``dw_chunk_plan``, ``cluster_bwd_entries`` and their constants). A cost
is (bytes, [(operations, peak key)]): every input byte read once and
every output byte written once, the operations the algorithm needs.

The per-epoch functions below count the launches of one epoch of a job
(its training forward, backward and evaluation forward, for every group
of folded runs) at the shapes the graph and the configuration give: the
exchange's self-loop split (the hyperedge-side table is the real
hyperedges plus one row per node), f32 activations.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

HBM = 3.35e12  # H100 SXM bytes/s (NVIDIA data sheet)
PEAK = {"bf16": 989e12, "f32x3": 495e12 / 3, "f32": 67e12}  # FLOP/s
TF32 = 495e12  # dense TF32 FLOP/s: the highest rate the tensor cores take f32 operands at

# ops/cuda_pma.py
DW_PARTIALS = 64
WG_WIDTHS = (256,)
CLUSTER_BWD_WIDTHS = (384, 512)
CLUSTER_BWD_ENTRIES = 66
WG_BLOCKS = 132
WG_TILE = 64

Cost = Tuple[float, List[Tuple[float, str]]]


def bound_s(costs: Sequence[Cost]) -> float:
    """Seconds one kernel needs at least for these launches: the larger of
    their bytes at HBM and their operations at their peaks."""
    tb = sum(c[0] for c in costs) / HBM
    to = sum(n / PEAK[k] for c in costs for n, k in c[1])
    return max(tb, to)


def _item(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


def dw_ops(prod, item):
    return (3 * prod, "bf16") if item == 2 else (prod, "f32x3")


def epi_cost(M, HC, WP, L, dtype, bwd, R=1) -> Cost:
    """K2 (bwd=False) or K3 on M rows and R runs."""
    item = _item(dtype)
    rows = M * ((2 * WP + HC) if bwd else (WP + HC)) * item
    params = L * HC * HC * (4 + (2 if item == 2 else 0)) + (6 + L) * HC * 4
    fwd = 2 * L * HC * HC * M * R
    ops = [(fwd, "bf16" if item == 2 else "f32x3")]
    if bwd:
        ops += [(fwd, "f32x3"), dw_ops(fwd, item)]
    return R * (rows + params), ops


def seg_cost(nnz, nseg, W, dtype) -> Cost:
    item = _item(dtype)
    return (nnz + nseg) * W * item + 4 * (nseg + 1), [(nnz * W, "f32")]


def gather_cost(rows, n, W, item, id_item=8) -> Cost:
    return (rows + n) * W * item + n * id_item, []


def spmm_cost(table_rows, k, nseg, W, dtype, id_item=8) -> Cost:
    """The gather inside K1: the table read once, the k ids, every segment
    row written once, indptr; one f32 add per gathered element."""
    item = _item(dtype)
    return (gather_cost(table_rows, 0, W, item)[0] + k * id_item
            + seg_cost(0, nseg, W, dtype)[0]), [(k * W, "f32")]


def ln_cost(rows, F, xdt, ydt, bwd, need_dx=True, R=1, shared=False) -> Cost:
    """B12 (x in, y out, gamma and beta) or B13 (g and x in, dx out where
    asked, gamma in, dgamma and dbeta out). ``shared``: one [rows, F]
    input serves every run, read once."""
    xi, yi = _item(xdt), _item(ydt)
    n = rows * R * F
    if bwd:
        return n * (yi + xi + (xi if need_dx else 0)) + 3 * 4 * R * F, [(12 * n, "f32")]
    x_bytes = rows * F * xi if shared else n * xi
    return x_bytes + n * yi + 2 * 4 * R * F, [(8 * n, "f32")]


def dw_chunk_plan(rows: int):
    chunk_rows = -(-(-(-max(rows, 1) // DW_PARTIALS)) // 32) * 32
    return chunk_rows, max(1, -(-rows // chunk_rows))


def wg_chunk_plan(M: int):
    Mp = -(-max(M, 1) // 8) * 8
    return (Mp, *dw_chunk_plan(Mp))


def k3_small_partials(M, HC):
    if HC in CLUSTER_BWD_WIDTHS:
        return 4 * max(1, min(-(-M // WG_TILE), CLUSTER_BWD_ENTRIES))
    return min(-(-M // WG_TILE), WG_BLOCKS)


def k3_part_costs(M, HC, WP, L, dtype, R=1) -> Tuple[Cost, Cost, Cost]:
    """K3a, K3b and K3c on the warpgroup and cluster routes."""
    item = _item(dtype)
    Mp, _, nch = wg_chunk_plan(M)
    G = k3_small_partials(M, HC)
    tables = L * HC * Mp * (item + 4)
    small = G * 8 * HC * 4
    partials = nch * L * HC * HC * 4
    params = L * HC * HC * (4 + (2 if item == 2 else 0)) + (6 + L) * HC * 4
    prod = 2 * L * HC * HC * M * R
    rows = ((M * (2 * WP + HC) * item + params + tables + small) * R,
            [(prod, "bf16" if item == 2 else "f32x3"), (prod, "f32x3")])
    dw = ((tables + partials) * R, [dw_ops(prod, item)])
    red = ((partials + small + L * HC * HC * 4 + 8 * HC * 4) * R,
           [((nch * L * HC * HC + G * 8 * HC) * R, "f32")])
    return rows, dw, red


def k4_cost(rows, H, R, dtype) -> Cost:
    """K4 (the scores' global max): the H score columns read."""
    return R * (rows * H * _item(dtype) + 4 * H), [(R * rows * H * 2, "f32")]


def k5_cost(rows, HC, H, WP, R, dtype) -> Cost:
    """K5 (the packed table): yf read, w written."""
    return R * (2 * rows * WP * _item(dtype) + 4 * (HC + 2 * H)), [(R * rows * (HC + H) * 4,
                                                                     "f32")]


def packed_width(HC: int, H: int) -> int:
    return -(-(HC + H) // 8) * 8


# --- a cell's shapes ---


@dataclasses.dataclass(frozen=True)
class Shapes:
    """What the costs read: the graph's nodes N, real hyperedges E, real
    entries nnz, self-loops n_sl, features F and classes; the model's
    widths; the runs of each group."""

    N: int
    E: int
    nnz: int
    n_sl: int
    F: int
    classes: int
    method: str
    layers: int
    mlp_layers: int
    HC: int
    heads: int
    cls_layers: int
    cls_hidden: int
    groups: Tuple[int, ...]
    dtype: str = "float32"

    @property
    def edge_rows(self) -> int:
        """The hyperedge side of the split exchange: real hyperedges, then
        one self-loop row per node."""
        return self.E + self.N

    @property
    def width(self) -> int:
        """One run's width in the exchange."""
        if self.method == "AllSetTransformer":
            return packed_width(self.HC, self.heads)
        return self.HC


def pma_epoch(s: Shapes) -> Dict[str, List[Cost]]:
    """Each epilogue kernel's launches in one epoch: K2R twice per
    half-layer (train and eval), K3R's parts once, K4 and K5 twice, on
    the rows each half-layer takes in and gives out."""
    if s.method != "AllSetTransformer":
        return {}
    HC, H, L, dt = s.HC, s.heads, s.mlp_layers, s.dtype
    WP = packed_width(HC, H)
    out: Dict[str, List[Cost]] = {k: [] for k in ("K2R", "K3a", "K3b", "K3c", "K3", "K4", "K5")}
    for R in s.groups:
        for _ in range(s.layers):
            for rows_in, M in ((s.N, s.edge_rows), (s.edge_rows, s.N)):
                out["K2R"] += [epi_cost(M, HC, WP, L, dt, False, R)] * 2
                if HC in WG_WIDTHS + CLUSTER_BWD_WIDTHS:
                    for k, c in zip(("K3a", "K3b", "K3c"), k3_part_costs(M, HC, WP, L, dt, R)):
                        out[k].append(c)
                else:
                    out["K3"].append(epi_cost(M, HC, WP, L, dt, True, R))
                out["K4"] += [k4_cost(rows_in, H, R, dt)] * 2
                out["K5"] += [k5_cost(rows_in, HC, H, WP, R, dt)] * 2
    return {k: v for k, v in out.items() if v}


def exchange_epoch(s: Shapes) -> Dict[str, List[Cost]]:
    """The gather inside K1 in one epoch: per half-layer its forward twice
    (train and eval) and its transpose once, over the real entries."""
    out: List[Cost] = []
    for R in s.groups:
        W = R * s.width
        for _ in range(s.layers):
            for src_rows, dst_rows in ((s.N, s.E), (s.E, s.N)):
                out += [spmm_cost(src_rows, s.nnz, dst_rows, W, s.dtype)] * 2
                out.append(spmm_cost(dst_rows, s.nnz, src_rows, W, s.dtype))
    return {"K1": out}


def ln_epoch(s: Shapes) -> Dict[str, List[Cost]]:
    """B12 and B13 of AllDeepSets in one epoch: per half-layer the input
    norms and hidden norms of f_enc and f_dec, each forward twice (train
    and eval) and backward once; the features' own norm needs no dx, and
    in the evaluation forward its input is shared by the runs."""
    if s.method != "AllDeepSets":
        return {}
    dt, hid = s.dtype, s.HC
    fwd: List[Cost] = []
    bwd: List[Cost] = []
    for R in s.groups:
        for i in range(s.layers):
            for rows_in, rows_out, in_dim, features in (
                    (s.N, s.edge_rows, s.F if i == 0 else hid, i == 0),
                    (s.edge_rows, s.N, hid, False)):
                # (rows, width, the features' own norm)
                norms = ([(rows_in, in_dim, features)] + [(rows_in, hid, False)]
                         * (s.mlp_layers - 1) + [(rows_out, hid, False)] * s.mlp_layers)
                for rows, F, feat in norms:
                    fwd.append(ln_cost(rows, F, dt, dt, False, R=R))
                    fwd.append(ln_cost(rows, F, dt, dt, False, R=R, shared=feat))
                    bwd.append(ln_cost(rows, F, dt, dt, True, need_dx=not feat, R=R))
    return {"B12": fwd, "B13": bwd}


def layer_bound_s(costs: Dict[str, List[Cost]]) -> float:
    """A layer's least seconds: each kernel's bound over its launches,
    summed over its kernels."""
    return sum(bound_s(v) for v in costs.values())


def _mlp_flops(rows, in_dim, hidden, out, layers) -> float:
    dims = [in_dim] + [hidden] * (layers - 1) + [out]
    return sum(2.0 * rows * a * b for a, b in zip(dims[:-1], dims[1:]))


def forward_flops(s: Shapes) -> float:
    """Matrix-product FLOPs of one run's forward in the model's math:
    2 m n k for each dense layer, on the model's rows (the hyperedges
    with their self-loops, not the split's empty rows)."""
    hyper = s.E + s.n_sl
    total = 0.0
    for i in range(s.layers):
        in_v = s.F if i == 0 else s.HC
        for rows_in, rows_out, in_dim in ((s.N, hyper, in_v), (hyper, s.N, s.HC)):
            if s.method == "AllSetTransformer":
                total += 2 * 2.0 * rows_in * in_dim * s.HC  # lin_K, lin_V
                total += s.mlp_layers * 2.0 * rows_out * s.HC * s.HC  # the rFF
            else:
                total += _mlp_flops(rows_in, in_dim, s.HC, s.HC, s.mlp_layers)  # f_enc
                total += _mlp_flops(rows_out, s.HC, s.HC, s.HC, s.mlp_layers)  # f_dec
    cls_in = s.HC if s.layers > 0 else s.F
    total += _mlp_flops(s.N, cls_in, s.cls_hidden, s.classes, s.cls_layers)
    return total


def epoch_flops(s: Shapes) -> float:
    """Matrix-product FLOPs of one epoch of all runs: the training forward,
    the backward's two products per product of the forward, and the
    evaluation forward."""
    return 4.0 * sum(s.groups) * forward_flops(s)
