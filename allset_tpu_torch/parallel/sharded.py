"""Edge-partitioned exchange on torch.distributed.

Counterpart of ``allset_tpu/parallel/sharded.py`` (the shard_map
exchange):

  * the destination id space is cut into ``D`` row blocks; shard d owns
    the incidence entries whose dst falls in its block. Entries are
    dst-sorted, so a shard's entries are one contiguous slice: segments
    never straddle shards and the forward needs no input communication.
    Each shard gathers from the replicated source table and sums into its
    own rows (the gather inside K1, ``ops/cuda_segment.py``), and ONE
    all-gather reassembles the [D * rows_per_shard, F] blocks;
  * the backward gives each shard its rows of the cotangent, sums them by
    src (the gather inside K1 over the shard's src-sorted CSR) into a
    partial ``dw`` [num_src, F], and ONE all-reduce adds the partials.
    Under LearnMask the SDDMM ``dnorm`` is scattered to canonical entry
    positions and added by one more all-reduce. No all-to-all anywhere;
  * the self-loop slots (the N-slot layout) stay dense and replicated;
  * cuts are segment-aware: where equal row blocks would skew the
    per-shard entry counts past ``balance_threshold``, the cuts move to
    the segment boundaries nearest the entry-balanced positions, shards
    own variable row ranges padded to one block size, a reassembly gather
    (``reasm``, B10) puts the stacked blocks back in row order, and the
    backward distributes the cotangent with ``dist_idx`` (B10), whose
    padded rows carry the sentinel ``num_dst`` that reads an appended zero
    row;
  * PMA's epilogue runs per shard inside the exchange
    (:func:`sharded_pma_epilogue`): K2 on the shard's aggregate, then one
    all-gather of the narrow [rows, HC] output; K3 per shard, one
    all-reduce of the parameter gradients, ``dw`` over the existing
    all-reduce, and for 'add' one all-gather of the self-loop rows'
    gradient.

The host build (:meth:`ShardedExchange.build`) is the JAX package's numpy
code, array for array: every [D, ...] array equals the JAX one. The port
adds per shard the CSR of each entry order by row (``indptr`` over the
shard's rows, ``src_indptr`` over the source rows), whose every 256th
offset is JAX's ``block_indptr``/``src_block_indptr``, and K1's chunk
plans over them. :meth:`ShardedExchange.shard` places the shards a
:class:`~allset_tpu_torch.parallel.distributed.Comm` runs (a rank's own
one, or all of them in one process) and the replicated arrays on its
device; every collective goes through that Comm.

Ids clamp as ``jnp.take(mode="clip")`` does: the gather inside K1 and B10
read ``w[clamp(id)]``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from allset_tpu_torch.graph import native
from allset_tpu_torch.graph.incidence import Incidence, SegPlan, chunk_plan
from allset_tpu_torch.ops import cuda_pma
from allset_tpu_torch.ops.cuda_gather import gather_fwd
from allset_tpu_torch.ops.cuda_segment import gather_segment_sum, scale_rows
from allset_tpu_torch.parallel.distributed import Comm

Tensor = torch.Tensor

# the JAX incidence's segment-kernel block and chunk (kernel_s_blk,
# kernel_chunk), which size the row blocks and pad the shard entries
S_BLK = 256
CHUNK = 512

def pad_for_kernel(n: int, chunk: int = CHUNK) -> int:
    """nnz padding rule: multiple of chunk plus one spare chunk."""
    return ((n + chunk - 1) // chunk + 1) * chunk


@dataclasses.dataclass(frozen=True)
class Shard:
    """One shard's entries on its device, the valid ones only (``nnz``):
    execution (dst-sorted) order ``src``, ``dst_local``, ``norm``,
    ``perm_canon`` with the CSR ``indptr`` over the shard's rows and its
    chunk ``plan``; src-sorted order ``dst_srcsort_local``,
    ``norm_srcsort``, ``perm_canon_srcsort`` with ``src_indptr`` over the
    source rows and ``src_plan``; ``dist_idx`` the global row of each of
    its rows (balanced cuts only)."""

    index: int
    nnz: int
    src: Tensor
    dst_local: Tensor
    norm: Tensor
    perm_canon: Tensor
    indptr: Tensor
    plan: SegPlan
    dst_srcsort_local: Tensor
    norm_srcsort: Tensor
    perm_canon_srcsort: Tensor
    src_indptr: Tensor
    src_plan: SegPlan
    dist_idx: Optional[Tensor]


@dataclasses.dataclass(frozen=True)
class ShardedDirection:
    """One direction of the exchange, partitioned into D shards: the JAX
    ShardedDirection's arrays (leading axis D, on the host) and, once
    placed (:meth:`ShardedExchange.shard`), ``comm`` and the ``local``
    Shards it runs, with the replicated arrays on its device."""

    src: Tensor  # i32[D, nnz_pad] global gather row ids (dst-sorted order)
    dst_local: Tensor  # i32[D, nnz_pad] dst - row_cut (rows_per_shard at pad)
    norm: Tensor  # f32[D, nnz_pad]
    block_indptr: Tensor  # i32[D, rows_per_shard // s_blk + 1]
    src_sorted: Tensor  # i32[D, nnz_pad] src ids sorted within shard
    dst_srcsort_local: Tensor  # i32[D, nnz_pad] dst_local in src-sorted order
    norm_srcsort: Tensor  # f32[D, nnz_pad]
    src_block_indptr: Tensor  # i32[D, num_src_padded // s_blk + 1]
    perm_canon: Tensor  # i32[D, nnz_pad] canonical entry position (exec order)
    perm_canon_srcsort: Tensor  # i32[D, nnz_pad] the same in src-sorted order
    nnz_pad_canon: int
    sl_mask: Optional[Tensor]  # f32[num_nodes] (replicated)
    sl_norm: Optional[Tensor]  # f32[num_nodes]
    dst_count: Optional[Tensor]  # f32[num_dst_total] full degrees ('mean')
    num_src: int
    num_src_padded: int
    num_dst: int
    num_dst_padded: int
    rows_per_shard: int
    s_blk: int
    chunk: int
    sl_mode: str
    num_dst_total: int
    shard_nnz: tuple  # valid entries of each shard
    reasm: Optional[Tensor] = None  # i32[num_dst] global row -> stacked row
    dist_idx: Optional[Tensor] = None  # i32[D, rows_per_shard] shard row -> global row
    # a traced per-entry norm in canonical order (LearnMask), set with
    # dataclasses.replace by the model; it overrides the baked norms
    norm_canon: Optional[Tensor] = None
    comm: Optional[Comm] = None
    local: tuple = ()

    @property
    def num_shards(self) -> int:
        return self.src.shape[0]

    @property
    def device(self) -> torch.device:
        if self.comm is None:
            raise ValueError("the ShardedDirection is not placed: call ShardedExchange.shard")
        return self.comm.device

    @property
    def shard_rows(self) -> tuple:
        """Destination rows each shard owns (its block of rows_per_shard
        rows holds them, then padding)."""
        if self.dist_idx is not None:
            return tuple(int(n) for n in (self.dist_idx < self.num_dst).sum(1))
        rows = self.rows_per_shard
        return tuple(min(rows, max(0, self.num_dst - d * rows)) for d in range(self.num_shards))

    @property
    def rows_sl(self) -> int:
        """Self-loop slot rows per shard of the fused epilogue ('append')."""
        return -(-self.num_src // self.num_shards) if self.sl_mode == "append" else 0


def shard_entry_counts(dst: np.ndarray, num_dst: int, D: int, s_blk: int = S_BLK,
                       balance_threshold: float = 1.25):
    """Per-shard entry counts for equal row blocks vs segment-aware
    balanced cuts on a dst-sorted entry stream -> (counts_equal,
    counts_balanced, row_cuts_balanced), the balance diagnostic of
    ``data.statistics.dataset_statistics``."""
    rows = -(-num_dst // (D * s_blk)) * s_blk
    cuts_eq = np.searchsorted(dst, np.arange(D + 1) * rows)
    bal = _balanced_cuts(dst, num_dst, D, s_blk, balance_threshold)
    if bal is None:
        return np.diff(cuts_eq), np.diff(cuts_eq), None
    cuts_e, row_cuts, _ = bal
    return np.diff(cuts_eq), np.diff(cuts_e), row_cuts


def _balanced_cuts(dst: np.ndarray, num_dst: int, D: int, s_blk: int, threshold: float):
    """Entry-balanced, segment-aligned dst row cuts: None where equal row
    blocks are within ``threshold`` of perfect balance, else (entry_cuts
    [D+1], row_cuts [D+1], rows_uniform). Each cut re-targets an equal
    share of the remaining entries over the remaining shards and snaps to
    the nearest segment boundary at or after the previous cut."""
    nnz = len(dst)
    if nnz == 0 or D <= 1:
        return None
    rows_eq = -(-num_dst // (D * s_blk)) * s_blk
    cuts_eq = np.searchsorted(dst, np.arange(D + 1) * rows_eq)
    if np.diff(cuts_eq).max() <= threshold * nnz / D:
        return None
    starts = np.flatnonzero(np.diff(dst)) + 1  # entry positions where a segment begins
    starts = np.concatenate([[0], starts, [nnz]]).astype(np.int64)
    cuts_e = np.zeros(D + 1, np.int64)
    cuts_e[D] = nnz
    c = 0
    for d in range(1, D):
        target = c + (nnz - c) / (D - d + 1)
        i = np.searchsorted(starts, target)
        lo = starts[max(i - 1, 0)]
        hi = starts[min(i, len(starts) - 1)]
        pick = lo if (lo >= c and target - lo <= hi - target) else hi
        c = max(c, int(pick))
        cuts_e[d] = c
    row_cuts = np.empty(D + 1, np.int64)
    row_cuts[0] = 0
    row_cuts[D] = num_dst
    for d in range(1, D):
        c = cuts_e[d]
        row_cuts[d] = int(dst[c]) if c < nnz else num_dst
    row_cuts = np.maximum.accumulate(row_cuts)
    rows_uniform = -(-int(np.diff(row_cuts).max()) // s_blk) * s_blk
    return cuts_e, row_cuts, max(rows_uniform, s_blk)


def _build_one(dst, src, norm, canon_pos, nnz_pad_canon, num_src, num_dst, D, s_blk, chunk,
               balance_threshold=1.25):
    """Host-side partition of one direction (entries dst-sorted);
    ``canon_pos[i]``: entry i's position in the source incidence's
    canonical order. Returns (arrays, rows_per_shard, num_dst_padded,
    num_src_padded, valid entries per shard); 'reasm' and 'dist_idx' only
    on balanced cuts."""
    nnz = len(dst)
    bal = _balanced_cuts(dst, num_dst, D, s_blk, balance_threshold)
    if bal is None:
        rows = -(-num_dst // (D * s_blk)) * s_blk  # rows/shard, s_blk-aligned
        cuts = np.searchsorted(dst, np.arange(D + 1) * rows).astype(np.int64)
        row_cuts = np.minimum(np.arange(D + 1) * rows, num_dst)
        reasm = dist_idx = None
    else:
        cuts, row_cuts, rows = bal
        reasm = np.empty(max(num_dst, 1), np.int32)
        dist_idx = np.empty((D, rows), np.int32)
        for d in range(D):
            a, b = int(row_cuts[d]), int(row_cuts[d + 1])
            reasm[a:b] = d * rows + np.arange(b - a, dtype=np.int32)
            # padded block rows carry the sentinel num_dst, which reads an
            # appended zero row: the fused epilogue's parameter gradients
            # must see no duplicated cotangent on a shard's pad tail
            idx = a + np.arange(rows)
            dist_idx[d] = np.where(idx < b, idx, num_dst).astype(np.int32)
    num_dst_padded = rows * D
    max_e = int((cuts[1:] - cuts[:-1]).max()) if nnz else 0
    nnz_pad = pad_for_kernel(max(max_e, 1), chunk)
    num_src_padded = -(-num_src // s_blk) * s_blk

    S = dict(
        src=np.full((D, nnz_pad), num_src, np.int32),
        dst_local=np.full((D, nnz_pad), rows, np.int32),
        norm=np.zeros((D, nnz_pad), np.float32),
        block_indptr=np.zeros((D, rows // s_blk + 1), np.int32),
        src_sorted=np.full((D, nnz_pad), num_src, np.int32),
        dst_srcsort_local=np.full((D, nnz_pad), rows, np.int32),
        norm_srcsort=np.zeros((D, nnz_pad), np.float32),
        src_block_indptr=np.zeros((D, num_src_padded // s_blk + 1), np.int32),
        perm_canon=np.full((D, nnz_pad), nnz_pad_canon, np.int32),
        perm_canon_srcsort=np.full((D, nnz_pad), nnz_pad_canon, np.int32),
    )
    for d in range(D):
        lo, hi = int(cuts[d]), int(cuts[d + 1])
        k = hi - lo
        sdst = dst[lo:hi] - int(row_cuts[d])
        ssrc = src[lo:hi]
        snorm = norm[lo:hi]
        spos = canon_pos[lo:hi]
        S["src"][d, :k] = ssrc
        S["dst_local"][d, :k] = sdst
        S["norm"][d, :k] = snorm
        S["perm_canon"][d, :k] = spos
        S["block_indptr"][d] = np.searchsorted(sdst, np.arange(0, rows + s_blk, s_blk))
        order = native.stable_argsort(ssrc, num_src + 1)
        S["src_sorted"][d, :k] = ssrc[order]
        S["dst_srcsort_local"][d, :k] = sdst[order]
        S["norm_srcsort"][d, :k] = snorm[order]
        S["perm_canon_srcsort"][d, :k] = spos[order]
        S["src_block_indptr"][d] = np.searchsorted(
            ssrc[order], np.arange(0, num_src_padded + s_blk, s_blk))
    if reasm is not None:
        S["reasm"] = reasm
        S["dist_idx"] = dist_idx
    counts = tuple(int(c) for c in np.diff(cuts))
    return S, rows, num_dst_padded, num_src_padded, counts


def _place_shard(sd: ShardedDirection, d: int, device) -> Shard:
    """Shard d's valid entries, its row CSRs and their chunk plans (built
    on the host) on ``device``."""
    k, rows = sd.shard_nnz[d], sd.rows_per_shard
    sdst = sd.dst_local[d, :k].numpy()
    ssrc = sd.src_sorted[d, :k].numpy()
    indptr = np.searchsorted(sdst, np.arange(rows + 1)).astype(np.int32)
    src_indptr = np.searchsorted(ssrc, np.arange(sd.num_src + 1)).astype(np.int32)
    # the row CSRs refine the JAX block offsets
    assert np.array_equal(indptr[::sd.s_blk], sd.block_indptr[d].numpy())
    assert np.array_equal(src_indptr[::sd.s_blk],
                          sd.src_block_indptr[d].numpy()[: -(-(sd.num_src + 1) // sd.s_blk)])

    def put(t, dtype=None):
        return t.to(device=device, dtype=dtype)

    return Shard(
        index=d, nnz=k,
        src=put(sd.src[d, :k]), dst_local=put(sd.dst_local[d, :k], torch.int64),
        norm=put(sd.norm[d, :k]), perm_canon=put(sd.perm_canon[d, :k], torch.int64),
        indptr=put(torch.from_numpy(indptr)), plan=chunk_plan(indptr).to(device),
        dst_srcsort_local=put(sd.dst_srcsort_local[d, :k]),
        norm_srcsort=put(sd.norm_srcsort[d, :k]),
        perm_canon_srcsort=put(sd.perm_canon_srcsort[d, :k], torch.int64),
        src_indptr=put(torch.from_numpy(src_indptr)), src_plan=chunk_plan(src_indptr).to(device),
        dist_idx=None if sd.dist_idx is None else put(sd.dist_idx[d]),
    )


def _place(sd: ShardedDirection, comm: Comm) -> ShardedDirection:
    if comm.num_shards != sd.num_shards:
        raise ValueError(f"the exchange has {sd.num_shards} shards, the Comm "
                         f"{comm.num_shards}")
    dev = comm.device
    rep = {f: (None if getattr(sd, f) is None else getattr(sd, f).to(dev))
           for f in ("sl_mask", "sl_norm", "dst_count", "reasm")}
    return dataclasses.replace(sd, comm=comm, **rep,
                               local=tuple(_place_shard(sd, d, dev) for d in comm.shards))


@dataclasses.dataclass(frozen=True)
class ShardedExchange:
    """Both directions of the exchange, ready for ``dir_spmm`` dispatch."""

    v2e: ShardedDirection
    e2v: ShardedDirection

    @classmethod
    def build(cls, inc: Incidence, num_shards: int, split: Optional[bool] = None,
              balance_threshold: float = 1.25) -> "ShardedExchange":
        """Partition ``inc`` (its real sub-incidence when the self-loop
        split is available; on any device) into ``num_shards`` shards, on
        the host. ``split=False``
        takes the full incidence, which traced per-entry norms (LearnMask)
        need: their canonical indexing covers the self-loop entries too.
        ``balance_threshold``: the largest per-shard entry skew tolerated
        before the cuts move to entry-balanced segment boundaries (``inf``
        keeps equal row blocks)."""
        D = int(num_shards)
        if split is None:
            split = inc.real is not None
        core = inc.real if split else inc
        s_blk, chunk = S_BLK, CHUNK
        n = core.node[: core.nnz].cpu().numpy().astype(np.int32)
        e = core.edge[: core.nnz].cpu().numpy().astype(np.int32)
        w = core.norm[: core.nnz].cpu().numpy()
        canon = np.arange(core.nnz, dtype=np.int32)
        npadc = core.nnz_padded

        def direction(S, rows, dpad, spad, counts, **kw):
            arrays = {k: torch.from_numpy(v) for k, v in S.items()}
            return ShardedDirection(**arrays, nnz_pad_canon=npadc, num_dst_padded=dpad,
                                    num_src_padded=spad, rows_per_shard=rows, s_blk=s_blk,
                                    chunk=chunk, shard_nnz=counts,
                                    sl_mask=inc.sl_mask.cpu() if split else None,
                                    sl_norm=inc.sl_norm_full.cpu() if split else None, **kw)

        ecount = np.bincount(e, minlength=core.num_edges).astype(np.float32)
        ncount = np.bincount(n, minlength=core.num_nodes).astype(np.float32)
        if split:
            ecount_total = np.concatenate([ecount, inc.sl_mask.cpu().numpy()])
            ncount_total = inc.node_count.cpu().numpy()
        else:
            ecount_total, ncount_total = ecount, ncount

        # V2E: entries already edge-sorted
        dv = direction(*_build_one(e, n, w, canon, npadc, core.num_nodes, core.num_edges, D,
                                   s_blk, chunk, balance_threshold),
                       dst_count=torch.from_numpy(ecount_total), num_src=core.num_nodes,
                       num_dst=core.num_edges, sl_mode="append" if split else "none",
                       num_dst_total=(core.num_edges + inc.num_nodes) if split
                       else core.num_edges)
        # E2V: node-sorted entry order
        order = native.stable_argsort(n, core.num_nodes + 1)
        de = direction(*_build_one(n[order], e[order], w[order], canon[order], npadc,
                                   core.num_edges, core.num_nodes, D, s_blk, chunk,
                                   balance_threshold),
                       dst_count=torch.from_numpy(ncount_total), num_src=core.num_edges,
                       num_dst=core.num_nodes, sl_mode="add" if split else "none",
                       num_dst_total=core.num_nodes)
        return cls(v2e=dv, e2v=de)

    def shard(self, comm: Comm) -> "ShardedExchange":
        """The shards ``comm`` runs (a rank's own, or every one in one
        process) and the replicated arrays, on its device."""
        return ShardedExchange(v2e=_place(self.v2e, comm), e2v=_place(self.e2v, comm))


# --- the sharded spmm ---------------------------------------------------------
#
# norm_mode: 0 = unweighted (PMA), 1 = the baked static norms, 2 = a traced
# norm in canonical entry order (LearnMask), [nnz_pad] or [R, nnz_pad]


def _traced_norm(norm_c: Tensor, perm: Tensor) -> Tensor:
    """A shard's per-entry weights from the canonical-order norm (clamped
    as the JAX take is)."""
    return norm_c[..., perm.clamp_max(norm_c.shape[-1] - 1)]


def _entry_norm(sh: Shard, norm_mode: int, norm_c, srcsort: bool):
    if norm_mode == 1:
        return sh.norm_srcsort if srcsort else sh.norm
    if norm_mode == 2:
        return _traced_norm(norm_c, sh.perm_canon_srcsort if srcsort else sh.perm_canon)
    return None


def _reassemble(stacked: Tensor, sd: ShardedDirection) -> Tensor:
    """Stacked shard blocks [D * rows, F] -> global rows [num_dst, F]:
    the ``reasm`` gather (B10) on balanced cuts, a slice otherwise."""
    if sd.reasm is not None:
        return gather_fwd(stacked, sd.reasm)
    return stacked[: sd.num_dst]


def _cotangent_ext(g: Tensor, sd: ShardedDirection) -> Tensor:
    """g's first num_dst rows with one zero row appended, the row that
    ``dist_idx``'s sentinel reads (on equal row blocks g itself: the
    shards' slices never read past num_dst)."""
    if sd.dist_idx is None:
        return g
    return torch.cat([g[: sd.num_dst], g.new_zeros(1, g.shape[1])])


def _own_rows(sd: ShardedDirection, sh: Shard) -> Tensor:
    """The global row of each of the shard's rows; pad rows past num_dst
    (the sentinel num_dst on balanced cuts)."""
    if sh.dist_idx is not None:
        return sh.dist_idx.long()
    rows = sd.rows_per_shard
    return torch.arange(sh.index * rows, (sh.index + 1) * rows, device=sd.device)


def _shard_cotangent(gext: Tensor, sd: ShardedDirection, sh: Shard) -> Tensor:
    """The shard's rows of the cotangent [rows, F] from the sentinel-
    extended one: B10 by ``dist_idx`` on balanced cuts, a zero-padded
    slice otherwise."""
    if sh.dist_idx is not None:
        return gather_fwd(gext, sh.dist_idx)
    rows, num_dst = sd.rows_per_shard, sd.num_dst
    lo = min(sh.index * rows, num_dst)
    hi = min(lo + rows, num_dst)
    piece = gext[lo:hi]
    if hi - lo < rows:
        piece = torch.cat([piece, gext.new_zeros(rows - (hi - lo), gext.shape[1])])
    return piece


def _sddmm(gs: Tensor, w: Tensor, sh: Shard, norm_c: Tensor) -> Tensor:
    """dnorm_i = g[dst_i] . w[src_i] in f32 for the shard's entries,
    scattered to their canonical positions -> norm_c's shape."""
    k = sh.nnz
    prod = gs.index_select(0, sh.dst_local).float() * w.index_select(0, sh.src).float()
    dnorm = torch.zeros_like(norm_c, dtype=torch.float32)
    if norm_c.dim() == 2:
        dnorm.index_add_(1, sh.perm_canon, prod.view(k, norm_c.shape[0], -1).sum(-1).t())
    else:
        dnorm.index_add_(0, sh.perm_canon, prod.sum(-1))
    return dnorm


class _ShardedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, norm_c, sd: ShardedDirection, norm_mode: int, norm_grad: bool):
        ctx.sd, ctx.norm_mode, ctx.norm_grad, ctx.dtype = sd, norm_mode, norm_grad, w.dtype
        ctx.save_for_backward(w if norm_grad else None, norm_c)
        parts = [gather_segment_sum(w, sh.src, sh.indptr, sd.rows_per_shard, sh.plan,
                                    _entry_norm(sh, norm_mode, norm_c, False))
                 for sh in sd.local]
        return _reassemble(sd.comm.all_gather(parts), sd)

    @staticmethod
    def backward(ctx, g):
        sd, norm_mode = ctx.sd, ctx.norm_mode
        w, norm_c = ctx.saved_tensors
        gext = _cotangent_ext(g.to(ctx.dtype), sd)
        parts, dnorms = [], []
        for sh in sd.local:
            gs = _shard_cotangent(gext, sd, sh)
            parts.append(gather_segment_sum(gs, sh.dst_srcsort_local, sh.src_indptr, sd.num_src,
                                            sh.src_plan, _entry_norm(sh, norm_mode, norm_c,
                                                                     True)))
            if ctx.norm_grad:
                dnorms.append(_sddmm(gs, w, sh, norm_c))
        dw = sd.comm.all_reduce(parts).to(ctx.dtype)
        dnorm = sd.comm.all_reduce(dnorms) if ctx.norm_grad else None
        return dw, dnorm, None, None, None


def _local_max(w: Tensor, norm_c, sd: ShardedDirection, sh: Shard, norm_mode: int) -> Tensor:
    """Per-row max over the shard's entries (0 for an empty row) -> [rows, F]."""
    msgs = w.index_select(0, sh.src)
    n = _entry_norm(sh, norm_mode, norm_c, False)
    if n is not None:
        msgs = scale_rows(msgs, n)
    idx = sh.dst_local[:, None].expand(-1, msgs.shape[1])
    # start from -inf: the backward splits a tie with the start value too
    out = torch.full((sd.rows_per_shard, msgs.shape[1]), float("-inf"), dtype=msgs.dtype,
                     device=msgs.device)
    out = out.scatter_reduce(0, idx, msgs, "amax", include_self=False)
    return torch.where(torch.isfinite(out), out, torch.zeros((), dtype=out.dtype,
                                                             device=out.device))


class _ShardedMax(torch.autograd.Function):
    """Per-shard max (disjoint row blocks: the forward's one collective is
    the reassembly all-gather); the backward differentiates each shard's
    body on its rows of the cotangent and all-reduces the partial
    gradients."""

    @staticmethod
    def forward(ctx, w, norm_c, sd: ShardedDirection, norm_mode: int, norm_grad: bool):
        ctx.sd, ctx.norm_mode, ctx.norm_grad = sd, norm_mode, norm_grad
        ctx.save_for_backward(w, norm_c)
        parts = [_local_max(w, norm_c, sd, sh, norm_mode) for sh in sd.local]
        return _reassemble(sd.comm.all_gather(parts), sd)

    @staticmethod
    def backward(ctx, g):
        sd = ctx.sd
        w, norm_c = ctx.saved_tensors
        gext = _cotangent_ext(g, sd)
        dws, dns = [], []
        with torch.enable_grad():
            w_ = w.detach().requires_grad_()
            n_ = norm_c.detach().requires_grad_(ctx.norm_grad)
            for sh in sd.local:
                out = _local_max(w_, n_, sd, sh, ctx.norm_mode)
                grads = torch.autograd.grad(out, [w_, n_] if ctx.norm_grad else [w_],
                                            _shard_cotangent(gext, sd, sh).to(out.dtype))
                dws.append(grads[0])
                if ctx.norm_grad:
                    dns.append(grads[1])
        dw = sd.comm.all_reduce(dws).to(w.dtype)
        dnorm = sd.comm.all_reduce(dns) if ctx.norm_grad else None
        return dw, dnorm, None, None, None


def sharded_segment_max(w: Tensor, sd: ShardedDirection, norm_mode: int, norm_c: Tensor,
                        norm_grad: bool = False) -> Tensor:
    """Per-destination max, edge-partitioned, in w's dtype (0 for an empty
    segment)."""
    return _ShardedMax.apply(w, norm_c, sd, norm_mode, norm_grad)


def sharded_spmm(w: Tensor, sd: ShardedDirection, use_norm: bool = True, reduce: str = "add",
                 norm: Optional[Tensor] = None, norm_grad: bool = False) -> Tensor:
    """out[m] = sum_{i: dst_i = m} norm_i * w[src_i], edge-partitioned.

    ``use_norm=False`` without ``norm``: unweighted (the PMA exchange);
    ``use_norm=True``: the norms baked into the shards; an explicit
    ``norm`` (canonical entry order of the partitioned incidence, [nnz_pad]
    or [R, nnz_pad]; build with split=False so self-loop entries are
    covered) is gathered per shard, and ``norm_grad`` adds the SDDMM pass
    whose gradient comes back all-reduced in canonical order. 'max' runs
    a per-shard max; 'mean' is composed by the caller (the divide by
    ``dst_count``). The self-loop slots ('append', 'add') are replicated
    dense rows, as ``ops.exchange.dir_spmm`` adds them."""
    norm_mode = 2 if norm is not None else (1 if use_norm else 0)
    norm_c = norm if norm is not None else torch.zeros(max(sd.nnz_pad_canon, 1),
                                                       device=w.device)
    grad = norm_grad and norm_mode == 2
    if norm_mode == 2 and not norm_grad:
        norm_c = norm_c.detach()
    w_core = w[: sd.num_src] if sd.sl_mode == "add" else w
    if reduce == "max":
        core = sharded_segment_max(w_core, sd, norm_mode, norm_c, grad)
    elif reduce == "add":
        core = _ShardedSpmm.apply(w_core, norm_c, sd, norm_mode, grad)
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    if sd.sl_mode == "append":
        rows = w * sd.sl_norm[:, None].to(w.dtype) if norm_mode else w
        return torch.cat([core, rows.to(core.dtype)])
    if sd.sl_mode == "add":
        scale = sd.sl_norm if norm_mode else sd.sl_mask
        rows = w[sd.num_src:] * scale[:, None].to(w.dtype)
        if reduce == "max":  # holes must not clamp a negative max to 0
            return torch.where(sd.sl_mask[:, None] > 0, torch.maximum(core, rows), core)
        return core + rows
    return core


# --- fused sharded spmm + PMA epilogue ----------------------------------------
#
# In the replicated composition (sharded_spmm -> pma_epilogue) every rank
# all-gathers the wide [rows, WP] aggregate and runs the row-local epilogue
# on all of it. The epilogue commutes with the reassembly all-gather, so
# here it runs per shard on the shard's own rows (the self-loop rows split
# evenly across the shards) and only the narrow [rows, HC] output is
# all-gathered; the backward adds one all-reduce of the parameter
# gradients, and 'add' one all-gather of the self-loop rows' gradient.


def sharded_epilogue_active(sd: ShardedDirection, hid_dim: int, heads: int, num_layers: int,
                            out_dim: int, runs: int = 1) -> bool:
    """Does PMA take :func:`sharded_pma_epilogue` on ``sd``? Where the
    single-device epilogue takes its kernels: the same shape predicate,
    ``ops/cuda_pma.py::epilogue_supported``, with out_dim == hid_dim, on
    the placed group's device (K2/K3 on the card, their plain versions on
    the CPU)."""
    from allset_tpu_torch.nn.modules import packed_width

    if sd.comm is None or sd.comm.device.type not in ("cuda", "cpu"):
        return False
    return out_dim == hid_dim and cuda_pma.epilogue_supported(
        hid_dim, heads, num_layers, packed_width(hid_dim, heads), runs)


class _ShardedEpilogue(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, seed, g0, b0, Wrff, brff, g1, b1, sd: ShardedDirection, H: int,
                relu: bool, runs: bool):
        fwd = cuda_pma.epilogue_fwd_runs if runs else cuda_pma.epilogue_fwd
        rows, sl, rows_sl = sd.rows_per_shard, sd.sl_mode, sd.rows_sl
        w_core = w[: sd.num_src] if sl == "add" else w
        ys, aggs = [], []
        for sh in sd.local:
            agg = gather_segment_sum(w_core, sh.src, sh.indptr, rows, sh.plan)
            if sl == "add":
                # the self-loop rows land on the shard's own rows, before
                # the epilogue; pad rows add clamped rows that the
                # reassembly drops (their cotangent is zero)
                idc = _own_rows(sd, sh).clamp_max(sd.num_dst - 1)
                contrib = gather_fwd(w[sd.num_src:], idc).float() * sd.sl_mask[idc][:, None]
                agg = agg + contrib.to(agg.dtype)
            elif sl == "append":
                ids = torch.arange(sh.index * rows_sl, (sh.index + 1) * rows_sl,
                                   device=w.device).clamp_max(sd.num_src - 1)
                agg = torch.cat([agg, gather_fwd(w, ids).to(agg.dtype)])
            ys.append(fwd(agg, seed, g0, b0, Wrff, brff, g1, b1, H, relu))
            aggs.append(agg)
        y_all = sd.comm.all_gather(ys)
        ctx.save_for_backward(seed, g0, b0, Wrff, brff, g1, b1, *aggs)
        ctx.sd, ctx.H, ctx.relu, ctx.runs, ctx.dtype = sd, H, relu, runs, w.dtype
        D = sd.num_shards
        ya = y_all.view(D, rows + rows_sl, -1)
        out = _reassemble(ya[:, :rows].reshape(D * rows, -1), sd)
        if sl == "append":
            out = torch.cat([out, ya[:, rows:].reshape(D * rows_sl, -1)[: sd.num_src]])
        return out

    @staticmethod
    def backward(ctx, g):
        seed, g0, b0, Wrff, brff, g1, b1, *aggs = ctx.saved_tensors
        sd, H, relu = ctx.sd, ctx.H, ctx.relu
        bwd = cuda_pma.epilogue_bwd_runs if ctx.runs else cuda_pma.epilogue_bwd
        rows, sl, rows_sl = sd.rows_per_shard, sd.sl_mode, sd.rows_sl
        g = g.to(ctx.dtype)
        gext = _cotangent_ext(g, sd)
        if sl == "append":
            gslext = torch.cat([g[sd.num_dst:], g.new_zeros(1, g.shape[1])])
        parts, params, dsls = [], [], []
        for sh, agg in zip(sd.local, aggs):
            gy = _shard_cotangent(gext, sd, sh)
            if sl == "append":
                ids = torch.arange(sh.index * rows_sl, (sh.index + 1) * rows_sl,
                                   device=g.device).clamp_max(sd.num_src)
                gy = torch.cat([gy, gather_fwd(gslext, ids)])
            dagg, dW, ds = bwd(agg, gy, seed, g0, b0, Wrff, brff, g1, b1, H, relu)
            params.append(torch.cat([dW.reshape(-1), ds.reshape(-1)]))
            part = gather_segment_sum(dagg[:rows], sh.dst_srcsort_local, sh.src_indptr,
                                      sd.num_src, sh.src_plan)
            if sl == "append":
                # the self-loop slots are source-row-aligned: this shard's
                # slice of their gradient rides the dw all-reduce
                lo = sh.index * rows_sl
                n = max(0, min(rows_sl, sd.num_src - lo))
                part = part.clone()
                part[lo:lo + n] += dagg[rows:rows + n].to(part.dtype)
            elif sl == "add":
                idc = _own_rows(sd, sh).clamp_max(sd.num_dst - 1)
                dsls.append((dagg[:rows].float() * sd.sl_mask[idc][:, None]).to(part.dtype))
            parts.append(part)
        flat = sd.comm.all_reduce(params)
        dW = flat[: Wrff.numel()].view(Wrff.shape)
        ds = flat[Wrff.numel():].view(ds.shape).movedim(-2, 0)  # [8, (R,) HC]
        dw = sd.comm.all_reduce(parts).to(ctx.dtype)
        if sl == "add":
            dw = torch.cat([dw, _reassemble(sd.comm.all_gather(dsls), sd).to(ctx.dtype)])
        L = Wrff.shape[-3]
        return (dw, ds[0].to(seed.dtype), ds[1], ds[2], dW, ds[5:5 + L].movedim(0, -2), ds[3],
                ds[4], None, None, None, None)


def sharded_pma_epilogue(w: Tensor, sd: ShardedDirection, seed, g0, b0, Wrff, brff, g1, b1,
                         heads: int, relu: bool = False, runs: bool = False) -> Tensor:
    """The edge-partitioned PMA aggregation and fused epilogue in one op:
    ``pma_epilogue(dir_spmm(w, sd))`` (``pma_epilogue_runs`` with
    ``runs``: w [rows, R*WP], parameters with a leading [R] axis), with the
    epilogue run per shard (K2 forward, K3 backward) before the
    reassembly all-gather. Returns the replicated [num_dst_total, (R*)HC]
    output, the self-loop rows appended in 'append' mode as dir_spmm lays
    them out."""
    return _ShardedEpilogue.apply(w, seed, g0, b0, Wrff, brff, g1, b1, sd, heads, relu, runs)


def sharded_comm_stats(shex: ShardedExchange, width: int, itemsize: int = 4,
                       learn_mask: bool = False, epilogue_hc: Optional[int] = None,
                       epilogue_layers: int = 2, runs: int = 1) -> dict:
    """The collectives of one forward and backward over both directions
    and their payload bytes, as ``distributed.collectives`` and
    ``collective_bytes`` count them (the JAX ``sharded_comm_stats``, with
    the all-reduces in f32 and the d_sl all-gathers counted):

      * forward: one reassembly all-gather per direction, [D *
        rows_per_shard, width] (``reassembly_fwd``, ``fwd_bytes``);
      * backward: one all-reduce per direction of ``dw`` [num_src, width]
        and, with ``learn_mask``, one of ``dnorm`` [nnz_pad_canon]
        (``psums_bwd``, ``bwd_bytes``).

    With ``epilogue_hc`` (the fused :func:`sharded_pma_epilogue`; ``width``
    the packed width, ``runs`` the runs folded into it) the forward
    all-gather moves the [*, HC] output (the self-loop slot blocks too in
    'append' mode), the backward adds one all-reduce of the parameter
    gradients per direction ([L, HC, HC] + [8, HC] f32 a run), and 'add'
    one all-gather of d_sl [D * rows, width] (``allgathers_bwd``,
    ``bwd_ag_bytes``)."""
    out = {"reassembly_fwd": 0, "psums_bwd": 0, "allgathers_bwd": 0, "fwd_bytes": 0,
           "bwd_bytes": 0, "bwd_ag_bytes": 0}
    for sd in (shex.v2e, shex.e2v):
        rows_tot = sd.rows_per_shard * sd.num_shards
        out["reassembly_fwd"] += 1
        if epilogue_hc is not None:
            rows_tot += sd.rows_sl * sd.num_shards
            out["fwd_bytes"] += rows_tot * epilogue_hc * runs * itemsize
            out["psums_bwd"] += 1
            out["bwd_bytes"] += (epilogue_layers * epilogue_hc * epilogue_hc
                                 + 8 * epilogue_hc) * 4 * runs
            if sd.sl_mode == "add":
                out["allgathers_bwd"] += 1
                out["bwd_ag_bytes"] += sd.rows_per_shard * sd.num_shards * width * itemsize
        else:
            out["fwd_bytes"] += rows_tot * width * itemsize
        out["psums_bwd"] += 1
        out["bwd_bytes"] += sd.num_src * width * 4
        if learn_mask:
            out["psums_bwd"] += 1
            out["bwd_bytes"] += sd.nnz_pad_canon * 4 * runs
    return out
