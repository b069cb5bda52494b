"""The Incidence: a padded sparse hypergraph with sorted entry orders.

Counterpart of ``allset_tpu/graph/incidence.py``. The host build is the
same numpy code, so every index array, the padding and the self-loop split
equal the JAX package's element for element; the arrays are then held as
torch tensors and moved to a device with :meth:`Incidence.to`.

  * node ids and hyperedge ids live in separate 0-based id spaces;
  * the nnz axis is padded (same rule as the JAX build); padded entries
    carry ``node == num_nodes``, ``edge == num_edges`` and ``norm == 0``,
    and sort last in both entry orders;
  * entries are canonically sorted by hyperedge (the V->E reduce order),
    and a second node-sorted order serves the E->V reduce and the
    backward of every gather.

What the port adds: a per-segment CSR ``indptr`` (length ``num_dst + 1``)
over the VALID entries only, for the CUDA segment-sum, and that kernel's
chunk plan over it (:func:`chunk_plan`). Because padding sorts to the
tail of both orders, the exchange gathers and reduces only the first
``nnz`` entries and never reads an out-of-range id.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from allset_tpu_torch.graph import native

Tensor = torch.Tensor

# nnz padding of the JAX build (its segment-kernel chunk): kept so that
# every index array compares equal with the reference, element for element
_PAD_CHUNK = 512


def pad_bucket(n: int, bucket: int = 256) -> int:
    """Round nnz up to a bucket."""
    if bucket <= 0:
        return n
    return max(bucket, ((n + bucket - 1) // bucket) * bucket)


def _t(a: np.ndarray) -> Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _ids(a: np.ndarray) -> Tensor:
    return _t(a.astype(np.int64))


def _indptr(sorted_ids: np.ndarray, num_seg: int) -> Tensor:
    """Per-segment CSR offsets over the valid (sorted) entries."""
    return _t(
        np.searchsorted(sorted_ids, np.arange(num_seg + 1)).astype(np.int32)
    )


# K1's chunk plan: at most ROW_BUDGET items (entries and segment ends) per
# chunk; chunk bounds snap to segment starts on a grid of ROW_BUDGET // 2
ROW_BUDGET = 64


@dataclasses.dataclass(frozen=True)
class SegPlan:
    """The sorted segment-sum's split of its work into chunks (see
    ``csrc/segment_sum.cu``): at most ROW_BUDGET rows and ROW_BUDGET + 1
    segments each. It depends on ``indptr`` alone, never on the row width.

    chunks: i32[K, 6] = row0, row1 (the chunk's entries, possibly none),
        seg_lo, seg_hi (the segments it writes: whole ones to the output,
        a segment cut at its start to partial row head_row, one cut only
        at its end to partial row tail_row; -1 where unused);
    cuts: i32[Q, 3] = seg, first partial row, count: segment seg is the
        in-order sum of partial rows [first, first + count), one per chunk
        it touches, in chunk order;
    max_rows, max_segs: the most rows (row1 - row0) and segments (seg_hi -
        seg_lo) of any chunk, which size the gather inside K1's staged ids
        and offsets.
    """

    chunks: Tensor
    cuts: Tensor
    num_partials: int
    max_rows: int
    max_segs: int

    def to(self, device) -> "SegPlan":
        return _to(self, device)


def chunk_plan(indptr, budget: int = ROW_BUDGET) -> SegPlan:
    """Cut the merged sequence of entries and segment ends (segment s's
    rows, then its end: the merge path of ``indptr`` and the entries) into
    chunks of at most ``budget`` items, so that neither a long segment nor
    a run of empty segments is one thread's walk. Chunk bounds are the
    starts of the segments that hold every ``budget // 2``-th item, so most
    chunks hold whole segments; a longer gap (a long segment) is cut every
    ``budget`` items, and a cut on a segment's end item moves past it, so
    that chunk holds ``budget + 1`` items and at most ``budget`` rows. Rows
    past ``indptr[-1]`` are never planned."""
    ip = np.asarray(indptr, dtype=np.int64)
    num_seg = ip.shape[0] - 1
    n = int(ip[-1])
    total = n + num_seg
    if total == 0:  # one empty chunk
        sb = rb = np.zeros(2, np.int64)
    else:
        first_item = ip[:-1] + np.arange(num_seg)  # segment s's first item
        pts = np.arange(0, total, max(budget // 2, 1))
        b = np.unique(np.append(
            first_item[np.searchsorted(first_item, pts, side="right") - 1], total))
        extra = (np.diff(b) - 1) // budget  # cuts inside each long gap
        gap = np.repeat(np.arange(b.shape[0] - 1), extra)
        k = np.arange(gap.shape[0]) - np.repeat(np.cumsum(extra) - extra, extra) + 1
        d = np.concatenate([b, b[gap] + budget * k])
        # item d -> (segment sb, row rb); on the end item of a segment with
        # rows (or past the last), the start of the next segment
        sb = np.searchsorted(first_item, d, side="right") - 1
        off = d - first_item[sb]
        rows = ip[sb + 1] - ip[sb]
        past = (off > rows) | ((off == rows) & (rows > 0))
        sb = sb + past
        rb = np.where(past, ip[sb], ip[np.minimum(sb, num_seg - 1)] + off)
        _, keep = np.unique(sb + rb, return_index=True)
        sb, rb = sb[keep], rb[keep]
    r0, r1 = rb[:-1], rb[1:]
    K = r0.shape[0]
    lo = sb[:-1]  # the first segment the chunk writes
    head = ip[lo] < r0  # lo is cut at the chunk's start
    hi = np.empty(K, np.int64)
    hi[:-1] = lo[1:] + head[1:]
    hi[-1] = num_seg  # the last chunk also writes the trailing empty segments
    head_row = np.full(K, -1, np.int64)
    tail_row = np.full(K, -1, np.int64)
    hc = np.nonzero(head)[0]  # chunk c >= 1 inside a segment begun before it
    new = np.r_[True, lo[hc][1:] != lo[hc][:-1]] if hc.size else np.zeros(0, bool)
    gid = np.cumsum(new) - 1
    first = hc[new]  # per cut segment: its first head-cut chunk
    count = np.bincount(gid, minlength=first.shape[0]) + 1
    row = np.cumsum(count) - count
    head_row[hc] = row[gid] + hc - (first[gid] - 1)
    tail_row[first - 1] = row  # the chunk where the segment starts
    chunks = np.stack([r0, r1, lo, hi, head_row, tail_row], axis=1).astype(np.int32)
    cuts = np.stack([lo[first], row, count], axis=1).astype(np.int32).reshape(-1, 3)
    return SegPlan(chunks=_t(chunks), cuts=_t(cuts), num_partials=int(count.sum()),
                   max_rows=int((r1 - r0).max()), max_segs=int((hi - lo).max()))


@dataclasses.dataclass(frozen=True)
class SegOrder:
    """A sort of segment ids over their valid entries: ``ids[perm[:n]]``
    ascending, n = ``indptr[-1]`` (``perm`` None: the ids are sorted already
    and the valid entries come first), with the CSR ``indptr`` of that
    order and K1's chunk ``plan`` over it. A reduce by the ids is then K1
    over the entries in that order, and the transpose of a gather by the
    ids is the same (``ops/segment.py``)."""

    perm: Optional[Tensor]
    indptr: Tensor
    plan: SegPlan


def _to(obj, device):
    """Move every tensor field of a dataclass (recursively) to ``device``."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, Tensor):
            changes[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _to(v, device)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class Incidence:
    """Padded COO incidence of a hypergraph (see the module docstring).

    node[i], edge[i]: the i-th entry in canonical (edge-sorted) order;
    norm[i]: per-entry weight, 0 at padding; mask[i]: validity.
    """

    node: Tensor  # i64[nnz_pad]
    edge: Tensor  # i64[nnz_pad]
    norm: Tensor  # f32[nnz_pad]
    mask: Tensor  # bool[nnz_pad]
    num_nodes: int
    num_edges: int
    nnz: int
    # CSR over the valid entries: edge_indptr in canonical order,
    # node_indptr in node-sorted order, and K1's chunk plan over each
    edge_indptr: Tensor  # i32[num_edges + 1]
    node_indptr: Tensor  # i32[num_nodes + 1]
    edge_plan: SegPlan
    node_plan: SegPlan
    # node-sorted second order: node_perm maps canonical -> node order (None
    # on an Incidence built without its sorted orders, which HAN's
    # DGLGATConv takes on its reference composition)
    node_perm: Tensor  # i64[nnz_pad]
    inv_node_perm: Tensor  # i64[nnz_pad]
    node_sorted: Tensor  # i64[nnz_pad] = node[node_perm]
    edge_by_node: Tensor  # i64[nnz_pad] = edge[node_perm]
    node_count: Tensor  # f32[num_nodes] valid entries per node
    edge_count: Tensor  # f32[num_edges] valid entries per edge
    # Self-loop split in the N-slot layout: when the last num_sl_edges
    # hyperedges are the singleton self-loops add_self_loops appended,
    # `real` is the incidence over the real edges only, and the edge-side
    # state table reserves one self-loop slot PER NODE (real.num_edges +
    # num_nodes rows), with holes at nodes that have no self-loop.
    # sl_mask is 1 at nodes with a self-loop, 0 at holes; sl_norm_full is
    # the self-loop norm in node order (0 at holes).
    real: Optional["Incidence"] = None
    sl_node: Optional[Tensor] = None  # i64[num_sl_edges]
    sl_mask: Optional[Tensor] = None  # f32[num_nodes]
    sl_norm_full: Optional[Tensor] = None  # f32[num_nodes]
    num_sl_edges: int = 0

    @property
    def nnz_padded(self) -> int:
        return self.node.shape[0]

    def to(self, device) -> "Incidence":
        return _to(self, device)

    @classmethod
    def from_arrays(
        cls,
        node: np.ndarray,
        edge: np.ndarray,
        norm: Optional[np.ndarray] = None,
        num_nodes: Optional[int] = None,
        num_edges: Optional[int] = None,
        bucket: int = 256,
        num_sl_edges: int = 0,
    ) -> "Incidence":
        """Build from host-side numpy COO (unpadded, 0-based id spaces)."""
        node = np.asarray(node, dtype=np.int32)
        edge = np.asarray(edge, dtype=np.int32)
        if node.shape != edge.shape or node.ndim != 1:
            raise ValueError("node/edge must be 1-D and equal length")
        nnz = int(node.shape[0])
        if num_nodes is None:
            num_nodes = int(node.max()) + 1 if nnz else 0
        if num_edges is None:
            num_edges = int(edge.max()) + 1 if nnz else 0
        if norm is None:
            norm = np.ones(nnz, dtype=np.float32)
        norm = np.asarray(norm, dtype=np.float32)

        if nnz:
            order = native.stable_argsort(edge, int(num_edges) + 1)
            node, edge, norm = node[order], edge[order], norm[order]

        sl_fields = {}
        if num_sl_edges > 0 and nnz:
            boundary = int(num_edges) - num_sl_edges
            k = int(np.searchsorted(edge, boundary))
            tail_e, tail_n = edge[k:], node[k:]
            if len(tail_e) == num_sl_edges and np.array_equal(
                tail_e, np.arange(boundary, num_edges, dtype=tail_e.dtype)
            ):
                mask = np.zeros(num_nodes, np.float32)
                mask[tail_n] = 1.0
                norm_full = np.zeros(num_nodes, np.float32)
                norm_full[tail_n] = norm[k:]
                sl_fields = dict(
                    real=cls.from_arrays(
                        node[:k], edge[:k], norm=norm[:k],
                        num_nodes=num_nodes, num_edges=boundary, bucket=bucket,
                    ),
                    sl_node=_ids(tail_n),
                    sl_mask=_t(mask),
                    sl_norm_full=_t(norm_full),
                    num_sl_edges=num_sl_edges,
                )

        npad = pad_bucket(nnz + _PAD_CHUNK, max(bucket, _PAD_CHUNK))
        pad = npad - nnz
        node = np.concatenate([node, np.full(pad, num_nodes, dtype=np.int32)])
        edge = np.concatenate([edge, np.full(pad, num_edges, dtype=np.int32)])
        norm = np.concatenate([norm, np.zeros(pad, dtype=np.float32)])
        mask = np.arange(npad) < nnz

        # node-sorted second order (padded entries sort last: their node id
        # num_nodes exceeds every valid id; stable sort)
        nperm = native.stable_argsort(node, int(num_nodes) + 1).astype(np.int32)
        inv = np.empty_like(nperm)
        inv[nperm] = np.arange(npad, dtype=np.int32)
        nsorted = node[nperm]
        edge_indptr = _indptr(edge[:nnz], int(num_edges))
        node_indptr = _indptr(nsorted[:nnz], int(num_nodes))

        return cls(
            node=_ids(node),
            edge=_ids(edge),
            norm=_t(norm),
            mask=_t(mask),
            num_nodes=int(num_nodes),
            num_edges=int(num_edges),
            nnz=nnz,
            edge_indptr=edge_indptr,
            node_indptr=node_indptr,
            edge_plan=chunk_plan(edge_indptr.numpy()),
            node_plan=chunk_plan(node_indptr.numpy()),
            node_perm=_ids(nperm),
            inv_node_perm=_ids(inv),
            node_sorted=_ids(nsorted),
            edge_by_node=_ids(edge[nperm]),
            node_count=_t(
                np.bincount(node[:nnz], minlength=num_nodes).astype(np.float32)
            ),
            edge_count=_t(
                np.bincount(edge[:nnz], minlength=num_edges).astype(np.float32)
            ),
            **sl_fields,
        )

    def edge_order(self) -> SegOrder:
        """The sort of ``edge`` (canonical order: sorted already)."""
        return SegOrder(None, self.edge_indptr, self.edge_plan)

    def node_order(self) -> SegOrder:
        """The sort of ``node``: the node-sorted order ``node_perm``."""
        return SegOrder(self.node_perm, self.node_indptr, self.node_plan)

    # --- directed views (see Direction below) ---

    def v2e(self) -> "Direction":
        """V->E in canonical (edge-sorted) order: gather node rows, reduce
        by hyperedge."""
        return Direction(
            src=self.node,
            dst=self.edge,
            norm=self.norm,
            perm_srcsort=self.node_perm,
            dst_count=self.edge_count,
            indptr=self.edge_indptr,
            src_indptr=self.node_indptr,
            plan=self.edge_plan,
            src_plan=self.node_plan,
            dst_srcsort=self.edge_by_node,
            num_src=self.num_nodes,
            num_dst=self.num_edges,
            nnz=self.nnz,
        )

    def e2v(self) -> "Direction":
        """E->V in the node-sorted order: gather hyperedge rows, reduce by
        node. Per-entry inputs in canonical order are permuted."""
        return Direction(
            src=self.edge_by_node,
            dst=self.node_sorted,
            norm=self.norm[self.node_perm],
            perm_srcsort=self.inv_node_perm,
            dst_count=self.node_count,
            indptr=self.node_indptr,
            src_indptr=self.edge_indptr,
            plan=self.node_plan,
            src_plan=self.edge_plan,
            dst_srcsort=self.node,
            num_src=self.num_edges,
            num_dst=self.num_nodes,
            nnz=self.nnz,
        )

    def v2e_split(self) -> "Direction":
        """V->E over the real edges; dir_spmm appends one self-loop slot
        per node (identity rows) -> [real.num_edges + num_nodes, F]. The
        tail rows are in node order, with junk at holes: pair only with
        e2v_split, which consumes the same layout."""
        if self.real is None:
            raise ValueError("incidence has no self-loop split")
        return dataclasses.replace(
            self.real.v2e(),
            sl_mode="append",
            num_dst_total=self.real.num_edges + self.num_nodes,
            sl_mask=self.sl_mask,
            sl_norm=self.sl_norm_full,
            dst_count=torch.cat([self.real.edge_count, self.sl_mask]),
        )

    def e2v_split(self) -> "Direction":
        """E->V over the real edges; dir_spmm adds the source table's tail
        num_nodes rows (the per-node self-loop slots), masked at holes."""
        if self.real is None:
            raise ValueError("incidence has no self-loop split")
        return dataclasses.replace(
            self.real.e2v(),
            sl_mode="add",
            num_dst_total=self.num_nodes,
            sl_mask=self.sl_mask,
            sl_norm=self.sl_norm_full,
            dst_count=self.node_count,
        )


@dataclasses.dataclass(frozen=True)
class Direction:
    """One directed half of the bipartite exchange, in an entry order
    whose reduce side is sorted: V->E rides the canonical order, E->V the
    node-sorted order. ``src``/``norm``/``mask`` are in execution order,
    ``dst`` ascending; the first ``nnz`` entries are the valid ones.

    The gather's backward is a segment-sum over ``src``, served sorted
    through ``src_indptr`` and ``dst_srcsort``. Consumed by
    ``ops/exchange.py``.

    sl_mode: 'none' (all entries), 'append' (V->E over the real edges,
    output appends every source row as a self-loop slot) or 'add' (E->V
    over the real edges, adds the source table's tail rows masked at
    holes); see ``Incidence.v2e_split``/``e2v_split``.
    """

    src: Tensor  # i64[nnz_pad]
    dst: Tensor  # i64[nnz_pad]
    norm: Tensor  # f32[nnz_pad]
    perm_srcsort: Tensor  # i64[nnz_pad] execution index of each src-sorted entry
    dst_count: Tensor  # f32[num_dst or num_dst_total]
    indptr: Tensor  # i32[num_dst + 1] over valid entries, by dst
    src_indptr: Tensor  # i32[num_src + 1] over valid entries, by src
    plan: SegPlan  # K1's chunk plan over indptr
    src_plan: SegPlan  # and over src_indptr
    dst_srcsort: Tensor  # i64[nnz_pad] dst of each entry in src-sorted order
    num_src: int
    num_dst: int
    nnz: int
    sl_mode: str = "none"
    num_dst_total: int = 0
    sl_mask: Optional[Tensor] = None  # f32[num_nodes]
    sl_norm: Optional[Tensor] = None  # f32[num_nodes], the self-loop norm (0 at holes)
