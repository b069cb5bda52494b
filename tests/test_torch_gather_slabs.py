"""The launch plans of the gather inside K1 (column slabs under an L2
budget, the block's staged chunks) and of K4 (head vectors, grid, workspace), and
their plain versions on the CPU:

  * ``slab_plan`` cuts W into whole 8-column units, each slab under its
    budget, and ``gather_launch`` fits a block's threads and staging;
  * the kernel's order of additions taken slab by slab (``slab_sums``,
    here: ``gather_segment_sum_planned`` on each slab's columns) equals
    that order over the whole width bit for bit (no norm, a per-entry and
    a runs-axis norm, uneven slabs) and, routed through ``_Spmm``, the JAX
    package's dir_spmm and its vjp within f32 2e-4
    (tests/test_parity_setgnn.py's tolerance);
  * K4's library formula (torch.amax over the score columns, then the
    [H]-sized leaky(. + ba) and clamp at 0, which are monotone and so
    commute with the max) equals ``gmax_plain`` and the JAX package's
    ``_gmax_kernel`` in Pallas interpret mode bit for bit, NaN included;
  * the pack's launchers refuse CPU tensors, and ``pack_fwd`` on the CPU
    takes the plain version with no launch counted.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

import allset_tpu.graph.transforms as jtr
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu.ops import pallas_pack as jpp
from allset_tpu.ops.exchange import dir_spmm as jax_spmm
from allset_tpu_torch.graph.incidence import chunk_plan
from allset_tpu_torch.nn.modules import packed_width
from allset_tpu_torch.ops import _kernels, cuda_gather as cg, cuda_pack as ck
from allset_tpu_torch.ops import cuda_segment as cs, exchange

TOL = 2e-4
SLOPE = 0.2
MiB = 1 << 20


@pytest.mark.parametrize("rows,W,item,budget", [
    (88_860, 20 * 264, 4, cs.L2_BUDGET),  # the 20-run epoch: 48 slabs of 112 columns
    (131_072, 264, 2, cs.L2_BUDGET),  # the bench step's node table: 136 + 128
    (65_536, 264, 2, 32 * MiB),
    (1000, 264, 2, cs.L2_BUDGET),  # one slab
    (1000, 4096, 4, 1 << 40),  # one block of 16-byte vectors at most
    (50, 264, 2, 50 * 80 * 2),  # uneven: 72 + 72 + 72 + 48
    (10 ** 7, 64, 4, 1 * MiB),  # one unit over the budget: 8 columns
])
def test_slab_plan_covers_the_width_under_its_budget(rows, W, item, budget):
    cols, n = cs.slab_plan(rows, W, item, budget)
    assert cols % 8 == 0 and cols > 0
    assert (n - 1) * cols < W <= n * cols  # n slabs cover W, none empty
    assert cols * item <= 256 * 16  # one block of 16-byte vectors
    if rows * 8 * item <= budget:
        assert rows * cols * item <= budget
    else:
        assert cols == 8


@pytest.mark.parametrize("W,item,nruns,run_w,scaled", [
    (20 * 264, 4, 20, 264, True), (264, 2, 1, 264, False), (8, 2, 1, 8, False),
    (8, 4, 1, 8, True), (3 * 264, 2, 3, 264, True), (640, 4, 80, 8, True)])
def test_gather_launch_fits_a_block(W, item, nruns, run_w, scaled):
    counts = np.random.default_rng(0).integers(0, 9, 400)
    counts[17] = 900
    plan = chunk_plan(np.r_[0, np.cumsum(counts)])
    vecs, cpb, threads, smem, slabs = cs.gather_launch(5000, W, item, plan, nruns, run_w,
                                                       scaled)
    cols = vecs * 16 // item
    assert (cols, slabs) == cs.slab_plan(5000, W, item)
    # the slabs cover the row's 16-byte vectors, none empty (the C entry's check)
    assert (slabs - 1) * vecs < W * item // 16 <= slabs * vecs
    assert cpb >= 1 and cpb * vecs <= threads <= 256 and threads % 32 == 0
    nrs = min(nruns, (cols - 1) // run_w + 2) if scaled else 0
    assert smem == 4 * (cpb * (plan.max_rows * (1 + nrs) + plan.max_segs) + 1)
    assert smem <= 48 * 1024


def slab_sums(w, ids, indptr, num_seg, plan, norm=None, budget=cs.L2_BUDGET):
    """The kernel's order of additions slab by slab: the scaled gathered
    rows (a runs-axis norm [R, k]: run r's W / R columns by its row r), cut
    into slab_plan's slabs of columns, each summed by segment_sum_planned,
    then the slabs side by side."""
    W = w.shape[1]
    rows = cg.gather_fwd_plain(w, ids)
    if norm is not None:
        n = norm if norm.dim() == 2 else norm[None]
        rows = rows * n.t().repeat_interleave(W // n.shape[0], dim=1).to(w.dtype)
    cols = cs.slab_plan(w.shape[0], W, w.element_size(), budget)[0]
    return torch.cat([cs.segment_sum_planned(rows[:, c:c + cols], indptr, num_seg, plan)
                      for c in range(0, W, cols)], dim=1)


def _case(gen, nseg=150, rows=60):
    counts = torch.randint(0, 6, (nseg,), generator=gen)
    counts[torch.rand(nseg, generator=gen) < 0.3] = 0
    counts[11] = 300  # a hub cut across chunks
    indptr = torch.zeros(nseg + 1, dtype=torch.int32)
    indptr[1:] = torch.cumsum(counts, 0)
    k = int(indptr[-1])
    ids = torch.randint(-2, rows + 2, (k,), generator=gen)  # clamped at both ends
    return indptr, ids, chunk_plan(indptr.numpy()), rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("norm", [None, "entry", "runs"])
def test_slabs_are_the_planned_order_bit_for_bit(dtype, norm):
    """Slab by slab (72-column slabs of a 3 x 88 table under an 80-column
    budget: 72, 72, 72, 48) the sums are the one-slab order's bits."""
    gen = torch.Generator().manual_seed(5)
    indptr, ids, plan, rows = _case(gen)
    W, R = 3 * 88, 3
    w = torch.randn(rows, W, generator=gen).to(dtype)
    n = {None: None, "entry": torch.rand(ids.shape[0], generator=gen),
         "runs": torch.rand(R, ids.shape[0], generator=gen)}[norm]
    budget = rows * 80 * w.element_size()
    assert cs.slab_plan(rows, W, w.element_size(), budget) == (72, 4)
    got = slab_sums(w, ids, indptr, 150, plan, n, budget=budget)
    assert torch.equal(got, cs.gather_segment_sum_planned(w, ids, indptr, 150, plan, n))


def _incs(hd, norm):
    t = ttr.HyperData(x=hd.x, y=hd.y, node=hd.node, edge=hd.edge, num_nodes=hd.num_nodes,
                      num_hyperedges=hd.num_hyperedges)

    def build(tr, h):
        return tr.norm_construction(tr.add_self_loops(h), norm).to_incidence(bucket=64)

    return build(ttr, t), build(jtr, hd)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("direction", ["v2e", "e2v_split"])
def test_slabs_through_spmm_match_jax_values_and_vjp(hyperdata, monkeypatch, direction,
                                                    weighted):
    """_Spmm with its gathers summed slab by slab (16-column slabs of a
    40-column table) against jax.vjp of the JAX dir_spmm."""
    Fw = 40
    tinc, jinc = _incs(hyperdata, "deg_half_sym" if weighted else "all_one")
    td, jd = getattr(tinc, direction)(), getattr(jinc, direction)()

    def slabs(w, ids, indptr, num_seg, plan, norm=None):
        return slab_sums(w, ids, indptr, num_seg, plan, norm,
                         budget=w.shape[0] * 16 * w.element_size())

    monkeypatch.setattr(exchange, "gather_segment_sum", slabs)
    rng = np.random.default_rng(2)
    rows = td.num_src + (tinc.num_nodes if direction == "e2v_split" else 0)
    w = rng.normal(size=(rows, Fw)).astype(np.float32)
    out_ref, vjp = jax.vjp(lambda x: jax_spmm(x, jd, norm=jd.norm if weighted else None),
                           jnp.asarray(w))
    g = rng.normal(size=out_ref.shape).astype(np.float32)
    (dw_ref,) = vjp(jnp.asarray(g))
    wt = torch.from_numpy(w).requires_grad_()
    out = exchange.dir_spmm(wt, td, norm=td.norm if weighted else None)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_ref), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(dw_ref), rtol=TOL, atol=TOL)


def amax_gmax(yf, ba, H, HC):
    """K4's function through torch.amax over the score columns of yf
    [rows, WP] or [rows, R, WP], then the [H]-sized tail."""
    m = torch.amax(yf[..., HC:HC + H], dim=0).float()
    return F.leaky_relu(m + ba, SLOPE).clamp_min(0.0)


def _same(a, b):
    """Equal values, NaN where the other has NaN."""
    a, b = torch.as_tensor(np.asarray(a, np.float32)), torch.as_tensor(np.asarray(b, np.float32))
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(7.0),
                                                                       b.nan_to_num(7.0))


def _jax_gmax(yf, ba, H, HC, blk=128):
    """The JAX package's _gmax_kernel in interpret mode, as _pallas_pack
    calls it, and its clamp at 0."""
    M, L = yf.shape[0], jpp.LANE
    out = pl.pallas_call(
        functools.partial(jpp._gmax_kernel, H, M, SLOPE, blk), grid=(-(-M // blk),),
        in_specs=[pl.BlockSpec((blk, L), lambda b: (b, HC // L)),
                  pl.BlockSpec((1, L), lambda b: (0, 0))],
        out_specs=pl.BlockSpec((8, L), lambda b: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, L), jnp.float32), interpret=True,
    )(yf, jpp._ba_tile(ba, H))
    return jnp.maximum(out[0, :H], 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("H", [1, 8])
@pytest.mark.parametrize("nan", [False, True])
def test_k4_library_formula_is_gmax_plain_and_the_jax_kernel(dtype, H, nan):
    HC, M = 256, 300  # M not a multiple of the JAX kernel's block
    rng = np.random.default_rng(7)
    scores = (2.0 * rng.normal(size=(M, H))).astype(np.float32)
    scores[:, 0] = -np.abs(scores[:, 0]) - 1.0  # every score of head 0 below 0
    if nan:
        scores[123, H - 1] = np.nan
    ba = (0.1 * rng.normal(size=H)).astype(np.float32)
    jyf = np.zeros((M, jpp.packed_width(HC, H)), np.float32)
    jyf[:, :HC] = rng.normal(size=(M, HC))
    jyf[:, HC:HC + H] = scores
    jyf = jnp.asarray(jyf).astype(dtype)
    yf = torch.from_numpy(np.asarray(jyf.astype(jnp.float32))[:, :packed_width(HC, H)]).to(
        getattr(torch, dtype))
    want = ck.gmax_plain(yf, torch.from_numpy(ba), H, HC)
    assert _same(amax_gmax(yf, torch.from_numpy(ba), H, HC), want)
    assert _same(_jax_gmax(jyf, jnp.asarray(ba), H, HC), want)
    assert bool(torch.isnan(want[H - 1])) == nan
    assert want[0] == 0.0 or (nan and H == 1)


def test_k4_library_formula_with_runs():
    """[rows, R, WP]: the formula run by run is gmax_plain on each run."""
    H, HC, M, R = 4, 64, 90, 3
    gen = torch.Generator().manual_seed(1)
    yf = torch.randn(M, R, packed_width(HC, H), generator=gen)
    ba = torch.randn(R, H, generator=gen)
    yf[40, 1, HC + 2] = float("nan")
    want = torch.stack([ck.gmax_plain(yf[:, r], ba[r], H, HC) for r in range(R)])
    assert _same(amax_gmax(yf, ba, H, HC), want)


@pytest.mark.parametrize("HC,H,WP,item,vh", [
    (256, 8, 264, 2, 8), (256, 8, 264, 4, 4), (64, 1, 72, 4, 1), (128, 4, 136, 2, 4),
    (256, 256, 512, 2, 8), (96, 6, 104, 2, 2), (60, 3, 64, 2, 1)])
def test_k4_head_vectors_and_grid(HC, H, WP, item, vh):
    assert ck.head_vec(HC, H, WP, item) == vh
    for rows, R in ((131_072, 1), (88_860, 20), (1000, 1000), (1, 1), (0, 5)):
        blocks = ck.gmax_grid(rows, R, H, vh, 132)
        want = -(-rows * (H // vh) // (ck.GMAX_INFLIGHT * ck.GMAX_THREADS))
        # at least GMAX_INFLIGHT vectors a thread, at most a fill of the
        # SMs over the runs, at least one block
        assert blocks >= 1 and (blocks <= want or blocks == 1)
        assert blocks * R <= max(R, 132 * ck.GMAX_BLOCKS_PER_SM)
        if want * R <= 132 * ck.GMAX_BLOCKS_PER_SM:
            assert blocks == max(want, 1)


def test_k4_workspace_keeps_tickets_apart_from_scratch(monkeypatch):
    """Launches of 1 and 20 runs share the workspace: every launch's
    scratch [R, blocks, H] lies outside the tickets, which stay zero, and
    a larger launch regrows a buffer and drops the old pointers. (A
    ticket inside another launch's scratch held a block's maxima and
    named the wrong last block.)"""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: type("P", (), {"multi_processor_count": 132})())
    ws = ck._Workspace(torch.device("cpu"))
    seen = []
    for rows, R, WP, HC, H in ((1000, 1, 512, 256, 256), (1000, 20, 512, 256, 256),
                               (1000, 1, 264, 256, 8), (88_860, 20, 264, 256, 8)):
        blocks, tickets, scratch, vh = ws.args(rows, R, WP, HC, H, 2)
        assert vh == ck.head_vec(HC, H, WP, 2)
        t0, s0 = ws.tickets.data_ptr(), ws.scratch.data_ptr()
        assert (tickets, scratch) == (t0, s0)
        assert ws.tickets.numel() >= R and ws.scratch.numel() >= R * blocks * H
        t1, s1 = t0 + 4 * ws.tickets.numel(), s0 + 4 * ws.scratch.numel()
        assert t1 <= s0 or s1 <= t0
        assert not ws.tickets.any()
        seen.append((rows, R, WP, HC, H))
    for key in seen:  # cached geometry points at the live buffers
        assert ws.args(*key, 2)[1:3] == (ws.tickets.data_ptr(), ws.scratch.data_ptr())


def test_score_pack_refuses_cpu_tensors_and_pack_fwd_takes_the_plain_version():
    H, HC, M = 8, 256, 70
    gen = torch.Generator().manual_seed(3)
    yf = torch.randn(M, packed_width(HC, H), generator=gen)
    bV, ba = torch.randn(HC, generator=gen), torch.randn(H, generator=gen)
    _kernels.reset_launches()
    with pytest.raises(ValueError):
        ck.score_pack_cuda(yf, bV, ba, H)
    with pytest.raises(ValueError):
        ck.gmax_cuda(yf, ba, H, HC)
    with pytest.raises(ValueError):
        ck.pack_cuda(yf, bV, ba, ck.gmax_plain(yf, ba, H, HC), H)
    w, gmax = ck.pack_fwd(yf, bV, ba, H)
    assert torch.equal(gmax, ck.gmax_plain(yf, ba, H, HC))
    assert torch.equal(w, ck.pack_plain(yf, bV, ba, H, gmax))
    assert all(v == 0 for v in _kernels.launches.values())


@pytest.mark.cuda
def test_on_the_card_slabs_and_k4_are_bit_exact():
    """On the card: the gather inside K1 at several budgets (uneven slabs)
    equals B10 + scale + K1 bit for bit; K4 in one launch (alone and in
    the pack's forward) equals gmax_plain, NaN included, at R = 1 and 20."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    gen = torch.Generator().manual_seed(0)
    indptr, ids, plan, rows = _case(gen, nseg=3000, rows=1000)
    ip, ids, plan = indptr.cuda(), ids.cuda(), plan.to("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        w = torch.randn(rows, 264, generator=gen).to(dtype).cuda()
        pair = cs.segment_sum_cuda(cg.gather_fwd_cuda(w, ids), ip, 3000, plan)
        for budget in (rows * 80 * w.element_size(), cs.L2_BUDGET):
            assert torch.equal(cs.gather_segment_sum_cuda(w, ids, ip, 3000, plan,
                                                          budget=budget), pair)
        for R in (1, 20):
            yf = torch.randn(5000, R, 264, generator=gen).to(dtype).cuda()
            ba = torch.randn(R, 8, generator=gen).cuda()
            yf[77, R - 1, 263] = float("nan")
            want = torch.stack([ck.gmax_plain(yf[:, r], ba[r], 8, 256) for r in range(R)])
            assert _same(ck.gmax_cuda(yf, ba, 8, 256).cpu(), want.cpu())
            bV = torch.randn(R, 256, generator=gen).cuda()
            assert _same(ck.score_pack_cuda(yf, bV, ba, 8)[1].cpu(), want.cpu())
