"""The one-hot segment-sum experiments' plain versions (B1-B4 and B6,
ops/cuda_onehot.py) against the TPU kernels they port, run in Pallas
interpret mode (each module's ``pl`` swapped for one whose pallas_call
interprets; the files are not changed): B1
``benchmarks/pallas_segsum_proto.py``; B2 ``exp_nbuf.py`` at nbuf 2, 3, 4,
6; B3 ``exp_acc2.py`` at nacc 1, 2, 4; B4 ``exp_onehot.py``'s builds A, B,
C; B6 ``exp_segsum_ablate.py``'s seven modes. 2,048 sorted entries over
250 segments (not a multiple of the 64-segment block: padded to 256),
chunks of 256 rows, F 128, f32, at 1e-5 of the reference's max |.|.
Plus the routing (a CPU tensor takes the plain version with no launch
counted) and each experiment module's ``main`` on the CPU.

The card's work split (``work_plan``, ``grid_bound``, ``slots_bound``)
and a torch emulation of the kernel's split and combine (stage spans,
items, accumulator sets by the block's chunk, partials added in item
order) on uniform and hub-skewed ids (one block holding at least 90% of
the entries) at S_BLK 64, 128 and 256, and the plain version on those
inputs against B6 ("full") and B3 (nacc 2) in interpret mode."""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from allset_tpu_torch.ops import _kernels, cuda_onehot as co

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NNZ, SEGS, F = 2048, 250, 128
S_BLK, CHUNK = 64, 256
TOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_under_test", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns
    return mod


@pytest.fixture(scope="module")
def inputs():
    """Sorted ids padded as the experiments pad them (past the last
    segment), msgs padded with a spare chunk (random rows: a surrogate
    reads them), the block indptr over the padded segment count."""
    rng = np.random.default_rng(0)
    ids = np.sort(rng.integers(0, SEGS, size=NNZ)).astype(np.int32)
    m_pad = -(-SEGS // S_BLK) * S_BLK
    nnz_pad = co.pad_for_kernel(NNZ, CHUNK)
    dst = np.full(nnz_pad, m_pad + 7, np.int32)
    dst[:NNZ] = ids
    msgs = rng.normal(size=(nnz_pad, F)).astype(np.float32)
    bip = co.block_indptr(torch.from_numpy(ids), m_pad, S_BLK).numpy()
    return msgs, dst, bip, m_pad


def _padded(ids, s_blk, rng):
    """The experiments' padding of sorted ids (past the last segment, a
    spare chunk; random msgs rows there, which a surrogate reads)."""
    m_pad = -(-SEGS // s_blk) * s_blk
    dst = np.full(co.pad_for_kernel(ids.shape[0], CHUNK), m_pad + 7, np.int32)
    dst[:ids.shape[0]] = ids
    msgs = rng.normal(size=(dst.shape[0], F)).astype(np.float32)
    bip = co.block_indptr(torch.from_numpy(ids), m_pad, s_blk).numpy()
    return msgs, dst, bip, m_pad


def _hub_ids(rng):
    """92% of the entries on segments 64-127 (five hubs take 60% of those),
    the rest uniform: one block of 64, 128 or 256 segments holds >= 90%."""
    n_hub = int(NNZ * 0.92)
    hubs = rng.choice(np.arange(64, 128), size=5, replace=False)
    heavy = rng.choice(hubs, size=int(n_hub * 0.6))
    rest = rng.integers(64, 128, size=n_hub - heavy.shape[0])
    spread = rng.integers(0, SEGS, size=NNZ - n_hub)
    return np.sort(np.concatenate([heavy, rest, spread])).astype(np.int32)


@pytest.fixture(scope="module", params=["uniform", "hub"])
def skew_ids(request):
    rng = np.random.default_rng(5)
    if request.param == "uniform":
        return request.param, np.sort(rng.integers(0, SEGS, size=NNZ)).astype(np.int32)
    return request.param, _hub_ids(rng)


def _case(skew_ids, s_blk):
    kind, ids = skew_ids
    msgs, dst, bip, m_pad = _padded(ids, s_blk, np.random.default_rng(6))
    if kind == "hub":
        per_block = np.diff(bip)
        assert per_block.max() >= 0.9 * NNZ, per_block
    return msgs, dst, bip, m_pad


def _check(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= TOL, err


def _plain(inputs, **kw):
    msgs, dst, bip, m_pad = inputs
    return co.segsum_onehot(torch.from_numpy(msgs), torch.from_numpy(dst),
                            torch.from_numpy(bip), m_pad, S_BLK, CHUNK, **kw)


def test_b1_prototype(inputs):
    msgs, dst, bip, m_pad = inputs
    mod = _load("pallas_segsum_proto")
    want = mod.pallas_segment_sum(jnp.asarray(msgs), jnp.asarray(dst).reshape(-1, 128),
                                  jnp.asarray(bip), m_pad, S_BLK=S_BLK, CHUNK=CHUNK)
    _check(_plain(inputs), want)


@pytest.mark.parametrize("nbuf", [2, 3, 4, 6])
def test_b2_nbuf(inputs, nbuf):
    msgs, dst, bip, m_pad = inputs
    want = _load("exp_nbuf").run(jnp.asarray(msgs), jnp.asarray(dst).reshape(-1, 128),
                                 jnp.asarray(bip), m_pad, S_BLK, CHUNK, nbuf)
    _check(_plain(inputs, nbuf=nbuf), want)


@pytest.mark.parametrize("nacc", [1, 2, 4])
def test_b3_nacc(inputs, nacc):
    msgs, dst, bip, m_pad = inputs
    want = _load("exp_acc2").run(jnp.asarray(msgs), jnp.asarray(dst).reshape(-1, 128),
                                 jnp.asarray(bip), m_pad, S_BLK, CHUNK, nacc)
    _check(_plain(inputs, nacc=nacc), want)


@pytest.mark.parametrize("build", ["A", "B", "C"])
def test_b4_onehot_builds(inputs, build):
    msgs, dst, bip, m_pad = inputs
    want = _load("exp_onehot").run(jnp.asarray(msgs), jnp.asarray(dst).reshape(-1, 128),
                                   jnp.asarray(bip), m_pad, S_BLK, CHUNK, build)
    _check(_plain(inputs, build=build), want)


@pytest.mark.parametrize("mode", co.MODES)
def test_b6_ablation_modes(inputs, mode):
    msgs, dst, bip, m_pad = inputs
    want = _load("exp_segsum_ablate").run_variant(
        jnp.asarray(msgs), jnp.asarray(dst).reshape(-1, 128), jnp.asarray(bip), m_pad, S_BLK,
        CHUNK, mode)
    _check(_plain(inputs, mode=mode), want)


def test_cpu_takes_the_plain_version_and_counts_no_launch(inputs):
    msgs, dst, bip, m_pad = inputs
    _kernels.reset_launches()
    args = (torch.from_numpy(msgs), torch.from_numpy(dst), torch.from_numpy(bip), m_pad,
            S_BLK, CHUNK)
    assert torch.equal(co.segsum_onehot(*args, mode="nomatmul"),
                       co.segsum_onehot_plain(*args, mode="nomatmul"))
    with pytest.raises(ValueError):
        co.segsum_onehot_cuda(*args)
    with pytest.raises(ValueError):
        co.segsum_onehot(*args[:4], 96, CHUNK)  # no such block
    assert _kernels.launches["segsum_onehot"] == 0


@pytest.mark.cuda
def test_kernel_matches_its_plain_version():
    """On the card: every variant within 1e-5 (f32, 3xTF32) and 1e-5
    (bf16: exact products, f32 sums) of its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    rng = np.random.default_rng(1)
    ids = np.sort(rng.integers(0, 1000, size=20_000)).astype(np.int32)
    for s_blk in (64, 256):
        m_pad = -(-1000 // s_blk) * s_blk
        nnz_pad = co.pad_for_kernel(ids.shape[0], 512)
        dst = np.full(nnz_pad, m_pad + 7, np.int32)
        dst[:ids.shape[0]] = ids
        bip = co.block_indptr(torch.from_numpy(ids), m_pad, s_blk).cuda()
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(rng.normal(size=(nnz_pad, 128)).astype(np.float32)).to(dtype)
            x, d = x.cuda(), torch.from_numpy(dst).cuda()
            for mode in co.MODES:
                got = co.segsum_onehot_cuda(x, d, bip, m_pad, s_blk, 512, mode=mode)
                want = co.segsum_onehot_plain(x, d, bip, m_pad, s_blk, 512, mode=mode)
                err = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
                assert err <= TOL, (s_blk, dtype, mode, err)


ITEM_ROWS = (CHUNK, 2 * CHUNK, 2048)  # items of 1 and 2 chunks split the hub block


@pytest.mark.parametrize("s_blk", co.S_BLKS)
def test_work_plan_covers_every_chunk_once(skew_ids, s_blk):
    """Every (block, chunk) of every window in exactly one item, the items
    of a block in chunk order and within its window, a block of no chunk
    one item; the host's grid and partial bounds hold."""
    msgs, _, bip, m_pad = _case(skew_ids, s_blk)
    rows, nb = msgs.shape[0], m_pad // s_blk
    for item_rows in ITEM_ROWS:
        plan = co.work_plan(torch.from_numpy(bip), CHUNK, item_rows, rows=rows)
        nch, items = plan["chunks"], plan["items"]
        seen = torch.zeros(nb, int(nch.max()) + 1, dtype=torch.long)
        for b, j, lo, hi in zip(plan["block"], plan["j"], plan["chunk_lo"], plan["chunk_hi"]):
            assert 0 <= lo and hi <= nch[b] and (lo < hi or nch[b] == 0)
            assert lo == j * co.item_chunks(CHUNK, item_rows)
            seen[b, lo:hi] += 1
        for b in range(nb):
            assert torch.equal(seen[b, :nch[b]], torch.ones(int(nch[b]), dtype=torch.long))
            assert int((plan["block"] == b).sum()) == items[b] >= 1
        assert plan["block"].shape[0] <= co.grid_bound(rows, nb, CHUNK, item_rows)
        assert int(items[items > 1].sum()) <= co.slots_bound(rows, nb, CHUNK, item_rows)
        split = plan["slot"][items > 1]
        assert torch.equal(split, torch.cumsum(items[items > 1], 0) - items[items > 1])
        if skew_ids[0] == "hub" and item_rows < 2048:
            assert int(items.max()) > 1  # the hub block is split


def _emulate(msgs, dst, bip, m_pad, s_blk, chunk, nacc, mode, item_rows):
    """The kernel's algorithm in torch: per item, its 64-row stages (in
    "full" only those whose ids reach the block, the span of m-tiles from
    their least and greatest id), chunk c of the block's window into set c
    % nacc, the sets added in order; a block of one item writes out, a
    split block's items each keep the rows of their union span (the rest
    must be zero) and are added in item order."""
    kind = co._MODE[mode][0]
    rows, nf = msgs.shape
    x, ids = torch.from_numpy(msgs), torch.from_numpy(dst).long()
    bipt = torch.from_numpy(bip)
    plan = co.work_plan(bipt, chunk, item_rows, rows=rows)
    start_al = bipt.long()[:-1] // co.ALIGN * co.ALIGN
    out = torch.zeros(m_pad, nf)
    parts = {}
    for b, lo, hi in zip(plan["block"].tolist(), plan["chunk_lo"].tolist(),
                         plan["chunk_hi"].tolist()):
        base = b * s_blk
        sets = torch.zeros(nacc, s_blk, nf)
        ulo, uhi = s_blk, -1
        for c in range(lo, hi):
            for st in range(chunk // 64):
                rr = int(start_al[b]) + c * chunk + st * 64 + torch.arange(64)
                ok = rr < rows
                rc = rr.clamp(max=rows - 1)
                rel = torch.where(ok, ids[rc] - base, torch.full_like(rr, -1))
                xs = torch.where(ok[:, None], x[rc], torch.zeros(()))
                rc0 = st * 64
                if kind == 0:
                    inb = (rel >= 0) & (rel < s_blk)
                    if not inb.any():
                        continue
                    seg, val = rel[inb], xs[inb]
                    ulo, uhi = min(ulo, int(seg.min())), max(uhi, int(seg.max()))
                elif kind == 1:
                    seg, val = (rc0 + torch.arange(64)) % s_blk, xs
                    ulo, uhi = 0, s_blk - 1
                else:
                    ulo, uhi = 0, s_blk - 1
                    if rc0 >= s_blk:
                        continue
                    seg, val = rc0 + torch.arange(64), xs
                    if kind == 2:
                        val = val + (rel == 0).float()[:, None]
                    keep = seg < s_blk
                    seg, val = seg[keep], val[keep]
                sets[c % nacc].index_add_(0, seg, val)
        item = sets[0]
        for i in range(1, nacc):
            item = item + sets[i]
        if plan["items"][b] == 1:
            out[base:base + s_blk] = item
            continue
        keep = torch.zeros(s_blk, dtype=torch.bool)
        if uhi >= 0:
            keep[ulo // 16 * 16:(uhi // 16 + 1) * 16] = True
        assert not item[~keep].any(), "a row outside the item's span was reached"
        parts.setdefault(b, []).append((item, keep))
    for b, items in parts.items():
        acc = torch.zeros(s_blk, nf)
        for item, keep in items:
            acc[keep] += item[keep]
        out[b * s_blk:(b + 1) * s_blk] = acc
    return out


@pytest.mark.parametrize("s_blk", co.S_BLKS)
@pytest.mark.parametrize("nacc", co.NACCS)
@pytest.mark.parametrize("mode", co.MODES)
def test_split_and_combine_emulation_matches_plain(skew_ids, s_blk, nacc, mode):
    """The emulated split (items of 2 chunks: the hub block in many) agrees
    with the plain version within TOL, every mode and accumulator count."""
    msgs, dst, bip, m_pad = _case(skew_ids, s_blk)
    got = _emulate(msgs, dst, bip, m_pad, s_blk, CHUNK, nacc, mode, 2 * CHUNK)
    want = co.segsum_onehot_plain(torch.from_numpy(msgs), torch.from_numpy(dst),
                                  torch.from_numpy(bip), m_pad, s_blk, CHUNK, nacc=nacc,
                                  mode=mode)
    _check(got, want.numpy())


@pytest.mark.parametrize("s_blk", co.S_BLKS)
@pytest.mark.parametrize("exp", ["ablate_full", "acc2_nacc2"])
def test_plain_on_skewed_ids_matches_the_tpu_kernels(skew_ids, s_blk, exp):
    """On uniform and hub-skewed ids: the plain version against B6's
    "full" and B3 at nacc 2, in interpret mode."""
    msgs, dst, bip, m_pad = _case(skew_ids, s_blk)
    args = (jnp.asarray(msgs), jnp.asarray(dst).reshape(-1, 128), jnp.asarray(bip), m_pad,
            s_blk, CHUNK)
    if exp == "ablate_full":
        want = _load("exp_segsum_ablate").run_variant(*args, "full")
        kw = {"mode": "full"}
    else:
        want = _load("exp_acc2").run(*args, 2)
        kw = {"nacc": 2}
    got = co.segsum_onehot_plain(torch.from_numpy(msgs), torch.from_numpy(dst),
                                 torch.from_numpy(bip), m_pad, s_blk, CHUNK, **kw)
    _check(got, want)


EXPERIMENTS = ("pallas_segsum_proto", "exp_nbuf", "exp_acc2", "exp_onehot",
               "exp_segsum_ablate", "exp_autopipe", "exp_fused_gather")


@pytest.mark.parametrize("name", EXPERIMENTS)
def test_experiment_main_runs_the_plain_versions_on_the_cpu(name, capsys):
    """Each module of allset_tpu_torch.experiments (B1-B8, B11): ``main``
    with --device cpu runs every variant at the small size through the
    plain versions, launches nothing and prints one JSON line per record;
    without a card the default device raises."""
    import importlib
    import json

    mod = importlib.import_module(f"allset_tpu_torch.experiments.{name}")
    _kernels.reset_launches()
    rec = mod.main(["--device", "cpu", "--iters", "1"])
    assert rec["device"] == "cpu" and rec["variants"]
    assert not any(_kernels.launches.values())
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[-1]["experiment"] == rec["experiment"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            mod.main([])
