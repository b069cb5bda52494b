"""The row gather's plain version (B10's CPU path, ops/cuda_gather.py)
against the TPU gather experiments of benchmarks/exp_fused_gather.py run
in Pallas interpret mode (the module's ``pl`` swapped for one whose
pallas_call interprets; the file is not changed): B9 ``vmem_gather``
(the table held on chip), B10 ``dma_gather`` (per-row DMA) and B11
``take_gather`` (jnp.take inside the kernel), each bit for bit; against
``jnp.take(mode="clip")`` with ids past both ends; its backward against
``jax.vjp`` of ``jnp.take``; and the wrapper's routing (the kernel for a
CUDA tensor, the plain version for a CPU one, a launch count only where
the kernel runs). B9's plain version (``gather_sorted_fwd`` on the CPU)
and ``gather_rows``' sorted route (an order whose ids are sorted and a
narrow row) against ``vmem_gather`` in interpret mode, bit for bit, on
sorted ids in runs, a hub run and clamped ids; the route's choice by the
row's bytes and the ids' order; B9's warp algorithm (csrc/gather_sorted.cu)
emulated lane by lane against the plain version, bit for bit."""

import functools
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from allset_tpu_torch.graph.incidence import SegOrder, chunk_plan
from allset_tpu_torch.ops import _kernels, cuda_gather as cg
from allset_tpu_torch.ops.segment import gather_rows

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def exp_gather():
    """benchmarks/exp_fused_gather.py with its ``pl`` in interpret mode."""
    spec = importlib.util.spec_from_file_location(
        "exp_fused_gather_under_test", os.path.join(REPO, "benchmarks", "exp_fused_gather.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns
    return mod


def _table(rows=300, F=128, seed=0, dtype=jnp.bfloat16):
    rng = np.random.default_rng(seed)
    t = rng.normal(size=(rows, F)).astype(np.float32)
    return np.asarray(jnp.asarray(t, dtype)), rng.integers(0, rows, size=1024).astype(np.int32)


def _torch(a):
    """numpy (bf16 included) -> torch, bits unchanged."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("kernel,kw", [
    ("vmem_gather", dict(chunk=128, unroll=1)),  # B9
    ("vmem_gather", dict(chunk=128, unroll=4)),  # B9, unrolled
    ("dma_gather", dict(chunk=128)),  # B10
    ("take_gather", dict(chunk=128)),  # B11
])
def test_plain_gather_is_the_tpu_kernels_bit_for_bit(exp_gather, kernel, kw):
    """[300, 128] bf16 table, 1,024 ids: the plain gather equals each TPU
    experiment kernel exactly."""
    table, ids = _table()
    want = np.asarray(getattr(exp_gather, kernel)(jnp.asarray(table), jnp.asarray(ids), **kw))
    got = cg.gather_fwd(_torch(table), torch.from_numpy(ids))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(got).view(np.uint16), want.view(np.uint16))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
@pytest.mark.parametrize("W", [1, 8, 264])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64])
def test_plain_gather_clamps_as_take_clip(dtype, W, id_dtype):
    """Ids below 0 and at or past ``rows`` clamp as jnp.take(mode="clip"):
    bit for bit, at narrow and folded widths."""
    rng = np.random.default_rng(W)
    rows = 50
    table = np.asarray(jnp.asarray(rng.normal(size=(rows, W)).astype(np.float32), dtype))
    ids = np.concatenate([rng.integers(0, rows, size=200), [rows, rows + 7, -1, -5]])
    ids = ids.astype(id_dtype)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0, mode="clip"))
    got = _np(cg.gather_fwd(_torch(table), torch.from_numpy(ids)))
    np.testing.assert_array_equal(np.asarray(got).view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("shape", [(50, 6), (50,)])
def test_gather_backward_is_the_vjp_of_take(shape):
    """The backward scatter-adds the cotangent by the clamped ids in f32,
    as jax.vjp of jnp.take(mode="clip") (repeated and clamped ids
    included); a 1-D table gathers scalars."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=shape).astype(np.float32)
    ids = np.concatenate([rng.integers(0, shape[0], size=120), [shape[0], shape[0] + 3, 0, 0]])
    g = rng.normal(size=(ids.shape[0],) + shape[1:]).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jnp.take(t, jnp.asarray(ids), axis=0, mode="clip"),
                     jnp.asarray(table))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_()
    out = gather_rows(t, torch.from_numpy(ids))
    out.backward(torch.from_numpy(g))
    assert out.shape == (ids.shape[0],) + shape[1:]
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_gather_routes_by_device_and_counts_only_launches():
    """A CPU table takes the plain version with no launch counted; the
    CUDA wrapper refuses CPU tensors before any launch."""
    _kernels.reset_launches()
    table, ids = torch.randn(10, 3), torch.tensor([0, 9, 12])
    assert torch.equal(cg.gather_fwd(table, ids), table[[0, 9, 9]])
    assert _kernels.launches["gather"] == 0
    with pytest.raises(ValueError):
        cg.gather_fwd_cuda(table, ids)
    with pytest.raises(ValueError):
        cg.gather_fwd_plain(torch.zeros(0, 3), ids)
    assert _kernels.launches["gather"] == 0


@pytest.mark.cuda
def test_gather_kernel_is_its_plain_version_bit_for_bit():
    """On the card: B10 equals its plain version bit for bit (bf16 and
    f32, widths 1 to 5,280, int32 and int64 ids, clamped ids) and counts
    one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for W in (1, 8, 256, 264, 5280):
            table = torch.randn(1000, W, generator=gen).to(dtype).cuda()
            ids = torch.randint(-3, 1003, (4097,), generator=gen).cuda()
            for idt in (torch.int32, torch.int64):
                _kernels.reset_launches()
                got = cg.gather_fwd_cuda(table, ids.to(idt))
                assert _kernels.launches["gather"] == 1
                assert torch.equal(got, cg.gather_fwd_plain(table, ids.to(idt)))


def _sorted_ids(rows, n, seed, low=0, high=None):
    """n sorted ids in runs (random run lengths, gaps between runs, one run
    of a quarter of n: a hub) in [low, high)."""
    rng = np.random.default_rng(seed)
    high = rows if high is None else high
    ids = np.sort(rng.integers(low, high, size=n - n // 4))
    hub = np.full(n // 4, rng.integers(0, rows))
    return np.sort(np.concatenate([ids, hub]))


@pytest.mark.parametrize("dtype,F", [(np.float32, 8), (np.float32, 1), (jnp.bfloat16, 4),
                                     (jnp.bfloat16, 128)])
def test_plain_sorted_gather_is_vmem_gather_bit_for_bit(exp_gather, dtype, F):
    """B9's plain version against the TPU kernel (the table held on chip),
    bit for bit: 1,024 sorted ids in runs with a hub run of 256 and ids
    past the last row, which the interpreted kernel's row slice clamps as
    mode="clip" does (it wraps ids below 0, so those are held to
    jnp.take(mode="clip") alone)."""
    rows = 300
    rng = np.random.default_rng(F)
    table = np.asarray(jnp.asarray(rng.normal(size=(rows, F)).astype(np.float32), dtype))
    ids = _sorted_ids(rows, 1024, F, high=rows + 5).astype(np.int32)
    assert ids[-1] >= rows
    want = np.asarray(exp_gather.vmem_gather(jnp.asarray(table), jnp.asarray(ids), chunk=128))
    got = cg.gather_sorted_fwd(_torch(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(_np(got).view(np.uint8), want.view(np.uint8))
    low = np.concatenate([[-7, -1], ids]).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(low), axis=0, mode="clip"))
    got = cg.gather_sorted_fwd(_torch(table), torch.from_numpy(low))
    np.testing.assert_array_equal(_np(got).view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("dtype,F", [(np.float32, 8), (jnp.bfloat16, 4), (np.float32, 1)])
def test_gather_rows_sorted_route_is_vmem_gather_bit_for_bit(exp_gather, dtype, F):
    """gather_rows with an order whose ids are sorted (perm None: the
    padding id ``rows`` last, as an Incidence's destinations) takes B9's
    route for a narrow row and gives the TPU kernel's rows, bit for bit;
    its backward is the order's K1 sum (f32 1e-6 of the vjp of take)."""
    rows = 300
    rng = np.random.default_rng(F + 1)
    table = np.asarray(jnp.asarray(rng.normal(size=(rows, F)).astype(np.float32), dtype))
    ids = np.concatenate([_sorted_ids(rows, 1000, F), np.full(24, rows)]).astype(np.int64)
    indptr = np.searchsorted(ids[:1000], np.arange(rows + 1)).astype(np.int32)
    order = SegOrder(None, torch.from_numpy(indptr), chunk_plan(indptr))
    t = _torch(table)
    nbytes = cg.row_bytes(t)
    assert cg.gather_route(nbytes, True) == "sorted" and cg.gather_route(nbytes, False) == "rows"
    want = np.asarray(exp_gather.vmem_gather(jnp.asarray(table), jnp.asarray(ids, jnp.int32),
                                             chunk=128))
    got = gather_rows(t, torch.from_numpy(ids), order)
    np.testing.assert_array_equal(_np(got).view(np.uint8), want.view(np.uint8))
    if dtype == np.float32:
        g = rng.normal(size=(ids.shape[0], F)).astype(np.float32)
        g[1000:] = 0.0  # padded entries carry no cotangent
        tt = torch.from_numpy(table).requires_grad_()
        gather_rows(tt, torch.from_numpy(ids), order).backward(torch.from_numpy(g))
        _, vjp = jax.vjp(lambda x: jnp.take(x, jnp.asarray(ids), axis=0, mode="clip"),
                         jnp.asarray(table))
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]),
                                   rtol=1e-6, atol=1e-6)


def test_gather_route_by_bytes_and_order():
    """B9 for sorted ids and a row of at most NARROW_BYTES, in any dtype;
    B10 for a wider row or ids not known to be sorted. The sorted wrapper
    takes the plain version for a CPU table and counts no launch; its CUDA
    wrapper refuses CPU tensors before any launch."""
    narrow = cg.NARROW_BYTES
    for dtype, item in ((torch.float32, 4), (torch.bfloat16, 2)):
        for W, ids_sorted, route in ((narrow // item, True, "sorted"),
                                     (narrow // item + 1, True, "rows"), (1, False, "rows")):
            nbytes = cg.row_bytes(torch.zeros(3, W, dtype=dtype))
            assert cg.gather_route(nbytes, ids_sorted) == route
    assert cg.row_bytes(torch.zeros(5, 2, 3)) == 24
    _kernels.reset_launches()
    table, ids = torch.randn(10, 3), torch.tensor([0, 0, 9, 12])
    assert torch.equal(cg.gather_sorted_fwd(table, ids), table[[0, 0, 9, 9]])
    assert _kernels.launches["gather_sorted"] == 0 and _kernels.launches["gather"] == 0
    with pytest.raises(ValueError):
        cg.gather_sorted_fwd_cuda(table, ids)
    assert _kernels.launches["gather_sorted"] == 0


@pytest.mark.cuda
def test_sorted_gather_kernel_is_its_plain_version_bit_for_bit():
    """On the card: B9 equals its plain version bit for bit (f32 and bf16,
    rows of 4 B to 1 KiB, sorted ids with a hub run and clamps, unsorted
    ids, int32 and int64) and counts one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for W in (1, 2, 8, 64, 512 // torch.tensor([], dtype=dtype).element_size()):
            table = torch.randn(1000, W, generator=gen).to(dtype).cuda()
            ids = torch.from_numpy(_sorted_ids(1000, 20_000, W, low=-3, high=1003))
            for order in (ids, ids[torch.randperm(ids.shape[0], generator=gen)]):
                for idt in (torch.int32, torch.int64):
                    i = order.to(idt).cuda()
                    _kernels.reset_launches()
                    got = cg.gather_sorted_fwd_cuda(table, i)
                    assert _kernels.launches["gather_sorted"] == 1
                    assert torch.equal(got, cg.gather_sorted_fwd_plain(table, i))


# B9's warps of one wave (csrc/gather_sorted.cu's kWave: 24 per SM of 132)
B9_WAVE = 132 * 24


def _b9_plan(nbytes, n):
    """B9's vector and warp plan for n ids and rows of ``nbytes`` on
    aligned tables (csrc/gather_sorted.cu's launch): vector bytes vb,
    vectors a row nv, lanes a row L (the least power of two >= nv, at most
    32), ids a step P = 32 / L, steps a warp's span S (the fewest of 2, 4
    and 8 that keep the grid within one wave)."""
    vb = next(b for b in (16, 8, 4, 2, 1) if nbytes % b == 0)
    nv = nbytes // vb
    L = min(32, 1 << (nv - 1).bit_length())
    P = 32 // L
    warp_steps = -(-n // P)
    return vb, nv, L, P, next((S for S in (2, 4) if warp_steps <= S * B9_WAVE), 8)


def _b9_emulated(tab, ids, steps):
    """B9's warp algorithm on the host, lane by lane, with spans of
    ``steps`` steps: the span's ids clamped, the heads by shuffle-up (the
    span's first id a head), each head's row read by the lanes of its
    vectors, every other id taking its run's row from the nearest head
    slot of its step (the ballot) or from the last slot of the step before
    (the carry); rows of more than 32 vectors in chunks of 32. tab: [rows,
    nbytes] uint8 -> (out [n, nbytes] uint8, row vectors read)."""
    rows, nbytes = tab.shape
    n = ids.shape[0]
    vb, nv, L, P, _ = _b9_plan(nbytes, n)
    span = steps * P
    vecs = tab.reshape(rows, nv, vb)
    lane = np.arange(32)
    q, cl = lane // L, lane % L
    last = (P - 1) * L + cl
    upto = [((2 << int(a)) - 1) & 0xFFFFFFFF for a in q * L]
    src_row = np.full((n, nv), -1)  # the row each output vector holds; -1: zeros
    reads = 0
    for base in range(0, n, span):
        j = base + np.arange(8)[:, None] * P + q[None, :]
        valid = (j < n) & (np.arange(8)[:, None] < steps)
        row = np.where(valid, np.clip(ids[np.minimum(j, n - 1)], 0, rows - 1), -1)
        head = np.zeros((8, 32), bool)
        for u in range(8):
            prev = np.where(lane >= L, row[u][np.maximum(lane - L, 0)], row[u])
            prev = np.where(q == 0, row[u - 1][last] if u > 0 else -1, prev)
            head[u] = (row[u] >= 0) & (row[u] != prev)
        for c0 in range(0, nv, L):
            c = c0 + cl
            on = c < nv
            v = np.where(head & on[None, :], row, -1)
            reads += int((head & on[None, :]).sum())
            carry = np.full(32, -1)
            for u in range(8):
                ballot = sum(1 << int(a) for a in lane if head[u][a] and cl[a] == 0)
                heads = [ballot & m for m in upto]
                src = np.array([h.bit_length() - 1 + cl[a] if h else a
                                for a, h in enumerate(heads)])
                v[u] = np.where(np.array(heads) != 0, v[u][src], carry)
                carry = v[u][last]
            for u in range(8):
                ok = valid[u] & on
                src_row[j[u][ok], c[ok]] = v[u][ok]
    out = np.zeros((n, nv, vb), np.uint8)
    hit = src_row >= 0
    out[hit] = vecs[src_row[hit], np.nonzero(hit)[1]]
    return out.reshape(n, nbytes), reads


@pytest.mark.parametrize("dtype,W", [(torch.bfloat16, 1), (torch.bfloat16, 3), (torch.float32, 1),
                                     (torch.float32, 6), (torch.float32, 8), (torch.bfloat16, 8),
                                     (torch.float32, 32), (torch.float32, 256)])
def test_sorted_gather_warp_algorithm_is_the_plain_version_bit_for_bit(dtype, W):
    """B9's warp algorithm (_b9_emulated: heads, the ballot's head slot, the
    carry across steps, column chunks) gives the plain version's rows bit
    for bit at rows of 2 B (one 2-byte vector) to 1 KiB (64 16-byte vectors
    in two chunks), with 3-vector rows that leave a lane of four idle, on
    sorted ids in runs with a hub run and ids past both ends, and on the
    same ids unsorted, with spans of 2, 4 and 8 steps; sorted ids read at
    most one row a run and span, unsorted ones more. The plan takes 2 steps at 3,001 ids, 4 at
    CEGAT's 280,576 one-vector rows and 8 at its two-vector rows."""
    rows, n = 300, 3001
    gen = torch.Generator().manual_seed(W)
    table = torch.randn(rows, W, generator=gen).to(dtype)
    tab = table.view(torch.uint8).numpy().reshape(rows, -1) if dtype == torch.float32 else \
        table.view(torch.int16).numpy().view(np.uint8).reshape(rows, -1)
    ids = _sorted_ids(rows, n, W, low=-3, high=rows + 3)
    shuffled = np.random.default_rng(W).permutation(ids)
    _, nv, _, P, steps = _b9_plan(tab.shape[1], n)
    assert steps == 2 and _b9_plan(4, 280_576)[4] == 4 and _b9_plan(32, 280_576)[4] == 8
    clamped = np.clip(ids, 0, rows - 1)
    runs = 1 + int((clamped[1:] != clamped[:-1]).sum())
    for steps in (2, 4, 8):
        reads = {}
        for order, what in ((ids, "sorted"), (shuffled, "unsorted")):
            got, reads[what] = _b9_emulated(tab, order, steps)
            want = cg.gather_sorted_fwd_plain(table, torch.from_numpy(order))
            want = want.view(torch.uint8) if dtype == torch.float32 else want.view(torch.int16)
            np.testing.assert_array_equal(got, want.numpy().view(np.uint8).reshape(n, -1),
                                          f"{what}, {steps} steps")
        assert runs * nv <= reads["sorted"] <= (runs + -(-n // (steps * P))) * nv
        assert reads["unsorted"] > reads["sorted"]
