"""The row gather's plain version (B10's CPU path, ops/cuda_gather.py)
against the TPU gather experiments of benchmarks/exp_fused_gather.py run
in Pallas interpret mode (the module's ``pl`` swapped for one whose
pallas_call interprets; the file is not changed): B9 ``vmem_gather``
(the table held on chip), B10 ``dma_gather`` (per-row DMA) and B11
``take_gather`` (jnp.take inside the kernel), each bit for bit; against
``jnp.take(mode="clip")`` with ids past both ends; its backward against
``jax.vjp`` of ``jnp.take``; and the wrapper's routing (the kernel for a
CUDA tensor, the plain version for a CPU one, a launch count only where
the kernel runs)."""

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
