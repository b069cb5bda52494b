"""The streaming probes' plain versions (B5, B7, B8; ops/cuda_stream.py)
against the TPU kernels they port, run in Pallas interpret mode (the
module's ``pl`` swapped for one whose pallas_call interprets; the files
are not changed): B5 ``benchmarks/exp_segsum_ablate.py::run_flat`` and B7
``run_dual`` on tiled input (every chunk the same rows: their static slot
0 then holds the same rows whenever each copy lands), B8
``benchmarks/exp_autopipe.py::run`` on random input, both bodies. Also
the plain surrogates on random input against numpy, and the routing (a
CPU tensor takes the plain version with no launch counted). f32 at 1e-5
of the reference's max |.|. B5 and B7 read only each chunk's first 16
rows: NaN past them changes nothing; B8's thread blocks' chunk runs cover
every chunk once."""

import functools
import importlib.util
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from allset_tpu_torch.ops import _kernels, cuda_stream as cst

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, CHUNK = 128, 64
TOL = 1e-5


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_stream_test", os.path.join(REPO, "benchmarks", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ns = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl) if not k.startswith("_")})
    ns.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = ns
    return mod


def _check(got, want):
    want = np.asarray(want, np.float32)
    err = np.abs(got.numpy() - want).max() / max(np.abs(want).max(), 1.0)
    assert err <= TOL, err


def _tiled(seed, nchunks):
    rng = np.random.default_rng(seed)
    return np.tile(rng.normal(size=(CHUNK, F)).astype(np.float32), (nchunks, 1))


def _seed():
    return np.random.default_rng(9).normal(size=(16, F)).astype(np.float32)


def test_b5_flat_on_tiled_input():
    x, seed = _tiled(0, 2 * cst.FLAT_CHUNKS), _seed()
    want = _load("exp_segsum_ablate").run_flat(jnp.asarray(x), jnp.asarray(seed), CHUNK)
    _check(cst.stream_flat(torch.from_numpy(x), torch.from_numpy(seed), CHUNK), want)


def test_b7_dual_on_tiled_input():
    a, b, seed = _tiled(1, 3 * cst.DUAL_CHUNKS), _tiled(2, 3 * cst.DUAL_CHUNKS), _seed()
    want = _load("exp_segsum_ablate").run_dual(jnp.asarray(a), jnp.asarray(b),
                                               jnp.asarray(seed), CHUNK)
    _check(cst.stream_dual(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(seed),
                           CHUNK), want)


@pytest.mark.parametrize("body", cst.BODIES)
def test_b8_autopipe_on_random_input(monkeypatch, body):
    """B8's body is read from AUTOPIPE_BODY when the kernel is traced:
    'fold', or the first 16 rows for any other value."""
    monkeypatch.setenv("AUTOPIPE_BODY", body)
    rng = np.random.default_rng(3)
    x, seed = rng.normal(size=(12 * CHUNK, F)).astype(np.float32), _seed()
    want = _load("exp_autopipe").run(jnp.asarray(x), jnp.asarray(seed), CHUNK)
    _check(cst.stream_fold(torch.from_numpy(x), torch.from_numpy(seed), CHUNK, body), want)


def test_plain_surrogates_on_random_input():
    """Rows past the last whole block (B5, B7) or chunk (B8) are not
    read; numpy's sums in f64."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(21 * CHUNK + 5, F)).astype(np.float32)
    y = rng.normal(size=(21 * CHUNK + 5, F)).astype(np.float32)
    seed = _seed()
    first16 = lambda a, n: a[: n * CHUNK].reshape(n, CHUNK, F)[:, :16].astype(np.float64).sum(0)
    X, Y, S = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(seed)
    _check(cst.stream_flat(X, S, CHUNK), seed + first16(x, 16))
    _check(cst.stream_dual(X, Y, S, CHUNK), seed + first16(x, 20) + first16(y, 20))
    _check(cst.stream_fold(X, S, CHUNK, "first16"), seed + first16(x, 21))
    _check(cst.stream_fold(X, S, CHUNK),
           seed + x[: 21 * CHUNK].reshape(-1, 16, F).astype(np.float64).sum(0))


def test_b5_b7_plain_ignores_rows_past_16():
    """B5 and B7 sum only each chunk's first 16 rows: NaN in every chunk's
    rows 16 and up leaves the plain outputs finite and equal to those on
    the clean input (the kernels read only those rows too)."""
    x, y, seed = _tiled(5, 2 * cst.FLAT_CHUNKS), _tiled(6, 2 * cst.FLAT_CHUNKS), _seed()
    X, Y, S = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(seed)
    Xn, Yn = X.clone(), Y.clone()
    for t in (Xn, Yn):
        t.view(-1, CHUNK, F)[:, 16:] = float("nan")
    for got, want in ((cst.stream_flat(Xn, S, CHUNK), cst.stream_flat(X, S, CHUNK)),
                      (cst.stream_dual(Xn, Yn, S, CHUNK), cst.stream_dual(X, Y, S, CHUNK))):
        assert torch.isfinite(got).all()
        assert torch.equal(got, want)


@pytest.mark.parametrize("nchunks", [0, 1, 7, 263, 264, 265, 512, 1136, 5000])
def test_chunk_runs_cover_every_chunk_once(nchunks):
    """B8's thread blocks' runs of consecutive chunks cover [0, nchunks)
    once, none empty, at most FOLD_BLOCKS of them."""
    cpb, grid = cst.chunk_runs(nchunks)
    assert grid <= cst.FOLD_BLOCKS and cpb >= 1
    seen = torch.zeros(nchunks, dtype=torch.long)
    for g in range(grid):
        lo, hi = g * cpb, min((g + 1) * cpb, nchunks)
        assert lo < hi
        seen[lo:hi] += 1
    assert torch.equal(seen, torch.ones(nchunks, dtype=torch.long))


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    _kernels.reset_launches()
    x, seed = torch.randn(16 * CHUNK, F), torch.zeros(16, F)
    assert torch.equal(cst.stream_fold(x, seed, CHUNK), cst.stream_fold_plain(x, seed, CHUNK))
    assert torch.equal(cst.stream_flat(x, seed, CHUNK), cst.stream_flat_plain(x, seed, CHUNK))
    with pytest.raises(ValueError):
        cst.stream_fold(x, seed, CHUNK, "half")
    assert all(_kernels.launches[k] == 0 for k in ("stream_flat", "stream_dual", "stream_fold"))


@pytest.mark.cuda
def test_kernels_match_their_plain_versions():
    """On the card: B5, B7 and B8 (both bodies) within 1e-5 of their plain
    versions, bf16 and f32, one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(70 * 512 + 3, 384, generator=gen).to(dtype).cuda()
        y = torch.randn(70 * 512 + 3, 384, generator=gen).to(dtype).cuda()
        seed = torch.randn(16, 384, generator=gen).cuda()
        for fn, plain in ((lambda: cst.stream_flat(x, seed, 512),
                           lambda: cst.stream_flat_plain(x, seed, 512)),
                          (lambda: cst.stream_dual(x, y, seed, 512),
                           lambda: cst.stream_dual_plain(x, y, seed, 512)),
                          (lambda: cst.stream_fold(x, seed, 512),
                           lambda: cst.stream_fold_plain(x, seed, 512)),
                          (lambda: cst.stream_fold(x, seed, 512, "first16"),
                           lambda: cst.stream_fold_plain(x, seed, 512, "first16"))):
            got, want = fn(), plain()
            err = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
            assert err <= TOL, (dtype, err)
