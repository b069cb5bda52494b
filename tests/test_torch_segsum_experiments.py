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
counted) and each experiment module's ``main`` on the CPU."""

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
