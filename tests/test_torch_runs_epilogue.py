"""The runs-folded PMA epilogue (K2R/K3R) and the folded exchange on the
CPU: the port's plain versions against the JAX package's R > 1 Pallas
grids in interpret mode, R = 1 against the single-run functions, and K1 /
dir_spmm at width R*W against R separate calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import allset_tpu_torch.data.synthetic as tsyn
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu.ops.pallas_pma import _pallas_bwd, _pallas_fwd
from allset_tpu_torch.ops import _kernels
from allset_tpu_torch.ops import cuda_pma as cp
from allset_tpu_torch.ops.cuda_segment import segment_sum_plain
from allset_tpu_torch.ops.exchange import dir_spmm

R, M, HC, H, WP, BLK = 3, 50, 128, 4, 136, 32  # M not a multiple of BLK


def _inputs(L, R=R, seed=0, floor=True, M=M, HC=HC, H=H, WP=WP):
    """agg [M, R*WP] (with ``floor``, some rows at the 1e-16 denominator
    floor), per-run parameters and an upstream gradient [M, R*HC], all
    float32 numpy."""
    rng = np.random.default_rng(seed)
    den = rng.uniform(0.3, 3.0, (M, R, H))
    vals = rng.normal(size=(M, R, HC))
    if floor:  # empty segments
        den[::17], vals[::17] = 0.0, 0.0
    agg = np.concatenate([vals, den, np.zeros((M, R, WP - HC - H))], 2).reshape(M, R * WP)
    params = [0.1 * rng.normal(size=(R, HC)), 1 + 0.1 * rng.normal(size=(R, HC)),
              0.1 * rng.normal(size=(R, HC)), 0.05 * rng.normal(size=(R, L, HC, HC)),
              0.1 * rng.normal(size=(R, L, HC)), 1 + 0.1 * rng.normal(size=(R, HC)),
              0.1 * rng.normal(size=(R, HC))]
    gy = rng.normal(size=(M, R * HC))
    f32 = lambda a: a.astype(np.float32)
    return f32(agg), [f32(p) for p in params], f32(gy)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("L", [1, 2])
def test_runs_epilogue_matches_jax_runs_grid(L, relu):
    _check_runs_against_jax(L, relu, R, M, HC, H, WP)


@pytest.mark.parametrize("L", [1, 2])
def test_runs_epilogue_at_hc_512_matches_jax_runs_grid(L):
    """K2R/K3R's plain versions at the widest kernel width, R = 2, 45 rows
    (not a multiple of the 32-row tile)."""
    _check_runs_against_jax(L, True, 2, 45, 512, 8, 520)


def _check_runs_against_jax(L, relu, R, M, HC, H, WP):
    # no floor rows: their ~1e16 dvals amplify rounding past these
    # tolerances (tests/test_torch_pma.py checks them scaled apart)
    agg, params, gy = _inputs(L, R=R, floor=False, M=M, HC=HC, H=H, WP=WP)
    kw = dict(H=H, blk=BLK, interpret=True, relu=relu, R=R)
    jargs = [jnp.asarray(p) for p in params]
    y_ref = _pallas_fwd(jnp.asarray(agg), *jargs, **kw)
    dagg_ref, dW_ref, ds_ref = _pallas_bwd(jnp.asarray(agg), jnp.asarray(gy), *jargs, **kw)

    targs = _t(params)
    y = cp.epilogue_fwd_runs(torch.from_numpy(agg), *targs, H, relu)
    dagg, dW, ds = cp.epilogue_bwd_runs(torch.from_numpy(agg), torch.from_numpy(gy),
                                        *targs, H, relu)
    assert y.shape == (M, R * HC) and dagg.shape == (M, R * WP)
    assert dW.shape == (R, L, HC, HC) and ds.shape == (R, 8, HC)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=1e-5, rtol=1e-5)
    for got, want in ((dagg, dagg_ref), (dW, np.asarray(dW_ref).reshape(R, L, HC, HC)),
                      (ds, np.asarray(ds_ref).reshape(R, 8, HC))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("L", [1, 2])
def test_runs_epilogue_at_one_run_is_the_single_run_epilogue(L):
    agg, params, gy = _inputs(L, R=1)
    one = [p[0] for p in _t(params)]
    runs = _t(params)
    a, g = torch.from_numpy(agg), torch.from_numpy(gy)
    assert torch.equal(cp.epilogue_fwd_runs(a, *runs, H, True),
                       cp.epilogue_fwd(a, *one, H, True))
    got = cp.epilogue_bwd_runs(a, g, *runs, H, True)
    want = cp.epilogue_bwd(a, g, *one, H, True)
    for x, w in zip(got, want):
        assert torch.equal(x.reshape(w.shape), w)


def test_runs_autograd_matches_per_run_autograd():
    """pma_epilogue_runs' gradients land on the right parameters: run r's
    equal the single-run autograd on run r's slice, bit for bit."""
    L = 2
    agg, params, gy = _inputs(L)
    targs = [torch.from_numpy(agg).requires_grad_()] + [
        torch.from_numpy(p).requires_grad_() for p in params]
    y = cp.pma_epilogue_runs(*targs, H, True)
    y.backward(torch.from_numpy(gy))
    for r in range(R):
        one = [torch.from_numpy(agg[:, r * WP:(r + 1) * WP]).requires_grad_()] + [
            torch.from_numpy(p[r]).requires_grad_() for p in params]
        y1 = cp.pma_epilogue(*one, H, True)
        y1.backward(torch.from_numpy(gy[:, r * HC:(r + 1) * HC]))
        assert torch.equal(y[:, r * HC:(r + 1) * HC], y1)
        assert torch.equal(targs[0].grad[:, r * WP:(r + 1) * WP], one[0].grad)
        for t, o in zip(targs[1:], one[1:]):
            assert torch.equal(t.grad[r], o.grad)


def test_runs_kernels_refuse_cpu_tensors():
    agg, params, gy = _inputs(1)
    _kernels.reset_launches()
    targs = _t(params)
    cp.pma_epilogue_runs(torch.from_numpy(agg), *targs, H, False)
    assert sum(_kernels.launches.values()) == 0
    with pytest.raises(ValueError):
        cp.epilogue_fwd_runs_cuda(torch.from_numpy(agg), *targs, H, False)
    with pytest.raises(ValueError):
        cp.epilogue_bwd_runs_cuda(torch.from_numpy(agg), torch.from_numpy(gy), *targs,
                                  H, False)


def test_segment_sum_at_folded_width_is_per_run_sums():
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 6, size=40)
    counts[5] = 300  # a hot segment
    indptr = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    n, W = int(indptr[-1]), 24
    msgs = torch.from_numpy(rng.normal(size=(n + 9, R * W)).astype(np.float32))
    msgs[n:] = float("nan")  # unread tail
    folded = segment_sum_plain(msgs, indptr, 40)
    for r in range(R):
        assert torch.equal(folded[:, r * W:(r + 1) * W],
                           segment_sum_plain(msgs[:, r * W:(r + 1) * W], indptr, 40))


@pytest.mark.parametrize("direction", ["v2e_split", "e2v_split"])
def test_dir_spmm_on_folded_tables_is_per_run(direction):
    hd = tsyn.scale_free_hypergraph(num_nodes=300, num_hyperedges=150,
                                    avg_edge_size=5, feature_dim=4, seed=5)
    inc = ttr.norm_construction(ttr.add_self_loops(hd), "all_one").to_incidence(bucket=64)
    d = getattr(inc, direction)()
    rows = d.num_src + (inc.num_nodes if direction == "e2v_split" else 0)
    rng = np.random.default_rng(2)
    W = 8
    w = torch.from_numpy(rng.normal(size=(rows, R * W)).astype(np.float32)).requires_grad_()
    out = dir_spmm(w, d)
    g = torch.from_numpy(rng.normal(size=tuple(out.shape)).astype(np.float32))
    out.backward(g)
    for r in range(R):
        cols = slice(r * W, (r + 1) * W)
        w1 = w.detach()[:, cols].clone().requires_grad_()
        o1 = dir_spmm(w1, d)
        o1.backward(g[:, cols])
        assert torch.equal(out.detach()[:, cols], o1.detach())
        assert torch.equal(w.grad[:, cols], w1.grad)
