"""The frozen cost arithmetic on known shapes: the walmart preset's 20-run
epoch (88,860 nodes, 69,906 hyperedges, 406,948 entries at seed 0), whose
per-kernel bounds PERF.md's kernel table lists from chip_smoke.py."""

import pytest

from hgbench import costs

WALMART = dict(N=88860, E=69906, nnz=406948, n_sl=88860 - 474, F=100, classes=11, layers=1,
               mlp_layers=2, HC=256, heads=8, cls_layers=1, cls_hidden=128)


def ms(cost_list):
    return round(costs.bound_s(cost_list) * 1e3, 3)


def test_epilogue_bounds_per_epoch():
    s = costs.Shapes(method="AllSetTransformer", groups=(20,), **WALMART)
    b = {k: ms(v) for k, v in costs.pma_epoch(s).items()}
    # K2R 15.737 ops, K3R's parts 15.737, 7.868 ops and 0.420 bytes,
    # K4 0.095 and K5 6.245 bytes (chip_smoke.py, PRs 12-13)
    assert b == {"K2R": 15.737, "K3a": 15.737, "K3b": 7.868, "K3c": 0.42, "K4": 0.095,
                 "K5": 6.245}
    assert ms(costs.exchange_epoch(s)["K1"]) == 6.012  # the gather inside K1, bytes


def test_layer_norm_bounds_per_epoch():
    s = costs.Shapes(method="AllDeepSets", groups=(10, 10), **WALMART)
    b = {k: ms(v) for k, v in costs.ln_epoch(s).items()}
    # B13 16.961 bytes (PR 19); B12 22.898 less the shared features of
    # each group's evaluation forward, read once and not once a run: 2 x 9
    # x 88,860 x 100 x 4 bytes
    assert b["B13"] == 16.961
    assert b["B12"] == pytest.approx(22.898 - 18 * 88860 * 100 * 4 / costs.HBM * 1e3, abs=2e-3)


def test_products_per_epoch():
    s = costs.Shapes(method="AllSetTransformer", groups=(20,), **WALMART)
    hyper = 69906 + 88860 - 474
    fwd = (2 * 2 * 88860 * 100 * 256 + 2 * 2 * hyper * 256 * 256  # V2E: lin_K, lin_V; rFF
           + 2 * 2 * hyper * 256 * 256 + 2 * 2 * 88860 * 256 * 256  # E2V
           + 2 * 88860 * 256 * 11)  # classifier
    assert costs.forward_flops(s) == fwd
    assert costs.epoch_flops(s) == 4 * 20 * fwd
    d = costs.Shapes(method="AllDeepSets", groups=(10, 10), **WALMART)
    dfwd = (2 * 88860 * (100 * 256 + 256 * 256) + 2 * hyper * 2 * 256 * 256
            + 2 * hyper * 2 * 256 * 256 + 2 * 88860 * 2 * 256 * 256 + 2 * 88860 * 256 * 11)
    assert costs.forward_flops(d) == dfwd


def test_bound_takes_the_larger_term():
    assert costs.bound_s([(3.35e12, [])]) == pytest.approx(1.0)
    assert costs.bound_s([(0, [(67e12, "f32")])]) == pytest.approx(1.0)
    assert costs.bound_s([(3.35e12, [(2 * 67e12, "f32")])]) == pytest.approx(2.0)
