"""The CLI flags that raised until they were ported: --remat, --plot and
--save_params.

--remat: the training forward under torch.utils.checkpoint, recomputed in
the backward, gives the bits of the forward without it, dropout on, with
'ln' and with 'bn': the logits, every gradient and the BatchNorm running
statistics (updated once), in one step and over a whole CLI run (its
metrics); the recompute does run. --plot writes a PNG. --save_params
saves each run's state at its best-valid epoch: loaded into a fresh
model, its evaluation gives each run's Final Test (the test accuracy the
summary reports), over folded groups too."""

import numpy as np
import pytest
import torch

from allset_tpu_torch import cli
from allset_tpu_torch.data import load_dataset
from allset_tpu_torch.models import build_model
from allset_tpu_torch.train import TrainConfig, Trainer, masked_acc, masked_nll
from allset_tpu_torch.train.factory import ExperimentConfig, prepare
from allset_tpu_torch.train.trainer import remat_forward
from allset_tpu_torch.utils.checkpoint import load_checkpoint

SMALL = dict(dname="synthetic", mlp_hidden=16, classifier_hidden=16, all_num_layers=1,
             classifier_num_layers=2)
MODES = {
    "AllSetTransformer-ln": dict(method="AllSetTransformer", heads=2),
    "AllSetTransformer-bn": dict(method="AllSetTransformer", heads=2, normalization="bn"),
    "AllDeepSets-bn": dict(method="AllDeepSets", normalization="bn"),
    "CEGCN-bn": dict(method="CEGCN", normalization="bn", all_num_layers=2),
}


def _prepared(mode):
    cfg = ExperimentConfig(**{**SMALL, **MODES[mode]})
    return prepare(cfg, load_dataset("synthetic", feature_noise=1.0, seed=0), "cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_remat_step_is_bit_identical(mode):
    mcfg, batch = _prepared(mode)
    mask = torch.arange(batch.num_nodes) % 2 == 0
    got = []
    for remat in (False, True):
        model = build_model(mcfg, [torch.Generator().manual_seed(r) for r in range(2)])
        gens = [torch.Generator().manual_seed(100 + r) for r in range(2)]
        calls = []

        def forward():
            calls.append(1)
            return model(batch, True, gens)

        logits = remat_forward(model, forward, gens) if remat else forward()
        masked_nll(logits, batch.y, mask[:, None].expand(-1, 2)).sum().backward()
        assert len(calls) == (2 if remat else 1)  # the backward recomputed the forward
        state = {k: v.clone() for k, v in model.state_dict().items()}
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        got.append((logits.detach(), state, grads, [g.get_state() for g in gens]))
    (l0, s0, g0, r0), (l1, s1, g1, r1) = got
    assert torch.equal(l0, l1)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)  # running statistics updated once
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(a, b) for a, b in zip(r0, r1))  # generators where they were


@pytest.mark.parametrize("mode", ["AllSetTransformer-ln", "AllDeepSets-bn"])
def test_remat_cli_run_is_bit_identical(mode, tmp_path):
    over = MODES[mode]
    base = ["--device", "cpu", "--dname", "synthetic", "--runs", "2", "--epochs", "3",
            "--MLP_hidden", "16", "--Classifier_hidden", "16", "--All_num_layers", "1",
            "--res_root", str(tmp_path), "--method", over["method"]]
    if "normalization" in over:
        base += ["--normalization", over["normalization"]]
    plain, remat = cli.run(base), cli.run(base + ["--remat"])
    assert np.array_equal(plain.metrics, remat.metrics)


def test_plot_writes_a_png(tmp_path):
    path = tmp_path / "curves.png"
    cli.run(["--device", "cpu", "--dname", "synthetic", "--runs", "2", "--epochs", "3",
             "--MLP_hidden", "16", "--res_root", str(tmp_path), "--plot", str(path)])
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("mode,chunk", [("AllSetTransformer-ln", None),
                                        ("AllDeepSets-bn", 2), ("CEGCN-bn", None)])
def test_saved_params_reproduce_final_test(mode, chunk, tmp_path):
    over = MODES[mode]
    path = str(tmp_path / "best.pt")
    argv = ["--device", "cpu", "--dname", "synthetic", "--runs", "3", "--epochs", "8",
            "--MLP_hidden", "16", "--Classifier_hidden", "16", "--All_num_layers",
            str(over.get("all_num_layers", 1)), "--Classifier_num_layers", "2",
            "--res_root", str(tmp_path), "--method", over["method"], "--save_params", path]
    if "heads" in over:
        argv += ["--heads", str(over["heads"])]
    if "normalization" in over:
        argv += ["--normalization", over["normalization"]]
    if chunk:
        argv += ["--vmap_chunk", str(chunk)]
    res = cli.run(argv)
    if chunk:
        assert res.groups == [2, 1]
    best = res.best_by_valid()["best_epoch"]
    final_test = res.metrics[np.arange(3), best, 2]
    if mode != "AllSetTransformer-ln":  # a best-valid epoch before the last: the
        assert (best < 7).any()         # final epoch's state would not do

    mcfg, batch = _prepared(mode)
    model = load_checkpoint(path, build_model(mcfg, [torch.Generator() for _ in range(3)]))
    masks = Trainer(mcfg, batch, TrainConfig(runs=3)).masks()
    with torch.no_grad():
        acc = masked_acc(model(batch, False), batch.y, masks["test"])
    np.testing.assert_array_equal(acc.numpy(), final_test)
    assert res.params is not None and set(res.params) == set(model.state_dict())
