"""The comparison's control and faults.

The control is the reference computed in TF32, the precision below the
configurations' float32: it has to come out as not correct. Each fault
breaks the timed path underneath a whole run (its look for a card
skipped, at a tiny size on the CPU), and ``correct`` has to come out
false: a step that returns its state unchanged; half of the batch left
out of the loss, the mean taken over the rest; an answer (a loss the job
reports) altered where it is produced. A cell on one card has no
exchange between cards to leave out.
"""

import numpy as np
import pytest
import torch

from hgbench import compare, control, graphs, manifest, run
from hgbench.reference.follow import follow
from tiny import tiny_cell


def test_tf32_rounding():
    t = torch.tensor([1 + 2**-11, 1 + 3 * 2**-11, -1 - 3 * 2**-11, 1 + 2**-10, 0.0])
    assert control.to_tf32(t).tolist() == [1.0, 1 + 2**-9, -1 - 2**-9, 1 + 2**-10, 0.0]


@pytest.mark.parametrize("workload", ["ast-walmart-r20", "ads-walmart-r20"])
def test_control_reads_above_the_program(workload):
    """At the tiny size the TF32 control reads at least three times the
    program's plain path on a number, on each of three seeds."""
    cell = tiny_cell(workload)
    job = cell.traffic["job"]
    for seed in (5, 6, 7):
        g = graphs.make_graph(cell.traffic["graph"], seed)
        ref = follow(cell.config, job, g, seed, 3, "cpu")
        prog = control.program_numbers(cell, seed, "cpu", 3, ref)
        ctl = control.versus(follow(cell.config, job, g, seed, 3, "cpu", mm=control.tf32_mm),
                             ref)
        assert any(ctl[k] >= 3 * prog[k] for k in compare.NAMES), (prog, ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ast-walmart-r20", "ads-walmart-r20",
                                      "ast-scalefree-r20"])
def test_control_fails_the_cell(workload):
    """At the cell's own size on the card: the control fails the cell's
    limits on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's size")
    cell = manifest.cell(workload)
    job = cell.traffic["job"]
    for seed in (101, 102, 103):
        g = graphs.make_graph(cell.traffic["graph"], seed)
        ref = follow(cell.config, job, g, seed, run.CHECK_STEPS, "cuda")
        ctl = control.versus(follow(cell.config, job, g, seed, run.CHECK_STEPS, "cuda",
                                    mm=control.tf32_mm), ref)
        assert not compare.judge(ctl, cell.limits), ctl


def _sound_then_broken(monkeypatch, break_it, workload="ast-walmart-r20"):
    cell = tiny_cell(workload)
    assert run.run(cell, 21, 0.05, False, device="cpu")["correct"]
    break_it(monkeypatch)
    out = run.run(cell, 21, 0.05, False, device="cpu")
    return out


def test_fault_state_unchanged(monkeypatch):
    def break_it(mp):
        mp.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)

    out = _sound_then_broken(monkeypatch, break_it)
    assert not out["correct"], out["checks"]


def test_fault_half_batch(monkeypatch):
    from allset_tpu_torch.train import trainer

    real = trainer.masked_nll

    def half(logits, y, mask):
        if mask.dim() == 2 and logits.requires_grad:  # the training loss of the runs
            rows = torch.cumsum(mask.to(torch.int64), dim=0)
            mask = mask & (rows <= (mask.sum(dim=0, keepdim=True) // 2))
        return real(logits, y, mask)

    out = _sound_then_broken(monkeypatch, lambda mp: mp.setattr(trainer, "masked_nll", half))
    assert not out["correct"], out["checks"]
    assert out["checks"]["train_loss"]["value"] > out["checks"]["train_loss"]["limit"]


def test_fault_answer_altered(monkeypatch):
    from allset_tpu_torch.train.trainer import Trainer

    real = Trainer._eval

    def altered(self, model, masks, train_loss):
        m = real(self, model, masks, train_loss)
        return torch.cat([m[:, :4], m[:, 4:5] * (1 + 1e-2), m[:, 5:]], dim=1)

    out = _sound_then_broken(monkeypatch, lambda mp: mp.setattr(Trainer, "_eval", altered),
                             "ads-walmart-r20")
    assert not out["correct"]
    assert out["checks"]["eval_loss"]["value"] > out["checks"]["eval_loss"]["limit"]
    assert np.isfinite(out["checks"]["grad"]["value"])
