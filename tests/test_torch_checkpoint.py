"""The port's checkpointing (``utils/checkpoint.py``) against the JAX
package's: EarlyStopping takes the same decisions (strikes, stop, best
loss and accuracy, which step's state it keeps) on one sequence of
(loss, accuracy) pairs, with and without a file; its snapshot is a
detached clone; save_checkpoint and load_checkpoint round-trip a runs
model's whole state (parameters and BatchNorm running statistics)."""

import numpy as np
import pytest
import torch

from allset_tpu.utils.checkpoint import EarlyStopping as JEarlyStopping
from allset_tpu_torch.models import SetGNN, SetGNNConfig
from allset_tpu_torch.utils.checkpoint import EarlyStopping, load_checkpoint, save_checkpoint

# (val loss, val acc): improvements, ties, strikes (loss up AND acc down),
# neither (loss up, acc up), a strike run long enough to stop at patience 3
SEQ = [(1.0, 0.5), (0.9, 0.55), (0.9, 0.55), (0.95, 0.6), (0.85, 0.5), (0.86, 0.49),
       (0.87, 0.48), (0.8, 0.62), (0.9, 0.4), (0.91, 0.3), (0.92, 0.2), (0.93, 0.1)]


@pytest.mark.parametrize("with_file", [False, True])
def test_early_stopping_decides_as_jax(with_file, tmp_path):
    path = str(tmp_path / "best.pt") if with_file else None
    jes, tes = JEarlyStopping(patience=3), EarlyStopping(patience=3, checkpoint_path=path)
    model = torch.nn.Linear(1, 1, bias=False)
    for step, (loss, acc) in enumerate(SEQ):
        with torch.no_grad():
            model.weight.fill_(step)
        want = jes.step(loss, acc, {"w": np.array(step, np.float32)})
        got = tes.step(loss, acc, model.state_dict())
        assert got == want, step
        assert (tes.counter, tes.best_loss, tes.best_acc) == (jes.counter, jes.best_loss,
                                                               jes.best_acc), step
        assert int(tes.best_state["weight"]) == int(jes.best_params["w"]), step
    assert tes.early_stop and jes.early_stop
    kept = int(jes.restore()["w"])
    assert int(tes.restore()["weight"]) == kept
    fresh = torch.nn.Linear(1, 1, bias=False)
    assert int(tes.restore(fresh).weight) == kept  # from the file when there is one


def test_early_stopping_snapshot_is_a_detached_clone():
    model = torch.nn.Linear(3, 2)
    es = EarlyStopping()
    es.step(1.0, 0.5, model.state_dict())
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    for k, v in es.best_state.items():
        assert torch.equal(v, before[k]) and not v.requires_grad


def test_save_and_load_round_trip_a_runs_model(tmp_path):
    cfg = SetGNNConfig(num_features=8, num_classes=3, all_num_layers=1, mlp_hidden=16,
                       classifier_hidden=16, pma=False, aggregate="add", normalization="bn")
    gens = [torch.Generator().manual_seed(r) for r in range(3)]
    model = SetGNN(cfg, gens)
    with torch.no_grad():
        for name, b in model.named_buffers():
            b.add_(torch.rand(b.shape, generator=gens[0]))  # running statistics off init
    path = str(tmp_path / "sub" / "runs.pt")
    save_checkpoint(path, model.state_dict())
    fresh = SetGNN(cfg, [torch.Generator().manual_seed(10 + r) for r in range(3)])
    assert load_checkpoint(path, fresh) is fresh
    state = load_checkpoint(path)
    assert set(state) == set(model.state_dict())
    assert any(k.endswith("BatchNorm_0.mean") for k in state)
    for k, v in model.state_dict().items():
        assert v.shape[0] == 3 and torch.equal(fresh.state_dict()[k], v), k
