"""Checkpointing: save and restore a model's state, and EarlyStopping.

Counterpart of ``allset_tpu/utils/checkpoint.py``. The JAX package writes
a flax parameter tree as msgpack bytes; here a ``state_dict`` (parameters
and buffers, the BatchNorms' running statistics included) goes to disk
with ``torch.save``. A runs model's tensors carry the leading [R] axis.
The reference's only checkpointing is the HAN vertical's EarlyStopping
(``src/DGL_HAN/utils.py:369-404``): the best state to a file, reloaded
before the final test.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Mapping, Optional

import torch


def save_checkpoint(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """Write ``state`` ({name: tensor}, e.g. a ``state_dict``) to ``path``;
    the tensors are moved to the CPU, so the file loads without a card."""
    os.makedirs(osp.dirname(osp.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state.items()}, path)


def load_checkpoint(path: str, model: Optional[torch.nn.Module] = None):
    """The {name: tensor} dict ``save_checkpoint`` wrote; with ``model``,
    loaded into it (strictly: every name must match) and the model
    returned."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if model is None:
        return state
    model.load_state_dict(state)
    return model


class EarlyStopping:
    """The reference's dual-criterion early stopper
    (``src/DGL_HAN/utils.py:380-396``): count a strike when the validation
    loss rose AND the accuracy fell; snapshot the state when loss <= best
    AND acc >= best. The snapshot is a detached clone (and, with
    ``checkpoint_path``, a file)."""

    def __init__(self, patience: int = 10, checkpoint_path: Optional[str] = None):
        self.patience = patience
        self.checkpoint_path = checkpoint_path
        self.counter = 0
        self.best_loss: Optional[float] = None
        self.best_acc: Optional[float] = None
        self.best_state: Optional[dict] = None
        self.early_stop = False

    def step(self, loss: float, acc: float, state: Mapping[str, torch.Tensor]) -> bool:
        if self.best_loss is None:
            self.best_loss, self.best_acc = loss, acc
            self._save(state)
        elif loss > self.best_loss and acc < self.best_acc:
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            if loss <= self.best_loss and acc >= self.best_acc:
                self._save(state)
            self.best_loss = min(loss, self.best_loss)
            self.best_acc = max(acc, self.best_acc)
            self.counter = 0
        return self.early_stop

    def _save(self, state: Mapping[str, torch.Tensor]) -> None:
        self.best_state = {k: v.detach().clone() for k, v in state.items()}
        if self.checkpoint_path is not None:
            save_checkpoint(self.checkpoint_path, state)

    def restore(self, model: Optional[torch.nn.Module] = None):
        """The best state; with ``model``, loaded into it (from the file
        when there is one) and the model returned."""
        if model is None:
            return self.best_state
        if self.checkpoint_path is not None:
            return load_checkpoint(self.checkpoint_path, model)
        model.load_state_dict(self.best_state)
        return model
