"""Training step: masked NLL and torch Adam.

Counterpart of the parts of ``allset_tpu/train/trainer.py`` that the
benchmark step runs: ``masked_nll`` and the optimizer that the JAX
package's ``torch_adam`` imitates (``torch.optim.Adam``, L2 weight decay
into the gradient before the moments). The full Trainer, the runs
protocol and the CLI come in a later port PR.
"""

from __future__ import annotations

import torch

from allset_tpu_torch.graph.batch import Batch


def masked_nll(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean NLL(log_softmax(logits)) over ``mask``."""
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, y[:, None]).squeeze(1)
    m = mask.to(logp.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def train_steps(model: torch.nn.Module, batch: Batch, train_mask: torch.Tensor,
                steps: int, lr: float = 1e-3, optimizer=None) -> torch.Tensor:
    """Run ``steps`` full-batch steps (forward, backward, Adam) and return
    the per-step losses [steps] on the batch's device. The forward runs
    with ``train=False``, as the benchmark step does. Pass ``optimizer`` to
    continue from an earlier call's Adam state."""
    if optimizer is None:
        optimizer = torch.optim.Adam(model.parameters(), lr=lr, weight_decay=0.0)
    losses = []
    for _ in range(steps):
        optimizer.zero_grad(set_to_none=True)
        loss = masked_nll(model(batch, False), batch.y, train_mask)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    return torch.stack(losses)
