"""The reference's first steps of a job: each run initialised from its own
generator, ``steps`` full-batch steps of masked NLL and Adam, and the
evaluation forward after each, as the runs protocol of the AllSet code
trains (``src/train.py:458-499``).

Adam is torch's, written out: m <- b1 m + (1 - b1) g, v <- b2 v + (1 - b2)
g^2, p <- p - lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps),
with the configuration's weight decay added to the gradient.

What it returns are the numbers the comparison reads, per run: the
training loss of each step (the forward with dropout, before the step),
the validation and test losses after each step, the norm of each leaf's
first gradient, and the norm of each leaf's change over the steps.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from hgbench.graphs import Graph
from hgbench.reference import model as ref
from hgbench.reference.seeds import dropout_generator, init_generator, split_masks

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def follow(config: dict, job: dict, graph: Graph, seed: int, steps: int, device,
           runs: Optional[Sequence[int]] = None, mm: Callable = ref.plain_mm,
           half_batch: bool = False) -> dict:
    """The reference's readings of the job's first ``steps`` steps for
    each of ``runs`` (all the job's runs by default): ``train_loss`` [R,
    steps], ``eval_loss`` [R, steps, 2] (validation, test), ``grad`` [R,
    leaves] and ``update`` [R, leaves] norms, and the leaf ``names``.
    ``half_batch`` takes each loss over the first half of the training
    rows only (a fault the comparison has to catch)."""
    device = torch.device(device)
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _follow(config, job, graph, seed, steps, device, runs, mm, half_batch)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _follow(config, job, graph, seed, steps, device, runs, mm, half_batch):
    m = ref.model_of(config, graph)
    s = ref.structure(graph, device)
    fwd = ref.Forward(m, s, mm)
    x = torch.from_numpy(graph.x).to(device)
    y = torch.from_numpy(graph.y).to(device)
    runs = list(range(job["runs"])) if runs is None else list(runs)
    splits = split_masks(graph.y, job["runs"], job["train_prop"], job["valid_prop"], seed)
    lr, wd = config["lr"], config["wd"]
    b1, b2 = BETAS
    out = {"train_loss": [], "eval_loss": [], "grad": [], "update": []}
    for r in runs:
        rows = {k: torch.from_numpy(np.flatnonzero(v)).to(device) for k, v in splits[r].items()}
        train_rows = rows["train"][: len(rows["train"]) // 2] if half_batch else rows["train"]
        p0 = ref.init_params(m, init_generator(seed, r))
        names = list(p0)
        params = [t.to(device).requires_grad_(True) for t in p0.values()]
        start = [t.detach().clone() for t in params]
        gen = dropout_generator(seed, r, device)
        mom = [torch.zeros_like(t) for t in params]
        sq = [torch.zeros_like(t) for t in params]
        losses, evals = [], []
        for t in range(1, steps + 1):
            loss = ref.masked_nll(fwd(x, dict(zip(names, params)), True, gen), y, train_rows)
            grads = torch.autograd.grad(loss, params)
            losses.append(loss.item())
            if t == 1:
                out["grad"].append([g.norm().item() for g in grads])
            with torch.no_grad():
                for p, g, m1, m2 in zip(params, grads, mom, sq):
                    if wd:
                        g = g + wd * p
                    m1.mul_(b1).add_(g, alpha=1 - b1)
                    m2.mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (m2.sqrt() / (1 - b2 ** t) ** 0.5).add_(ADAM_EPS)
                    p.addcdiv_(m1, denom, value=-lr / (1 - b1 ** t))
                logits = fwd(x, dict(zip(names, params)), False)
                evals.append([ref.masked_nll(logits, y, rows["valid"]).item(),
                              ref.masked_nll(logits, y, rows["test"]).item()])
        out["train_loss"].append(losses)
        out["eval_loss"].append(evals)
        out["update"].append([(p.detach() - p0).norm().item() for p, p0 in zip(params, start)])
        del params, start, mom, sq
    res = {k: np.asarray(v, dtype=np.float64) for k, v in out.items()}
    res["names"] = names
    return res
