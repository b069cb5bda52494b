"""The system under test, driven through its own entry as its CLI drives
it: ``train.factory.prepare`` on the graph's arrays, then
``train.trainer.Trainer(...).fit()`` on the cell's job. This is the only
module of the benchmark that imports the program.

``Capture`` reads, from the optimizers the program builds inside
``fit``, what the comparison needs of a job's first steps: each leaf's
first gradient as Adam got it (its first moment after one step, over 1 -
beta1) and each leaf's change over the steps. It hooks every optimizer
step of the process while it is entered, so it is entered only around
set-up's check job, never around the window.
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from allset_tpu_torch.graph.transforms import HyperData
from allset_tpu_torch.train.factory import ExperimentConfig, prepare
from allset_tpu_torch.train.trainer import Results, TrainConfig, Trainer

from hgbench.graphs import Graph

# configuration key (the reference's flag) -> ExperimentConfig field
FLAGS = {"method": "method", "All_num_layers": "all_num_layers",
         "MLP_num_layers": "mlp_num_layers", "MLP_hidden": "mlp_hidden",
         "Classifier_num_layers": "classifier_num_layers",
         "Classifier_hidden": "classifier_hidden", "heads": "heads", "dropout": "dropout",
         "lr": "lr", "wd": "wd", "normalization": "normalization",
         "add_self_loop": "add_self_loop", "normtype": "normtype", "aggregate": "aggregate",
         "deepset_input_norm": "deepset_input_norm", "GPR": "gpr", "LearnMask": "learn_mask",
         "dtype": "dtype"}


@dataclasses.dataclass
class System:
    """The prepared program: a Trainer for the check job and one for the
    window's jobs, both on the one batch ``prepare`` made."""

    check: Trainer
    job: Trainer


def prepare_system(config: dict, job: dict, graph: Graph, seed: int, check_steps: int,
                   device) -> System:
    cfg = ExperimentConfig(seed=seed, epochs=job["epochs"], runs=job["runs"],
                           train_prop=job["train_prop"], valid_prop=job["valid_prop"],
                           **{f: config[k] for k, f in FLAGS.items() if k in config})
    data = HyperData(x=graph.x, y=graph.y, node=graph.node, edge=graph.edge,
                     num_nodes=graph.num_nodes, num_hyperedges=graph.num_hyperedges)
    model_cfg, batch = prepare(cfg, data, device)
    tc = TrainConfig(epochs=job["epochs"], runs=job["runs"], lr=cfg.lr, wd=cfg.wd,
                     train_prop=cfg.train_prop, valid_prop=cfg.valid_prop,
                     vmap_chunk=job.get("vmap_chunk"), seed=seed)
    return System(check=Trainer(model_cfg, batch, dataclasses.replace(tc, epochs=check_steps)),
                  job=Trainer(model_cfg, batch, tc))


def losses(res: Results, steps: int) -> Dict[str, np.ndarray]:
    """A job's losses of its first ``steps`` epochs: ``train_loss`` [R,
    steps] and ``eval_loss`` [R, steps, 2] (validation, test)."""
    m = np.asarray(res.metrics, dtype=np.float64)
    return {"train_loss": m[:, :steps, 3], "eval_loss": m[:, :steps, 4:6]}


class Capture:
    """While entered, reads every Adam the program steps: per optimizer
    (a group of folded runs, in the order the groups run) each leaf's
    first-gradient norm [R, leaves] and, after ``steps`` steps, each
    leaf's change norm [R, leaves]; a leaf is one run's slice of a
    parameter."""

    def __init__(self, steps: int):
        self.steps = steps
        self.groups: List[dict] = []
        self.times: List[float] = []  # host clock at each step's end
        # by the optimizer itself: a freed group's id may come back
        self._by_opt = weakref.WeakKeyDictionary()
        self._handles = []

    @staticmethod
    def _params(opt) -> List[torch.Tensor]:
        return [p for g in opt.param_groups for p in g["params"]]

    @staticmethod
    def _norms(ts) -> np.ndarray:
        return torch.stack([t.detach().float().flatten(1).norm(dim=1) for t in ts],
                           dim=1).cpu().numpy().astype(np.float64)

    def _pre(self, opt, args, kwargs):
        st = self._by_opt.get(opt)
        if st is None:
            st = {"n": 0, "start": [p.detach().clone() for p in self._params(opt)],
                  "grad": None, "update": None}
            self._by_opt[opt] = st
            self.groups.append(st)

    def _post(self, opt, args, kwargs):
        self.times.append(time.time())
        st = self._by_opt[opt]
        st["n"] += 1
        params = self._params(opt)
        if st["n"] == 1:
            b1 = opt.param_groups[0]["betas"][0]
            st["grad"] = self._norms([opt.state[p]["exp_avg"] / (1 - b1)
                                      if "exp_avg" in opt.state[p]
                                      else torch.full_like(p, float("nan"))  # no moment kept
                                      for p in params])
        if st["n"] == self.steps:
            st["update"] = self._norms([p - s for p, s in zip(params, st["start"])])
            st["start"] = None

    def __enter__(self):
        from torch.optim.optimizer import (register_optimizer_step_post_hook,
                                           register_optimizer_step_pre_hook)

        self._handles = [register_optimizer_step_pre_hook(self._pre),
                         register_optimizer_step_post_hook(self._post)]
        return self

    def __exit__(self, *exc):
        for h in self._handles:
            h.remove()
        self._handles = []

    def readings(self) -> Optional[Dict[str, np.ndarray]]:
        """``grad`` and ``update`` [runs, leaves] over all groups, or None
        where a group did not reach ``steps`` steps."""
        if not self.groups or any(g["update"] is None for g in self.groups):
            return None
        return {k: np.concatenate([g[k] for g in self.groups]) for k in ("grad", "update")}
