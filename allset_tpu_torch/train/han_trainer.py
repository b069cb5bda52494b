"""HAN trainers with early stopping and the best state restored.

Counterpart of ``allset_tpu/train/han_trainer.py`` (reference
``src/DGL_HAN/main.py:82-177`` full batch, ``train_sampling.py:231-348``
sampled): per run a fresh split (the same ``rand_train_test_idx`` draws
as the JAX package's from ``default_rng(seed)``), a fresh model, torch
Adam with coupled weight decay, the masked NLL, the dual-criterion
EarlyStopping on the validation metrics, the best state restored, then
test accuracy and micro/macro F1, mean and std over runs. Early stopping
is data-dependent control flow, so the epoch loop runs on the host around
one step function (:func:`han_step`, :func:`sampled_step`).

Run r's model is drawn on the CPU from a generator seeded with
``run_seeds(seed, r)[0]``, its dropout masks on the batch's device from
one seeded with ``run_seeds(seed, r)[1]``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Tuple

import numpy as np
import torch

from allset_tpu_torch.data.sampler import HANNeighborSampler
from allset_tpu_torch.graph.batch import Batch, split_masks
from allset_tpu_torch.graph.transforms import rand_train_test_idx
from allset_tpu_torch.models.han import HAN, HANConfig, SampledHAN
from allset_tpu_torch.train.factory import make_optimizer
from allset_tpu_torch.train.trainer import masked_acc, masked_nll, run_seeds
from allset_tpu_torch.utils.checkpoint import EarlyStopping

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class HANTrainConfig:
    num_epochs: int = 200
    runs: int = 10
    lr: float = 0.005
    weight_decay: float = 0.001
    patience: int = 100
    train_prop: float = 0.5
    valid_prop: float = 0.25
    seed: int = 0


def f1_scores(y_true: np.ndarray, y_pred: np.ndarray) -> Tuple[float, float]:
    """(micro, macro) F1 with ``sklearn.metrics.f1_score``'s semantics: the
    labels are the union of y_true's and y_pred's, and a label with no true
    and no correct prediction scores 0."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if y_true.size == 0:
        return 0.0, 0.0
    labels = np.union1d(y_true, y_pred)
    t, p = np.searchsorted(labels, y_true), np.searchsorted(labels, y_pred)
    L = labels.shape[0]
    tp = np.bincount(t[y_true == y_pred], minlength=L).astype(np.float64)
    support = np.bincount(t, minlength=L) + np.bincount(p, minlength=L)  # 2tp + fp + fn
    micro = 2.0 * tp.sum() / support.sum()
    macro = float(np.mean(2.0 * tp / support))
    return float(micro), macro


def _generators(seed: int, run: int, device) -> Tuple[torch.Generator, torch.Generator]:
    init_seed, drop_seed = run_seeds(seed, run)
    return (torch.Generator().manual_seed(init_seed),
            torch.Generator(device=device).manual_seed(drop_seed))


def _summary(accs, micros, macros, times) -> Dict[str, float]:
    return {
        "test_acc_mean": float(np.mean(accs)),
        "test_acc_std": float(np.std(accs)),
        "micro_f1_mean": float(np.mean(micros)),
        "micro_f1_std": float(np.std(micros)),
        "macro_f1_mean": float(np.mean(macros)),
        "macro_f1_std": float(np.std(macros)),
        "time_per_run": float(np.mean(times)),
    }


def han_step(model: HAN, opt: torch.optim.Optimizer, batch: Batch,
             masks: Dict[str, Tensor], generator) -> Tuple[Tensor, Tensor, Tensor]:
    """One epoch of :func:`train_han`: a training step (dropout from
    ``generator``, the masked NLL over max(y, 0), Adam), then the
    evaluation forward after the update -> (loss, valid loss, valid
    accuracy), 0-d tensors on the batch's device."""
    y = batch.y.clamp_min(0)
    opt.zero_grad(set_to_none=True)
    loss = masked_nll(model(batch, True, generator), y, masks["train"])
    loss.backward()
    opt.step()
    with torch.no_grad():
        logits = model(batch, False)
        return loss.detach(), masked_nll(logits, y, masks["valid"]), masked_acc(
            logits, y, masks["valid"])


def train_han(model_cfg: HANConfig, batch: Batch, cfg: HANTrainConfig,
              verbose: bool = False) -> Dict[str, float]:
    """Full-batch HAN over ``batch`` (x and y over the combined V+E ids,
    y -1 on hyperedge rows, the metapath graphs in extras): ``cfg.runs``
    runs on the batch's device, each early-stopped and scored on its
    test split from its best state."""
    device = batch.x.device
    host_rng = np.random.default_rng(cfg.seed)
    y_host = batch.y.cpu().numpy()

    accs, micros, macros, times = [], [], [], []
    for run in range(cfg.runs):
        t0 = time.perf_counter()
        split = rand_train_test_idx(y_host, cfg.train_prop, cfg.valid_prop, rng=host_rng)
        masks = {k: m.to(device) for k, m in split_masks(split, batch.num_nodes).items()}
        init_gen, drop_gen = _generators(cfg.seed, run, device)
        model = HAN(model_cfg, init_gen).to(device)
        opt = make_optimizer(model, cfg.lr, cfg.weight_decay)
        stopper = EarlyStopping(patience=cfg.patience)
        for _ in range(cfg.num_epochs):
            _, val_loss, val_acc = han_step(model, opt, batch, masks, drop_gen)
            if stopper.step(float(val_loss), float(val_acc), model.state_dict()):
                break

        stopper.restore(model)
        with torch.no_grad():
            pred = model(batch, False).argmax(dim=-1).cpu().numpy()
        test_idx = np.asarray(split["test"])
        yt, yp = y_host[test_idx], pred[test_idx]
        acc = float((yt == yp).mean())
        micro, macro = f1_scores(yt, yp)
        accs.append(100 * acc)
        micros.append(100 * micro)
        macros.append(100 * macro)
        times.append(time.perf_counter() - t0)
        if verbose:
            print(f"run {run}: acc={acc:.4f} micro={micro:.4f} macro={macro:.4f}")
    return _summary(accs, micros, macros, times)


@dataclasses.dataclass(frozen=True)
class HANSampleConfig:
    """Sampled-HAN knobs (reference ``train_sampling.py`` defaults: batch
    32, 20 neighbours, 2x neighbours at evaluation)."""

    batch_size: int = 32
    num_neighbors: int = 20
    num_epochs: int = 200
    runs: int = 3
    lr: float = 0.005
    weight_decay: float = 0.001
    patience: int = 10
    train_prop: float = 0.5
    valid_prop: float = 0.25
    seed: int = 0


def block_tensors(blocks, device) -> Dict[str, Tensor]:
    """A sampler's blocks as SampledHAN's inputs on ``device``:
    ``{name}_src`` [B, K+1] int64 and ``{name}_mask`` [B, K+1] bool."""
    out = {}
    for name, b in blocks.items():
        out[f"{name}_src"] = torch.as_tensor(b.src).to(device)
        out[f"{name}_mask"] = torch.as_tensor(b.mask).to(device)
    return out


def sampled_step(model: SampledHAN, opt: torch.optim.Optimizer, x_full: Tensor, y: Tensor,
                 seeds: Tensor, blocks: Dict[str, Tensor], valid: Tensor, generator) -> Tensor:
    """One step of :func:`train_han_minibatch`: the NLL of the seeds'
    logits over max(y[seeds], 0), averaged over the valid (unpadded)
    seeds, then Adam -> the loss, a 0-d tensor."""
    opt.zero_grad(set_to_none=True)
    logp = torch.log_softmax(model(x_full, seeds, blocks, True, generator), dim=-1)
    yb = y.index_select(0, seeds).clamp_min(0)
    nll = -logp.gather(1, yb[:, None])[:, 0]
    v = valid.to(logp.dtype)
    loss = (nll * v).sum() / v.sum().clamp_min(1.0)
    loss.backward()
    opt.step()
    return loss.detach()


def train_han_minibatch(model_cfg: HANConfig, x_full: Tensor, y: Tensor,
                        sampler: HANNeighborSampler, cfg: HANSampleConfig,
                        verbose: bool = False) -> Dict[str, float]:
    """Mini-batch HAN (reference ``DGL_HAN/train_sampling.py:231-348``): per
    epoch, shuffled static-size seed batches; blocks sampled on the host;
    one step per batch on x_full's device; evaluation with 2x neighbours;
    dual-criterion early stopping on the validation accuracy; the best
    state restored."""
    device = x_full.device
    y_host = y.cpu().numpy()
    host_rng = np.random.default_rng(cfg.seed)

    def evaluate_ids(model, nids, k):
        preds, labels = [], []
        with torch.no_grad():
            for seeds, valid in sampler.batches(nids, cfg.batch_size, shuffle=False):
                blocks = block_tensors(sampler.sample(seeds, num_neighbors=k), device)
                logits = model(x_full, torch.as_tensor(seeds).to(device), blocks, False)
                preds.append(logits.argmax(dim=-1).cpu().numpy()[valid])
                labels.append(y_host[seeds[valid]])
        preds, labels = np.concatenate(preds), np.concatenate(labels)
        micro, macro = f1_scores(labels, preds)
        return float((preds == labels).mean()), micro, macro

    accs, micros, macros, times = [], [], [], []
    for run in range(cfg.runs):
        t0 = time.perf_counter()
        split = rand_train_test_idx(y_host, cfg.train_prop, cfg.valid_prop, rng=host_rng)
        init_gen, drop_gen = _generators(cfg.seed, run, device)
        model = SampledHAN(model_cfg, init_gen).to(device)
        opt = make_optimizer(model, cfg.lr, cfg.weight_decay)
        stopper = EarlyStopping(patience=cfg.patience)
        for _ in range(cfg.num_epochs):
            for seeds, valid in sampler.batches(split["train"], cfg.batch_size):
                blocks = block_tensors(sampler.sample(seeds), device)
                sampled_step(model, opt, x_full, y, torch.as_tensor(seeds).to(device), blocks,
                             torch.as_tensor(valid).to(device), drop_gen)
            val_acc, _, _ = evaluate_ids(model, split["valid"], 2 * cfg.num_neighbors)
            if stopper.step(-val_acc, val_acc, model.state_dict()):
                break

        stopper.restore(model)
        acc, micro, macro = evaluate_ids(model, split["test"], 2 * cfg.num_neighbors)
        accs.append(100 * acc)
        micros.append(100 * micro)
        macros.append(100 * macro)
        times.append(time.perf_counter() - t0)
        if verbose:
            print(f"run {run}: acc={acc:.4f} micro={micro:.4f} macro={macro:.4f}")
    return _summary(accs, micros, macros, times)
