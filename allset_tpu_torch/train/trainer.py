"""Full-batch trainer and the statistical runs protocol.

Counterpart of ``allset_tpu/train/trainer.py``. The reference trains
``runs`` random splits of ``epochs`` epochs each (``src/train.py:458-499``):
per epoch a full-batch training step (forward with dropout, masked NLL,
backward, Adam) and an evaluation forward; per run the epoch with the
best validation accuracy gives the reported test accuracy, and the runs
aggregate as mean +- std (ddof=1), as the reference Logger does.

The JAX package vmaps the runs; here the runs ride an explicit leading
[R] axis of the parameters and are folded into the width of every sparse
exchange and fused-epilogue launch, so R runs share each kernel launch
(``vmap_runs``). The runs go in groups whose size follows the free device
memory; without ``vmap_runs`` every group holds one run. Runs do not
depend on their group: run r's split is the r-th draw of
``numpy.random.default_rng(seed)``, its parameter init and its dropout
masks come from generators seeded by :func:`run_seeds`, and Adam is
elementwise, so one Adam over the stacked parameters is per-run Adam.

Metrics stay on the device as [R, epochs, 6] (train/valid/test accuracy,
train/valid/test loss) until a group ends.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from allset_tpu_torch.graph.batch import Batch, split_masks
from allset_tpu_torch.graph.transforms import rand_train_test_idx
from allset_tpu_torch.models.setgnn import SetGNN, SetGNNConfig
from allset_tpu_torch.nn.modules import packed_width


# [rows, hid] tables an AllDeepSets layer keeps per run at its peak
# (Trainer._bytes_per_run)
DEEPSETS_TABLES = 14


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 500
    runs: int = 20
    lr: float = 1e-3
    wd: float = 0.0
    train_prop: float = 0.5
    valid_prop: float = 0.25
    vmap_runs: bool = True  # fold the runs into each launch
    # runs per group: None = as many as the free device memory holds,
    # halved on a device out-of-memory error
    vmap_chunk: Optional[int] = None
    eval_every: int = 1  # reference evaluates every epoch (train.py:486)
    # reference-format progress lines every display_step epochs (> 0),
    # printed from the metrics once the runs have finished
    display_step: int = -1
    seed: int = 0


def run_seeds(seed: int, run: int) -> tuple:
    """(init seed, dropout seed) of run ``run``: the two 64-bit words of
    ``numpy.random.SeedSequence([seed, run])``. Run r's parameters are
    drawn on the CPU from a generator with the first, its dropout masks on
    the batch's device from a generator with the second."""
    a, b = np.random.SeedSequence([seed, run]).generate_state(2, dtype=np.uint64)
    return int(a), int(b)


def masked_nll(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean NLL(log_softmax(logits)) over ``mask``: logits [N, C] and mask
    [N] give a scalar; logits [N, R, C] and mask [N, R] give [R]. The
    label pick is a one-hot compare, so a label of -1 (unlabelled) picks
    nothing, as in the JAX package."""
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.arange(logp.shape[-1], device=logp.device) == y.view(
        (-1,) + (1,) * (logp.dim() - 1))
    nll = -torch.where(onehot, logp, torch.zeros((), device=logp.device)).sum(dim=-1)
    m = mask.to(logp.dtype)
    return (nll * m).sum(dim=0) / m.sum(dim=0).clamp_min(1.0)


def masked_acc(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Accuracy of argmax(logits) over ``mask``; shapes as masked_nll."""
    pred = logits.argmax(dim=-1)
    m = mask.to(torch.float32)
    hit = (pred == y.view((-1,) + (1,) * (pred.dim() - 1))).to(torch.float32)
    return (hit * m).sum(dim=0) / m.sum(dim=0).clamp_min(1.0)


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


def count_params(model: torch.nn.Module, runs: Optional[int]) -> int:
    """Parameters of one run (a runs axis is divided out)."""
    total = sum(p.numel() for p in model.parameters())
    return total // runs if runs else total


class Trainer:
    """The runs protocol for one SetGNN configuration on one Batch; the
    batch's device decides where everything runs."""

    def __init__(self, model_cfg: SetGNNConfig, batch: Batch, cfg: TrainConfig):
        self.model_cfg = model_cfg
        self.batch = batch
        self.cfg = cfg
        self.device = batch.x.device

    # --- per group of runs ---

    def _init(self, runs: Sequence[int]) -> SetGNN:
        """A model holding ``runs`` (a leading runs axis on every
        parameter), run r initialised from its own CPU generator."""
        gens = [torch.Generator().manual_seed(run_seeds(self.cfg.seed, r)[0]) for r in runs]
        return SetGNN(self.model_cfg, gens).to(self.device)

    def _apply(self, model: SetGNN, train: bool, generators) -> torch.Tensor:
        """Logits [N, R, C]."""
        return model(self.batch, train, generators)

    def _eval(self, model, masks, train_loss) -> torch.Tensor:
        """The evaluation forward -> metrics [R, 6]."""
        y = self.batch.y
        with torch.no_grad():
            logits = self._apply(model, False, None)
            return torch.stack([
                masked_acc(logits, y, masks["train"]),
                masked_acc(logits, y, masks["valid"]),
                masked_acc(logits, y, masks["test"]),
                train_loss,
                masked_nll(logits, y, masks["valid"]),
                masked_nll(logits, y, masks["test"]),
            ], dim=1)

    def _run_group(self, runs: Sequence[int], masks: Dict[str, torch.Tensor]):
        """Train the runs of one group together -> (metrics [R, epochs, 6]
        on the device, the parameter count of one run)."""
        cfg = self.cfg
        model = self._init(runs)
        gens = [torch.Generator(device=self.device).manual_seed(run_seeds(cfg.seed, r)[1])
                for r in runs]
        opt = torch.optim.Adam(model.parameters(), lr=cfg.lr, weight_decay=cfg.wd)
        k = max(1, cfg.eval_every)
        metrics = torch.zeros(len(runs), cfg.epochs, 6, device=self.device)
        prev = torch.zeros(len(runs), 6, device=self.device)
        for ep in range(cfg.epochs):
            opt.zero_grad(set_to_none=True)
            loss = masked_nll(self._apply(model, True, gens), self.batch.y, masks["train"])
            loss.sum().backward()  # run r's gradient is that of its own loss
            opt.step()
            # off epochs repeat the last evaluated metrics (JAX eval_every)
            if (ep + 1) % k == 0 or ep == cfg.epochs - 1:
                prev = self._eval(model, masks, loss.detach())
            metrics[:, ep] = prev
        return metrics, count_params(model, len(runs))

    # --- group sizing ---

    def _bytes_per_run(self) -> int:
        """Device bytes one folded run adds at its peak: the classifier's
        hidden and output tables; under GPR the f32 [N, hid, L+1] stack and
        about four [N, hid] f32 tables of gpr_mlp; LearnMask's importance
        and its two Adam moments. Per half-layer of AllSetTransformer: one
        gathered [nnz, WP] message table, about three [rows, WP]-wide
        tables kept for the backward (the pack's GEMM output, the
        aggregate, the output) and K3R's per-run scratch (the rFF inputs
        and output gradients). Of AllDeepSets: one gathered [nnz, hid]
        table and DEEPSETS_TABLES [rows, hid] tables per layer (f_enc's and
        f_dec's activations, the LayerNorm inputs and dropout masks kept
        for the backward, the reduce's output), and under LearnMask the
        SDDMM's gathered rows and product, three f32 [nnz, hid] tables.
        The exchange is unsplit under LearnMask or without the self-loop
        split: then the V->E output has one row per hyperedge instead of
        the N-slot layout's real edges + N. On an H100 at the walmart
        preset in f32 this gives 1.78, 2.29, 1.88 and 1.18 GiB for
        AllSetTransformer (the preset, GPR, LearnMask, no self-loops)
        against measured peaks of 1.69, 2.18, 1.78 and 1.09 GiB per run,
        and 3.740 GiB for AllDeepSets against a measured 3.634 (PERF.md
        has the LearnMask figure)."""
        mc, inc = self.model_cfg, self.batch.inc
        item = 2 if mc.dtype == "bfloat16" else 4
        HC, L = mc.mlp_hidden, mc.all_num_layers
        WP = packed_width(HC, mc.heads)
        N = inc.num_nodes
        if inc.real is None or mc.learn_mask:
            nnz, rows_v2e = inc.nnz, inc.num_edges
        else:
            nnz, rows_v2e = inc.real.nnz, inc.real.num_edges + N
        rows = rows_v2e + N
        total = 4 * N * (mc.classifier_hidden + mc.num_classes)
        if L > 0 and mc.pma:
            total += item * WP * (nnz + 3 * rows * L)  # tables
            total += mc.mlp_num_layers * rows_v2e * HC * (item + 4)  # K3R scratch
        elif L > 0:
            total += item * HC * (nnz + DEEPSETS_TABLES * rows * L)
            if mc.learn_mask:  # the SDDMM's three f32 [nnz, hid] tables, one exchange at a time
                total += 3 * 4 * HC * nnz
        if mc.gpr and L > 0:
            total += 4 * N * HC * (L + 5)
        if mc.learn_mask:
            total += 3 * 4 * inc.nnz_padded
        return total

    def _group_size(self) -> int:
        cfg = self.cfg
        if not cfg.vmap_runs:
            return 1
        if cfg.vmap_chunk:
            return min(cfg.vmap_chunk, cfg.runs)
        if self.device.type != "cuda":
            return cfg.runs
        free, _ = torch.cuda.mem_get_info(self.device)
        # blocks PyTorch holds in its cache are free to this process too
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        return max(1, min(cfg.runs, int(0.9 * free) // self._bytes_per_run()))

    # --- the protocol ---

    def fit(self) -> "Results":
        cfg = self.cfg
        n = self.batch.num_nodes
        host_rng = np.random.default_rng(cfg.seed)
        y_host = self.batch.y.cpu().numpy()
        split = [split_masks(rand_train_test_idx(y_host, cfg.train_prop, cfg.valid_prop,
                                                 rng=host_rng), n)
                 for _ in range(cfg.runs)]
        # [N, runs] per split, on the device
        masks = {k: torch.stack([s[k] for s in split], dim=1).to(self.device)
                 for k in ("train", "valid", "test")}

        group = self._group_size()
        if cfg.vmap_runs and group < cfg.runs:
            print(f"[trainer] folding runs in groups of {group}")
        t0 = time.time()
        mets, groups, num_params = [], [], 0
        lo = 0
        while lo < cfg.runs:
            hi = min(lo + group, cfg.runs)
            try:
                m, num_params = self._run_group(
                    range(lo, hi), {k: v[:, lo:hi] for k, v in masks.items()})
            except torch.cuda.OutOfMemoryError:
                if group == 1:
                    raise
                m = None
            if m is None:
                # halve and retry THIS group: finished groups are kept (the
                # failed group's tensors are released once the handler ends)
                group = (group + 1) // 2
                torch.cuda.empty_cache()
                print(f"[trainer] device memory exhausted; retrying with "
                      f"{group} runs per group")
                continue
            mets.append(m.cpu())
            groups.append(hi - lo)
            lo = hi
        wall = time.time() - t0
        metrics = torch.cat(mets).numpy()
        if cfg.display_step > 0:
            self._print_progress(metrics)
        return Results(metrics=metrics, wall_time=wall, num_params=num_params,
                       groups=groups)

    def _print_progress(self, metrics: np.ndarray) -> None:
        """Reference-format per-epoch lines (``src/train.py:489-496``),
        one block per run, every ``display_step`` epochs."""
        step = self.cfg.display_step
        for run in range(metrics.shape[0]):
            for epoch in range(0, metrics.shape[1], step):
                m = metrics[run, epoch]
                print(
                    f"Epoch: {epoch:02d}, "
                    f"Train Loss: {m[3]:.4f}, "
                    f"Valid Loss: {m[4]:.4f}, "
                    f"Test  Loss: {m[5]:.4f}, "
                    f"Train Acc: {100 * m[0]:.2f}%, "
                    f"Valid Acc: {100 * m[1]:.2f}%, "
                    f"Test  Acc: {100 * m[2]:.2f}%"
                )


@dataclasses.dataclass
class Results:
    """Reference-Logger-compatible statistics (``src/train.py:118-150``)."""

    metrics: np.ndarray  # [runs, epochs, 6] = train/val/test acc, 3 losses
    wall_time: float
    num_params: int
    groups: List[int] = dataclasses.field(default_factory=list)  # runs per group

    def best_by_valid(self) -> Dict[str, object]:
        acc = self.metrics[:, :, :3] * 100.0
        best_epoch = acc[:, :, 1].argmax(axis=1)
        runs = np.arange(acc.shape[0])
        highest_train = acc[:, :, 0].max(axis=1)
        highest_valid = acc[:, :, 1].max(axis=1)
        final_train = acc[runs, best_epoch, 0]
        final_test = acc[runs, best_epoch, 2]

        def ms(v):
            return float(v.mean()), float(v.std(ddof=1)) if len(v) > 1 else 0.0

        return {
            "highest_train": ms(highest_train),
            "highest_valid": ms(highest_valid),
            "final_train": ms(final_train),
            "final_test": ms(final_test),
            "best_epoch": best_epoch,
        }

    def summary(self) -> str:
        s = self.best_by_valid()
        lines = ["All runs:"]
        for k, label in [
            ("highest_train", "Highest Train"),
            ("highest_valid", "Highest Valid"),
            ("final_train", "  Final Train"),
            ("final_test", "   Final Test"),
        ]:
            m, d = s[k]
            lines.append(f"{label}: {m:.2f} ± {d:.2f}")
        lines.append(f"params: {self.num_params}, wall: {self.wall_time:.2f}s")
        return "\n".join(lines)
