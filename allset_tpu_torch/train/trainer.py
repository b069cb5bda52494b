"""Full-batch trainer and the statistical runs protocol.

Counterpart of ``allset_tpu/train/trainer.py``. The reference trains
``runs`` random splits of ``epochs`` epochs each (``src/train.py:458-499``):
per epoch a full-batch training step (forward with dropout, masked NLL,
backward, Adam) and an evaluation forward; per run the epoch with the
best validation accuracy gives the reported test accuracy, and the runs
aggregate as mean +- std (ddof=1), as the reference Logger does.

A Batch with an edge-partitioned exchange (``shex``,
``parallel/sharded.py``) trains the same way on every rank: each rank
holds the same replicated parameters and seeds the same generators, so
its dropout masks agree, and the exchange's own collectives (the ``dw``
all-reduce) give every rank the same gradients; no DDP and no other
all-reduce.

Any ported model trains here (``models.build_model``): SetGNN
(AllSetTransformer, AllDeepSets) and the conv zoo (HCHA, HNHN, UniGNN,
UniGCNII, MLP, CEGCN, CEGAT, HyperGCN). The JAX package vmaps the runs;
here the runs ride an explicit leading [R] axis of the parameters and
are folded into the width of every sparse exchange and fused-epilogue
launch, so R runs share each kernel launch (``vmap_runs``; HyperGCN's
reapprox path runs them one after another inside its forward). The runs go in groups whose size follows the free device
memory; without ``vmap_runs`` every group holds one run. Runs do not
depend on their group: run r's split is the r-th draw of
``numpy.random.default_rng(seed)``, its parameter init and its dropout
masks come from generators seeded by :func:`run_seeds`, and Adam is
elementwise, so one Adam over the stacked parameters is per-run Adam.

Metrics stay on the device as [R, epochs, 6] (train/valid/test accuracy,
train/valid/test loss) until a group ends.

BatchNorm models ('bn'): the training forward normalises with the batch
statistics and updates the running ones; the evaluation forward reads
the running ones, as the JAX trainer's ``batch_stats`` collection does.

``remat`` recomputes the training forward in the backward
(``torch.utils.checkpoint``, as ``jax.checkpoint`` in the JAX trainer):
the recompute restores each run's dropout generator to its state before
the forward, so it draws the same masks, and leaves the running
statistics alone, so they update once; losses and gradients are the
same bits as without it.

``keep_params`` keeps each run's state (parameters and running
statistics) at its best-valid epoch, the epoch whose test accuracy the
summary reports as Final Test, in ``Results.params``; the JAX package
keeps the final epoch's instead.

``fit`` records spans (``utils/profiling.py``): ``trainer.fit`` around
all of it, ``trainer.masks``, ``trainer.init`` a group, ``trainer.epoch``
(with the port's launches in it, ``counts["launches"]``, the f32
dense products ``ops/cuda_dense.py`` left to the library,
``counts["dense_declined"]``, the PMA epilogue's launches on the
two-block cluster kernels, ``counts["pma_cluster"]``, and its CUDA calls
sent to the plain route, ``counts["pma_declined"]``) holding
``trainer.forward``, ``trainer.backward``, ``trainer.optimizer`` and
``trainer.eval``, and ``trainer.collect``. Under the profiler on the card
the epoch and its phases also time the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from allset_tpu_torch.graph.batch import Batch, split_masks
from allset_tpu_torch.graph.transforms import rand_train_test_idx
from allset_tpu_torch.models import (CEConfig, HCHAConfig, HNHNConfig, HyperGCNConfig,
                                     LegacyHGNNConfig, MLPConfig, SetGNNConfig, UniGCNIIConfig,
                                     UniGNNConfig, build_model)
from allset_tpu_torch.models.hypergcn import laplacian_nnz_bound
from allset_tpu_torch.nn.modules import frozen_batch_stats, packed_width
from allset_tpu_torch.ops import _kernels, cuda_pma
from allset_tpu_torch.train.factory import make_optimizer
from allset_tpu_torch.utils.profiling import span


# [rows, WP] tables an AllSetTransformer half-layer keeps per run at its
# peak, and [N, WP] node tables besides (Trainer._bytes_per_run)
SETGNN_TABLES = 4
SETGNN_NODE_TABLES = 1
# [rows, hid] tables an AllDeepSets layer keeps per run at its peak
# (Trainer._bytes_per_run)
DEEPSETS_TABLES = 14
# the conv zoo's tables per run at its peak, two layers: (gathered
# [nnz_pad, width] tables, f32 [rows, width] tables), rows the nodes plus the
# exchange's hyperedge rows (Trainer._zoo_bytes_per_run). dir_spmm gathers
# inside K1 and forms no [nnz, width] table, so the models built on it
# count row tables only, fitted to their measured peaks; CEGAT's and
# UniGAT's backward hold the gathered rows and the expanded attention, the
# cotangent gathered by destination, masked, and the two products
ZOO_TABLES = {"HCHA": (0, 3), "HNHN": (0, 5), "UniGNN": (0, 3), "UniGAT": (6, 3),
              "UniGCNII": (0, 6), "CEGCN": (0, 3), "CEGAT": (6, 3), "HyperGCN": (0, 8)}
# CEGAT's f32 [nnz_pad, heads] score tables per conv at its peak (the two
# gathered scores, their sum, leaky_relu, the expanded max and denominator,
# exp, the softmax, its dropout mask and the masked softmax, and their
# gradients' share)
CEGAT_SCORE_TABLES = 12
# bytes per entry of one reapprox Laplacian's Incidence (its index arrays,
# norm and mask, both orders), held from the forward to the backward
REAPPROX_ENTRY_BYTES = 96


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
    # recompute the training forward in the backward (torch.utils.checkpoint)
    remat: bool = False
    # keep each run's state at its best-valid epoch (Results.params)
    keep_params: bool = False


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


class BestState:
    """Each run's state at its best-valid epoch so far, on the device.
    ``update`` takes the runs' validation accuracy [R] after an evaluation
    and keeps the state of the runs that beat their best: strictly, on the
    accuracy scaled to percent as ``Results.best_by_valid`` scales it, so
    the kept epoch is the first of the best, the epoch whose test accuracy
    is the run's Final Test."""

    def __init__(self, model: torch.nn.Module, runs: int):
        self.model = model
        self.state = {k: v.detach().clone() for k, v in model.state_dict().items()}
        device = next(iter(self.state.values())).device
        self.best = torch.full((runs,), float("-inf"), device=device)

    def update(self, valid_acc: torch.Tensor) -> None:
        pct = valid_acc * 100.0
        better = pct > self.best
        self.best = torch.where(better, pct, self.best)
        for k, v in self.model.state_dict().items():
            sel = better.view((-1,) + (1,) * (v.dim() - 1))
            self.state[k] = torch.where(sel, v.detach(), self.state[k])


def remat_forward(model: torch.nn.Module, forward, generators) -> torch.Tensor:
    """``forward()`` (a training forward of ``model`` drawing its dropout
    masks from ``generators``) under ``torch.utils.checkpoint``: its
    activations are dropped and recomputed in the backward. The recompute
    starts each generator from its state before the forward and puts back
    its state after, and freezes the running statistics of every
    BatchNorm, so the masks, the outputs and the gradients are the bits of
    the forward without remat and the statistics update once."""
    from torch.utils.checkpoint import checkpoint

    gens = [] if generators is None else list(generators)
    before = [g.get_state() for g in gens]

    @contextlib.contextmanager
    def recompute():
        after = [g.get_state() for g in gens]
        for g, s in zip(gens, before):
            g.set_state(s)
        try:
            with frozen_batch_stats(model):
                yield
        finally:
            for g, s in zip(gens, after):
                g.set_state(s)

    return checkpoint(forward, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (contextlib.nullcontext(), recompute()))


class Trainer:
    """The runs protocol for one model configuration (any of
    ``models.MODELS``) on one Batch; the batch's device decides where
    everything runs."""

    def __init__(self, model_cfg, batch: Batch, cfg: TrainConfig):
        self.model_cfg = model_cfg
        self.batch = batch
        self.cfg = cfg
        self.device = batch.x.device

    # --- per group of runs ---

    def _init(self, runs: Sequence[int]) -> torch.nn.Module:
        """A model holding ``runs`` (a leading runs axis on every
        parameter), run r initialised from its own CPU generator."""
        gens = [torch.Generator().manual_seed(run_seeds(self.cfg.seed, r)[0]) for r in runs]
        return build_model(self.model_cfg, gens).to(self.device)

    def _apply(self, model: torch.nn.Module, train: bool, generators) -> torch.Tensor:
        """Logits [N, R, C]."""
        return model(self.batch, train, generators)

    def _train_logits(self, model: torch.nn.Module, generators) -> torch.Tensor:
        """The training forward; under ``remat`` through
        :func:`remat_forward`."""
        if not self.cfg.remat:
            return self._apply(model, True, generators)
        return remat_forward(model, lambda: self._apply(model, True, generators), generators)

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
        on the device, the parameter count of one run, and with
        ``keep_params`` each run's state at its best-valid epoch, else
        None)."""
        cfg, dev = self.cfg, self.device
        with span("trainer.init"):
            model = self._init(runs)
            gens = [torch.Generator(device=dev).manual_seed(run_seeds(cfg.seed, r)[1])
                    for r in runs]
            opt = make_optimizer(model, cfg.lr, cfg.wd)
            k = max(1, cfg.eval_every)
            metrics = torch.zeros(len(runs), cfg.epochs, 6, device=dev)
            prev = torch.zeros(len(runs), 6, device=dev)
            best = BestState(model, len(runs)) if cfg.keep_params else None
        launches, declined, routes = _kernels.launches, _kernels.declined, _kernels.routes
        cluster = ("pma_fwd_cluster", "pma_bwd_cluster")
        for ep in range(cfg.epochs):
            n0, d0 = sum(launches.values()), declined["runs_dense"]
            c0, p0 = sum(routes[k] for k in cluster), declined["pma_epilogue"]
            with span("trainer.epoch", dev) as epoch:
                with span("trainer.forward", dev):
                    opt.zero_grad(set_to_none=True)
                    loss = masked_nll(self._train_logits(model, gens), self.batch.y,
                                      masks["train"])
                with span("trainer.backward", dev):
                    loss.sum().backward()  # run r's gradient is that of its own loss
                with span("trainer.optimizer", dev):
                    opt.step()
                # off epochs repeat the last evaluated metrics (JAX eval_every)
                if (ep + 1) % k == 0 or ep == cfg.epochs - 1:
                    with span("trainer.eval", dev):
                        prev = self._eval(model, masks, loss.detach())
                        if best is not None:
                            best.update(prev[:, 1])
                metrics[:, ep] = prev
                epoch.counts["launches"] = sum(launches.values()) - n0
                epoch.counts["dense_declined"] = declined["runs_dense"] - d0
                epoch.counts["pma_cluster"] = sum(routes[k] for k in cluster) - c0
                epoch.counts["pma_declined"] = declined["pma_epilogue"] - p0
        return metrics, count_params(model, len(runs)), None if best is None else best.state

    # --- group sizing ---

    def _bytes_per_run(self) -> int:
        """Device bytes one folded run adds at its peak: the classifier's
        hidden and output tables; under GPR the f32 [N, hid, L+1] stack and
        about four [N, hid] f32 tables of gpr_mlp; LearnMask's importance
        and its two Adam moments. Per half-layer of AllSetTransformer:
        SETGNN_TABLES [rows, WP]-wide tables kept for the backward (the
        pack's GEMM output, the aggregate, the output, their gradients'
        share), SETGNN_NODE_TABLES [N, WP] tables, and K3R's scratch
        (``cuda_pma.bwd_scratch_bytes`` at the half-layer with more rows:
        the rFF inputs and output gradients, the small vectors' and dW's
        partials); dir_spmm gathers inside K1, so no [nnz, WP] message
        table. The node tables are fitted to the measured peaks: without
        the self-loops the V->E half-layer has fewer rows than the nodes,
        and the peak falls less than the rows. Of AllDeepSets: one [nnz, hid] table and DEEPSETS_TABLES
        [rows, hid] tables per layer (f_enc's and f_dec's activations, the
        LayerNorm inputs and dropout masks kept for the backward, the
        reduce's output), and under LearnMask the SDDMM's gathered rows
        and product, three f32 [nnz, hid] tables. The exchange is unsplit
        under LearnMask, under 'bn' or without the self-loop split: then
        the V->E output has one row per hyperedge instead of the N-slot layout's
        real edges + N. On an H100 at the walmart preset in f32 this gives
        1.745, 2.254, 1.751 and 1.129 GiB for AllSetTransformer (the preset,
        GPR, LearnMask, no self-loops) against measured peaks of 1.473,
        1.904, 1.388 and 1.034, 3.477 at --MLP_hidden 512 against 2.889,
        6.782 at --MLP_hidden 1024 (K3R's wide route: its tables over the
        rows rounded up to 128, its partials and slabs) against 5.747, and
        3.740 for AllDeepSets against 3.405 (PERF.md §5). With an
        edge-partitioned exchange (``batch.shex``) AllSetTransformer counts
        half of the SETGNN_TABLES over the replicated rows (the pack's
        table, the output) and half over this process's shards' rows (the
        aggregate and its gradient), and K3R's scratch at a shard's rows
        (an estimate not yet held to a measured peak). The conv zoo:
        :meth:`_zoo_bytes_per_run`."""
        mc, inc = self.model_cfg, self.batch.inc
        if not isinstance(mc, SetGNNConfig):
            return self._zoo_bytes_per_run()
        item = 2 if mc.dtype == "bfloat16" else 4
        HC, L = mc.mlp_hidden, mc.all_num_layers
        WP = packed_width(HC, mc.heads)
        N = inc.num_nodes
        if inc.real is None or mc.learn_mask or mc.normalization == "bn":
            nnz, rows_v2e = inc.nnz, inc.num_edges
        else:
            nnz, rows_v2e = inc.real.nnz, inc.real.num_edges + N
        rows = rows_v2e + N
        total = 4 * N * (mc.classifier_hidden + mc.num_classes)
        shex = self.batch.shex
        if L > 0 and mc.pma and shex is not None and mc.normalization != "bn" and (
                not mc.learn_mask or shex.v2e.sl_mode == "none"):
            # the edge-partitioned exchange: the aggregate and its gradient
            # over this process's shards' rows, the rest replicated
            v, e = shex.v2e, shex.e2v
            shard_v, shard_e = ((v.rows_per_shard + v.rows_sl) * len(v.local),
                                e.rows_per_shard * len(e.local))
            half = SETGNN_TABLES // 2
            total += item * WP * (half * (rows + shard_v + shard_e)
                                  + SETGNN_NODE_TABLES * N) * L
            total += cuda_pma.bwd_scratch_bytes(max(shard_v, shard_e), HC, mc.mlp_num_layers,
                                                item)  # K3R on one shard at a time
        elif L > 0 and mc.pma:
            total += item * WP * (SETGNN_TABLES * rows + SETGNN_NODE_TABLES * N) * L  # tables
            total += cuda_pma.bwd_scratch_bytes(max(rows_v2e, N), HC, mc.mlp_num_layers,
                                                item)  # K3R
        elif L > 0:
            total += item * HC * (nnz + DEEPSETS_TABLES * rows * L)
            if mc.learn_mask:  # the SDDMM's three f32 [nnz, hid] tables, one exchange at a time
                total += 3 * 4 * HC * nnz
        if mc.gpr and L > 0:
            total += 4 * N * HC * (L + 5)
        if mc.learn_mask:
            total += 3 * 4 * inc.nnz_padded
        return total

    def _zoo_bytes_per_run(self) -> int:
        """The conv zoo's bytes per folded run: the f32 logits and their
        gradient; ZOO_TABLES' gathered [nnz_pad, width] and [rows, width]
        tables at the widest activation (hidden x heads for UniGNN and
        UniGCNII), rows the nodes plus the exchange's hyperedge rows (the
        N-slot layout's real edges + N on the split), for two layers and
        in proportion to more; MLP and the legacy HGNN seven [N, hidden]
        f32 tables for two layers. CEGCN and CEGAT count the V2V graph's
        entries and its N destination rows (CEGAT also its f32 score
        tables, CEGAT_SCORE_TABLES per conv), HyperGCN the Laplacian's
        entries at its widest layer; on the reapprox path, where no
        Laplacian is built ahead, laplacian_nnz_bound's entries, with the
        structures' own index arrays. On an H100 at synthetic-walmart, f32,
        hidden 256, the measured peaks per run (GiB) against the tables:
        HCHA and HGNN 0.496 / 0.719, HNHN 1.054 / 1.192, UniGCNII 1.208 /
        1.428, UniGCN and UniSAGE 0.477, UniGIN 0.647, UniGCN2 0.621 /
        0.719, UniGAT 2.932 / 3.561, MLP 0.447 / 0.604, CEGCN 0.449 / 0.519,
        CEGAT 2.852 / 3.744, HyperGCN 0.039 / 0.096."""
        mc, inc, N = self.model_cfg, self.batch.inc, self.batch.num_nodes
        item = 2 if getattr(mc, "dtype", "float32") == "bfloat16" else 4
        total = 3 * 4 * N * mc.num_classes
        depth = max(getattr(mc, "all_num_layers", 2), 2) / 2
        if isinstance(mc, (MLPConfig, LegacyHGNNConfig)):
            return int(total + 7 * 4 * N * mc.mlp_hidden * depth)
        if isinstance(mc, HyperGCNConfig):
            width, key = max(mc.widths()[1:]), "HyperGCN"
            if mc.fast:
                nnz = inc.nnz_padded
            else:  # f32; each layer's Laplacian lives until the backward
                item, nnz = 4, laplacian_nnz_bound(mc.edge_dict, N, mc.mediators)
                total += 2 * depth * REAPPROX_ENTRY_BYTES * nnz
        else:
            width, nnz = mc.mlp_hidden * getattr(mc, "heads", 1), inc.nnz_padded
            if isinstance(mc, UniGNNConfig):
                key = "UniGAT" if mc.model_name == "UniGAT" else "UniGNN"
            elif isinstance(mc, CEConfig):
                key = "CEGCN" if mc.conv == "GCN" else "CEGAT"
                if key == "CEGAT":
                    total += depth * CEGAT_SCORE_TABLES * 4 * nnz * max(mc.heads,
                                                                        mc.output_heads)
            else:
                key = {HCHAConfig: "HCHA", HNHNConfig: "HNHN",
                       UniGCNIIConfig: "UniGCNII"}[type(mc)]
        if inc is None or inc.real is None or key.startswith("Uni"):
            edges = N if inc is None else inc.num_edges
        else:
            edges = inc.real.num_edges + N
        a, b = ZOO_TABLES[key]
        return int(total + depth * width * (a * item * nnz + b * 4 * (N + edges)))

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

    def masks(self) -> Dict[str, torch.Tensor]:
        """The runs' splits: {train, valid, test: [N, runs] bool} on the
        device, run r's the r-th draw of ``default_rng(seed)``."""
        cfg = self.cfg
        host_rng = np.random.default_rng(cfg.seed)
        y_host = self.batch.y.cpu().numpy()
        split = [split_masks(rand_train_test_idx(y_host, cfg.train_prop, cfg.valid_prop,
                                                 rng=host_rng), self.batch.num_nodes)
                 for _ in range(cfg.runs)]
        return {k: torch.stack([s[k] for s in split], dim=1).to(self.device)
                for k in ("train", "valid", "test")}

    def fit(self) -> "Results":
        """The runs, in groups; ``Results.wall_time`` runs from the end of
        the ``trainer.masks`` span to the end of the ``trainer.fit`` span,
        which encloses all of it (the spans: ``utils/profiling.py``): the
        JAX package's fit starts its clock after the splits."""
        cfg = self.cfg
        with span("trainer.fit", fit=True) as whole:
            with span("trainer.masks") as splits:
                masks = self.masks()
            group = self._group_size()
            if cfg.vmap_runs and group < cfg.runs:
                print(f"[trainer] folding runs in groups of {group}")
            mets, groups, states, num_params = [], [], [], 0
            lo = 0
            while lo < cfg.runs:
                hi = min(lo + group, cfg.runs)
                try:
                    m, num_params, state = self._run_group(
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
                with span("trainer.collect"):
                    mets.append(m.cpu())
                    if state is not None:
                        states.append({k: v.cpu() for k, v in state.items()})
                groups.append(hi - lo)
                lo = hi
            with span("trainer.collect"):
                metrics = torch.cat(mets).numpy()
                params = ({k: torch.cat([s[k] for s in states]) for k in states[0]} if states
                          else None)
        if cfg.display_step > 0:
            self._print_progress(metrics)
        return Results(metrics=metrics, wall_time=(whole.t1_ns - splits.t1_ns) / 1e9,
                       num_params=num_params, groups=groups, params=params)

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
    # with TrainConfig.keep_params: {state_dict name: [runs, ...] tensor on
    # the CPU}, each run's parameters and running statistics at its
    # best-valid epoch (best_by_valid's best_epoch)
    params: Optional[Dict[str, torch.Tensor]] = None

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

    def plot(self, path: Optional[str] = None, run: Optional[int] = None):
        """Accuracy curves, as the reference ``Logger.plot_result``
        (``src/train.py:152-167``): train/valid/test accuracy per epoch,
        averaged over runs (or of run ``run``). Saves to ``path`` and
        returns it, or returns the matplotlib figure. matplotlib is
        imported here, so nothing else of the port needs it."""
        import matplotlib

        if path is not None:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        acc = self.metrics[:, :, :3] * 100.0
        curves = acc[run] if run is not None else acc.mean(axis=0)
        fig, ax = plt.subplots(figsize=(7, 4))
        for i, label in enumerate(["train", "valid", "test"]):
            ax.plot(curves[:, i], label=label)
        ax.set_xlabel("epoch")
        ax.set_ylabel("accuracy (%)")
        ax.legend()
        fig.tight_layout()
        if path is not None:
            fig.savefig(path, dpi=120)
            plt.close(fig)
            return path
        return fig

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
