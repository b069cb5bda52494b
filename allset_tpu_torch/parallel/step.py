"""One edge-partitioned AllSetTransformer training step over N ranks.

Counterpart of ``__graft_entry__.py::dryrun_multichip``:

    python -m allset_tpu_torch.parallel.step --nproc N [--nodes --edges ...]

starts N ranks (``distributed.spawn``; NCCL on the cards by default, one
card a rank; ``--device cpu`` runs gloo on the CPU), each of which builds
the same ``scale_free_hypergraph`` with its self-loops, partitions it into
N shards (``ShardedExchange.build``), places its own shard, builds the
same replicated model and dropout generator from ``--seed`` and takes
``--steps`` Adam steps (dropout on) through the sharded exchange and the
per-shard fused epilogue. ``--bodies D`` runs D shard bodies one after
another in this process instead (no process group): the only way to run
D > 1 on one card, since NCCL puts no two ranks on one GPU.

It prints each step's loss and host-clock time (to the loss's read,
which waits for the device), the collectives issued per step against
``sharded_comm_stats``, the per-shard entry counts and their skew (max
over mean) and the rows each shard owns, per direction, and checks that every rank ends with the same
parameters, bit for bit (no DDP: the replicated dense layers get equal
gradients once the exchange's ``dw`` is all-reduced). Exit code 0 when
the losses are finite and the ranks agree.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The graph and model of the step (the bench step's configuration at
    a small size by default)."""

    nodes: int = 4096
    edges: int = 2048
    edge_size: int = 12
    features: int = 64
    classes: int = 8
    hidden: int = 128
    heads: int = 8
    mlp_layers: int = 2
    dtype: str = "float32"
    dropout: float = 0.5
    steps: int = 1
    seed: int = 0
    balance_threshold: float = 1.25
    lr: float = 1e-3


def make_data(cfg: StepConfig):
    """The step's graph on the host: scale_free_hypergraph with its
    self-loops and all-one norms."""
    from allset_tpu_torch.data import scale_free_hypergraph
    from allset_tpu_torch.graph import add_self_loops, norm_construction

    raw = scale_free_hypergraph(num_nodes=cfg.nodes, num_hyperedges=cfg.edges,
                                avg_edge_size=cfg.edge_size, feature_dim=cfg.features,
                                num_classes=cfg.classes, seed=cfg.seed)
    return norm_construction(add_self_loops(raw), "all_one")


def make_model(cfg: StepConfig, nnz_padded: int):
    from allset_tpu_torch.models import SetGNN, SetGNNConfig

    mc = SetGNNConfig(num_features=cfg.features, num_classes=cfg.classes, all_num_layers=1,
                      mlp_num_layers=cfg.mlp_layers, mlp_hidden=cfg.hidden,
                      classifier_num_layers=1, heads=cfg.heads, dropout=cfg.dropout,
                      dtype=cfg.dtype, nnz_padded=nnz_padded)
    return SetGNN(mc, torch.Generator().manual_seed(cfg.seed))


def digest(model: torch.nn.Module) -> str:
    """sha256 over every parameter's bytes, in name order."""
    h = hashlib.sha256()
    for name, p in sorted(model.state_dict().items()):
        h.update(name.encode())
        h.update(p.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def train_worker(comm, cfg: StepConfig) -> dict:
    """``cfg.steps`` Adam steps of the step's model on ``comm``'s shards.
    Returns plain Python values (picklable from a spawned rank): the
    losses, the collectives, their bytes and the host-clock ms of each
    step, the parameters' digest, the per-shard entry counts and
    ``sharded_comm_stats``."""
    from allset_tpu_torch.graph import Batch
    from allset_tpu_torch.nn.modules import packed_width
    from allset_tpu_torch.parallel import distributed
    from allset_tpu_torch.parallel.sharded import ShardedExchange, sharded_comm_stats
    from allset_tpu_torch.train import masked_nll

    dev = comm.device
    batch = Batch.from_hyperdata(make_data(cfg), device=dev, bucket=1024)
    shex = ShardedExchange.build(batch.inc, comm.num_shards,
                                 balance_threshold=cfg.balance_threshold).shard(comm)
    batch = dataclasses.replace(batch, shex=shex)
    model = make_model(cfg, batch.inc.nnz_padded).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=cfg.lr)
    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    mask = torch.arange(batch.num_nodes, device=dev) % 2 == 0
    losses, per_step = [], []
    for _ in range(cfg.steps):
        distributed.reset_collectives()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = masked_nll(model(batch, True, gen), batch.y, mask)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))  # waits for the step on the device
        per_step.append(dict(counts=dict(distributed.collectives),
                             bytes=dict(distributed.collective_bytes),
                             ms=(time.perf_counter() - t0) * 1e3))
    WP = packed_width(cfg.hidden, cfg.heads)
    item = 2 if cfg.dtype == "bfloat16" else 4
    return dict(
        losses=losses, per_step=per_step, digest=digest(model),
        entries={d: list(getattr(shex, d).shard_nnz) for d in ("v2e", "e2v")},
        rows={d: list(getattr(shex, d).shard_rows) for d in ("v2e", "e2v")},
        block={d: getattr(shex, d).rows_per_shard for d in ("v2e", "e2v")},
        balanced={d: getattr(shex, d).reasm is not None for d in ("v2e", "e2v")},
        stats=sharded_comm_stats(shex, WP, item, epilogue_hc=cfg.hidden,
                                 epilogue_layers=cfg.mlp_layers),
    )


def census_matches(result: dict) -> bool:
    """Every step's collectives are those ``sharded_comm_stats`` counts:
    the reassembly all-gathers and the backward's d_sl all-gathers, the
    all-reduces; and their bytes."""
    st = result["stats"]
    want = {"all_gather": st["reassembly_fwd"] + st["allgathers_bwd"],
            "all_reduce": st["psums_bwd"]}
    want_b = {"all_gather": st["fwd_bytes"] + st["bwd_ag_bytes"],
              "all_reduce": st["bwd_bytes"]}
    return all(s["counts"] == want and s["bytes"] == want_b for s in result["per_step"])


def median_ms(result: dict) -> float:
    """The median step time after the first step (all steps if one)."""
    ms = [s["ms"] for s in result["per_step"]]
    return float(np.median(ms[1:] if len(ms) > 1 else ms))


def skew(counts) -> float:
    """Largest shard's entries over the mean."""
    return max(counts) / max(sum(counts) / len(counts), 1.0)


def run(nproc: int, cfg: StepConfig, device: str = "cuda", backend=None, bodies: int = 0,
        timeout_s: float = 600.0) -> list:
    """The step on ``nproc`` spawned ranks (or ``bodies`` shard bodies in
    this process) -> each rank's ``train_worker`` result."""
    from allset_tpu_torch.parallel import distributed

    if bodies:
        return [train_worker(distributed.local_comm(bodies, device), cfg)]
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("parallel.step: no CUDA device is available "
                           "(pass --device cpu for gloo on the CPU)")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":  # build the kernels once, before the ranks load them
        from allset_tpu_torch.ops import _kernels

        _kernels.build()
    return distributed.spawn(train_worker, nproc, (cfg,), backend=backend, timeout_s=timeout_s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=1, help="ranks, one shard each")
    ap.add_argument("--bodies", type=int, default=0,
                    help="run this many shard bodies in this process instead of ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, help="nccl (cuda) or gloo (cpu) by default")
    for f in dataclasses.fields(StepConfig):
        ap.add_argument(f"--{f.name}", type=type(f.default), default=f.default)
    a = ap.parse_args(argv)
    cfg = StepConfig(**{f.name: getattr(a, f.name) for f in dataclasses.fields(StepConfig)})
    t0 = time.perf_counter()
    results = run(a.nproc, cfg, a.device, a.backend, a.bodies)
    secs = time.perf_counter() - t0
    r0 = results[0]
    shards = a.bodies or a.nproc
    print(f"parallel.step: {len(results)} rank(s), {shards} shard(s), {cfg.steps} step(s) in "
          f"{secs:.1f} s on {a.device}")
    for i, loss in enumerate(r0["losses"]):
        print(f"  step {i}: loss {loss:.6f}, {r0['per_step'][i]['ms']:.3f} ms (host clock)")
    print(f"  median step {median_ms(r0):.3f} ms (rank 0; after the first step)")
    print(f"  collectives per step: {r0['per_step'][-1]['counts']}, bytes "
          f"{r0['per_step'][-1]['bytes']}")
    print(f"  sharded_comm_stats: {r0['stats']}")
    for d in ("v2e", "e2v"):
        print(f"  {d}: entries per shard {r0['entries'][d]}, skew {skew(r0['entries'][d]):.3f}, "
              f"balanced cuts {r0['balanced'][d]}; rows per shard {r0['rows'][d]} in blocks "
              f"of {r0['block'][d]}")
    same = len({r["digest"] for r in results}) == 1
    census = all(census_matches(r) for r in results)
    finite = all(np.isfinite(r["losses"]).all() for r in results)
    print(f"  parameters bit-identical across ranks: {same}; census as counted: {census}")
    print(json.dumps({"losses": r0["losses"], "median_ms": median_ms(r0), "ranks_agree": same,
                      "census_ok": census, "entries": r0["entries"]}))
    return 0 if (same and census and finite) else 1


if __name__ == "__main__":
    sys.exit(main())
