"""Process groups and collectives for the edge-partitioned exchange.

Counterpart of ``allset_tpu/parallel/distributed.py``. The JAX package
joins processes with ``jax.distributed.initialize`` and lays out a
(dcn, ici) mesh whose ICI axis carries the edge partition; here:

  * :func:`init_process_group` is ``torch.distributed.init_process_group``
    from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``MASTER_ADDR``/``MASTER_PORT``) or from an explicit rank, world size
    and init method. The backend defaults to NCCL and the device to
    ``cuda:{local_rank}``; gloo on the CPU only where the caller asks;
  * :func:`edge_comm` is ``hybrid_mesh``: ranks in host-major order, the
    ranks of one host forming the group over which edges are partitioned
    (NVLink), the hosts its replicas;
  * :class:`Comm` is the one place where the exchange's collectives run.
    It holds the shards this process runs and combines their results as
    the collectives define: an all-gather concatenates every shard's
    block in shard (= rank) order, an all-reduce sums every shard's part
    in f32. With a process group each rank runs its own shard and the
    combination is ``torch.distributed.all_gather``/``all_reduce``; with
    none (:func:`local_comm`) one process runs every shard's body one after
    another and combines them itself. Both ways run the same shard
    bodies (``parallel/sharded.py``);
  * :func:`spawn` starts ``world`` ranks running one function and
    returns their results (what the tests and the step entry point
    start ranks with). The children import the port and torch, never
    jax.

``collectives`` counts each collective of the exchange where it runs (as
``ops._kernels.launches`` counts launches), by op, and
``collective_bytes`` its payload: the gathered result of an all-gather,
the reduced buffer of an all-reduce (f32).
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

OPS = ("all_gather", "all_reduce")
collectives = collections.Counter({k: 0 for k in OPS})
collective_bytes = collections.Counter({k: 0 for k in OPS})


def reset_collectives() -> None:
    for k in OPS:
        collectives[k] = 0
        collective_bytes[k] = 0


def _count(op: str, t: torch.Tensor) -> None:
    collectives[op] += 1
    collective_bytes[op] += t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class Comm:
    """The shards this process runs out of ``num_shards`` (a contiguous
    range, rank-major: rank r of a group of W ranks runs shards
    [r*D/W, (r+1)*D/W)), the process group that joins it to the other
    ranks (None: every shard runs here) and the device of its tensors."""

    num_shards: int
    shards: tuple
    device: torch.device
    group: Optional[object] = None

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Every shard's equal-shaped block, concatenated along rows in
        shard order -> [num_shards * rows, ...], the same on every rank."""
        local = parts[0] if len(parts) == 1 else torch.cat(list(parts))
        if self.group is not None:
            send = local.contiguous()
            # gloo moves no bfloat16 (nor int16): the gather is a copy, so
            # move its bytes
            bits = send.dtype == torch.bfloat16 and dist.get_backend(self.group) == "gloo"
            if bits:
                send = send.view(torch.uint8)
            out = [torch.empty_like(send) for _ in range(self.world)]
            dist.all_gather(out, send, group=self.group)
            local = torch.cat(out)
            if bits:
                local = local.view(torch.bfloat16)
        _count("all_gather", local)
        return local

    def all_reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The sum of every shard's part in f32 (this process's parts in
        shard order, then across the ranks) -> f32, the same on every
        rank."""
        acc = parts[0].to(torch.float32, copy=True)
        for p in parts[1:]:
            acc += p.float()
        if self.group is not None:
            dist.all_reduce(acc, group=self.group)
        _count("all_reduce", acc)
        return acc


def local_comm(num_shards: int, device="cuda") -> Comm:
    """Every shard of ``num_shards`` in this process, one after another,
    on ``device`` (the card unless the caller names another; without a
    card that default raises)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("local_comm: no CUDA device is available "
                           "(pass device='cpu' for the plain versions)")
    return Comm(num_shards, tuple(range(num_shards)), device)


def init_process_group(backend: Optional[str] = None, rank: Optional[int] = None,
                       world_size: Optional[int] = None, init_method: Optional[str] = None,
                       device=None, timeout_s: float = 300.0) -> torch.device:
    """Join the process group and return this rank's device. Without
    arguments it reads torchrun's environment (``init_method`` env://);
    ``backend`` defaults to 'nccl' and ``device`` to ``cuda:{local_rank}``
    (``LOCAL_RANK``, else the rank), which raises without a card; 'gloo'
    with ``device='cpu'`` only where the caller asks."""
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    backend = backend or "nccl"
    if device is None:
        device = f"cuda:{int(env.get('LOCAL_RANK', rank))}"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_group: no CUDA device is available "
                               "(pass backend='gloo', device='cpu' for the CPU)")
        torch.cuda.set_device(device)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs a CUDA device")
    dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def host_major_ranks(world: int, local_world: int) -> list:
    """The ranks of each host, hosts in order: [[0 .. L-1], [L .. 2L-1], ...]."""
    if local_world < 1 or world % local_world:
        raise ValueError(f"world {world} is not a whole number of hosts of {local_world}")
    return [list(range(h * local_world, (h + 1) * local_world))
            for h in range(world // local_world)]


def edge_comm(device, local_world: Optional[int] = None) -> Comm:
    """The Comm over this host's ranks (``local_world`` of them;
    ``LOCAL_WORLD_SIZE``, else the whole world), each running the shard
    of its local rank. On one host that group is the world. Every rank
    calls it: each host's group is made on all of them."""
    world, rank = dist.get_world_size(), dist.get_rank()
    L = local_world or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = host_major_ranks(world, L)
    if len(hosts) == 1:
        group = dist.group.WORLD
    else:
        group = [dist.new_group(h) for h in hosts][rank // L]
    return Comm(L, (rank % L,), torch.device(device), group)


def comm_summary(comm: Comm) -> str:
    where = "in-process" if comm.group is None else dist.get_backend(comm.group)
    return (f"edge shards={comm.num_shards} here={list(comm.shards)} ranks={comm.world} "
            f"({where}) device={comm.device}")


def _child(fn, rank, world, backend, init_method, queue, args):
    torch.set_num_threads(1)
    try:
        device = init_process_group(backend, rank, world, init_method,
                                    device="cpu" if backend == "gloo" else None)
        queue.put((rank, True, fn(edge_comm(device), *args)))
    except Exception:  # reported to the parent, which raises it
        queue.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: tuple = (), backend: str = "gloo",
          timeout_s: float = 300.0) -> list:
    """Run ``fn(comm, *args)`` on ``world`` fresh processes (start method
    'spawn'; one torch thread each), joined through a file store in a
    temporary directory, and return their results in rank order. ``fn``
    must be a module-level function of an importable module; its result
    is pickled. A child that fails, or a run past ``timeout_s``, raises
    here, and every child is stopped."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_child, args=(fn, r, world, backend, init, q, args),
                             daemon=True) for r in range(world)]
        for p in procs:
            p.start()
        results, errors = {}, []
        try:
            deadline = time.monotonic() + timeout_s
            while len(results) < world and not errors:
                try:  # drain the queue before any join
                    rank, ok, res = q.get(timeout=1.0)
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead:
                        errors.append(f"ranks {dead} exited without a result")
                    elif time.monotonic() > deadline:
                        raise TimeoutError(f"spawn: {world} ranks did not finish in "
                                           f"{timeout_s} s")
                    continue
                if ok:
                    results[rank] = res
                else:
                    errors.append(f"rank {rank}:\n{res}")
        finally:
            for p in procs:
                p.join(timeout=10 if not errors else 1)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if errors:
            raise RuntimeError("spawn: a rank failed\n" + "\n".join(errors))
    return [results[r] for r in range(world)]
