"""Multi-GPU edge partitioning: the counterpart of ``allset_tpu/parallel``.

  distributed.py  process groups (torch.distributed: NCCL on the cards,
                  gloo on the CPU where asked), the Comm through which the
                  exchange's collectives run, a spawn helper
  sharded.py      the edge-partitioned exchange: the host partition, the
                  sharded spmm, max and fused PMA epilogue, the census
  step.py         ``python -m allset_tpu_torch.parallel.step --nproc N``:
                  one edge-partitioned AllSetTransformer training step

``allset_tpu/parallel/mesh.py`` (GSPMD's mesh sharding) has no torch
counterpart.
"""
