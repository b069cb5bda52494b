"""pma epilogue: device ms per epoch of the PMA epilogue's two-block
cluster kernels, K2R (``pma_fwd_cluster_kernel``,
``allset_tpu_torch/csrc/pma_epilogue_cluster.cu``) and K3R's row pass K3a
(``pma_bwd_cluster_kernel``, ``csrc/pma_epilogue_cluster_bwd.cu``), which
serve HC 384 and 512, from the traced job."""

PATTERNS = ("pma_fwd_cluster", "pma_bwd_cluster")


def read(ctx):
    s = ctx.claimed(PATTERNS)
    return ctx.ms_per_epoch(s) if s > 0 else None
