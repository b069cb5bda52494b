"""pma epilogue: percent of its least time in the cluster K3a's device
time per epoch (``pma_bwd_cluster_kernel``, K3R's row pass). The least
time: K3a's launches of one epoch, once per half-layer, their bytes at
3.35 TB/s against their 3xTF32 products (``costs.pma_epoch(...)["K3a"]``)."""

from hgbench import costs

PATTERNS = ("pma_bwd_cluster",)


def read(ctx):
    s = ctx.claimed(PATTERNS)
    bound = costs.pma_epoch(ctx.shapes).get("K3a")
    if s <= 0 or not bound:
        return None
    return ctx.share(costs.layer_bound_s({"K3a": bound}), s)
