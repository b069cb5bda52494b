"""pma epilogue: percent of its least time in the cluster K2R's device
time per epoch (``pma_fwd_cluster_kernel``). The least time: K2R's
launches of one epoch, twice per half-layer (training and evaluation),
their bytes at 3.35 TB/s against their 3xTF32 products
(``costs.pma_epoch(...)["K2R"]``)."""

from hgbench import costs

PATTERNS = ("pma_fwd_cluster",)


def read(ctx):
    s = ctx.claimed(PATTERNS)
    bound = costs.pma_epoch(ctx.shapes).get("K2R")
    if s <= 0 or not bound:
        return None
    return ctx.share(costs.layer_bound_s({"K2R": bound}), s)
