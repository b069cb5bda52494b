"""pma epilogue: percent of its least time in the epilogue's device time
per epoch. The least time sums, over K2R, K3R's parts, K4 and K5, each
kernel's larger of bytes at 3.35 TB/s and operations at its peak, at the
cell's shapes and folds (``costs.pma_epoch``)."""

from hgbench import costs

PATTERNS = ("pma_fwd", "pma_bwd", "dw_wg", "dw_partial", "reduce_partials", "gmax",
            "pack_kernel", "wide_")


def read(ctx):
    s = ctx.claimed(PATTERNS)
    bound = costs.pma_epoch(ctx.shapes)
    if s <= 0 or not bound:
        return None
    return ctx.share(costs.layer_bound_s(bound), s)
