"""exchange: percent of its least time in the exchange's device time per
epoch. The least time: the gather inside K1 on each half-layer's passes
(forward in training and evaluation, the transpose once), the table read
once, ids and indptr, each segment row written once, at 3.35 TB/s
(``costs.exchange_epoch``)."""

from hgbench import costs

PATTERNS = ("segment_", "gather_kernel", "gather_sorted")


def read(ctx):
    s = ctx.claimed(PATTERNS)
    if s <= 0:
        return None
    return ctx.share(costs.layer_bound_s(costs.exchange_epoch(ctx.shapes)), s)
