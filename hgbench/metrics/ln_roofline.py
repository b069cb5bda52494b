"""layer norm: percent of its least time in B12's and B13's device time
per epoch; each kernel's bytes at 3.35 TB/s against its f32 operations at
67 TFLOP/s, over AllDeepSets' norms (``costs.ln_epoch``)."""

from hgbench import costs

PATTERNS = ("ln_fwd", "ln_bwd")


def read(ctx):
    s = ctx.claimed(PATTERNS)
    bound = costs.ln_epoch(ctx.shapes)
    if s <= 0 or not bound:
        return None
    return ctx.share(costs.layer_bound_s(bound), s)
