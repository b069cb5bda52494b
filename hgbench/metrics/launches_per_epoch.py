"""port kernels: the port's launches (``ops/_kernels.launches``) counted
in the traced fit's ``trainer.epoch`` spans, summed over its groups, per
epoch of the job (``hgbench/spans.py``)."""

from hgbench import spans


def read(ctx):
    fit = spans.traced_fit()
    sel = spans.named(fit, "trainer.epoch") if fit else []
    counts = [s.counts.get("launches") for s in sel]
    if not sel or None in counts or ctx.epochs <= 0:
        return None
    return sum(counts) / ctx.epochs
