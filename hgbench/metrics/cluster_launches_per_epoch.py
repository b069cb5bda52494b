"""port kernels: the PMA epilogue's launches on the two-block cluster
kernels (K2R and K3a at HC 384 and 512), as the trainer counts them in
each ``trainer.epoch`` span (``counts["pma_cluster"]``, from
``ops/_kernels.routes``), summed over the traced fit's groups, per epoch
of the job (``hgbench/spans.py``). A program that does not count them
gives None."""

from hgbench import spans


def read(ctx):
    fit = spans.traced_fit()
    sel = spans.named(fit, "trainer.epoch") if fit else []
    counts = [s.counts.get("pma_cluster") for s in sel]
    if not sel or None in counts or ctx.epochs <= 0:
        return None
    return sum(counts) / ctx.epochs
