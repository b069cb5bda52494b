"""trainer: host ms of the traced job's runs' set-up, its ``trainer.masks``
span (the runs' splits) plus every ``trainer.init`` span (each group's
parameter draws on the CPU, generators, Adam, metric buffers), while the
device has nothing queued (``hgbench/spans.py``)."""

from hgbench import spans


def read(ctx):
    fit = spans.traced_fit()
    if not fit:
        return None
    sel = spans.named(fit, "trainer.masks") + spans.named(fit, "trainer.init")
    return sum(s.seconds for s in sel) * 1e3 if sel else None
