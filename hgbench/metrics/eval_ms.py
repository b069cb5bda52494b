"""step: evaluation forward. Device ms per epoch of the traced fit's
``trainer.eval`` spans (the evaluation forward, its metrics, the
best-state update): the elapsed time of the timing events at each span's
edges on the card, summed over the job's groups (``hgbench/spans.py``)."""

from hgbench import spans


def read(ctx):
    return spans.device_ms_per_epoch("trainer.eval", ctx.epochs)
