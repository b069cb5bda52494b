"""step: optimizer. Device ms per epoch of the traced fit's
``trainer.optimizer`` spans (Adam's step over the stacked runs): the
elapsed time of the timing events at each span's edges on the card,
summed over the job's groups (``hgbench/spans.py``)."""

from hgbench import spans


def read(ctx):
    return spans.device_ms_per_epoch("trainer.optimizer", ctx.epochs)
