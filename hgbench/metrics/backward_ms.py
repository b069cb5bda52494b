"""step: backward. Device ms per epoch of the traced fit's
``trainer.backward`` spans (``loss.sum().backward()``; autograd launches
its work from its own thread while the span stays open on the trainer's):
the elapsed time of the timing events at each span's edges on the card,
summed over the job's groups (``hgbench/spans.py``)."""

from hgbench import spans


def read(ctx):
    return spans.device_ms_per_epoch("trainer.backward", ctx.epochs)
