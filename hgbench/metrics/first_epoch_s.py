"""set-up: host seconds of the process's first ``trainer.epoch`` span, the
check job's epoch 0 (the first launches, the libraries and kernel modules
loading); read once a traced fit exists (``hgbench/spans.py``)."""

from hgbench import spans


def read(ctx):
    if not spans.traced_fit():
        return None
    first = [s for s in spans.recorded() if s.name == "trainer.epoch"][:1]
    return first[0].seconds if first else None
