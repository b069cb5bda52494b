"""The program's span recorder, read for the span and counter metrics.

The port's trainer records spans (``allset_tpu_torch/utils/profiling.py``:
``trainer.fit``, ``trainer.masks``, ``trainer.init``, ``trainer.epoch``
with its port launches in ``counts["launches"]``, ``trainer.forward``,
``trainer.backward``, ``trainer.optimizer``, ``trainer.eval``,
``trainer.collect``), each with the id of its fit, its host times and,
under the profiler on the card, its device milliseconds. This module
finds the recorder in the already-imported module and imports nothing of
the program: a tree whose program records no spans gives None
everywhere, and so does a recorder that dropped spans beyond its cap.

"The traced fit" is the last fit whose spans were recorded with the
profiler active: the traced job's.
"""

from __future__ import annotations

import sys
from typing import List, Optional

MODULE = "allset_tpu_torch.utils.profiling"


def recorded() -> Optional[list]:
    """The recorder's spans, or None where the module, its ``spans``
    accessor or a whole record is missing."""
    mod = sys.modules.get(MODULE)
    get, dropped = getattr(mod, "spans", None), getattr(mod, "dropped", None)
    if not callable(get) or not callable(dropped) or dropped():
        return None
    return list(get())


def traced_fit() -> Optional[List]:
    """The traced fit's spans, the fit's own first; None where there is no
    such fit."""
    spans = recorded()
    fits = [s for s in spans or () if s.name == "trainer.fit" and s.profiled]
    if not fits:
        return None
    fid = fits[-1].id
    return [fits[-1]] + [s for s in spans if s.fit == fid and s.id != fid]


def named(fit: list, name: str) -> list:
    return [s for s in fit if s.name == name]


def device_ms_per_epoch(name: str, epochs: int) -> Optional[float]:
    """Device ms of the traced fit's ``name`` spans, summed, per epoch of
    the job; None where any of them has no device time (the CPU)."""
    fit = traced_fit()
    sel = named(fit, name) if fit else []
    ms = [s.device_ms for s in sel]
    if not sel or any(m is None for m in ms) or epochs <= 0:
        return None
    return sum(ms) / epochs
