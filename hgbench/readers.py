"""What a per-layer metric's reader reads: ``Context``, made from the
traced job. A reader is ``read(ctx)``, returning the metric's value, or
None where the traced job gave it nothing to read (a layer whose kernels
never ran); the harness then leaves the metric out of the result."""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

from hgbench import costs
from hgbench.trace import kernel_base


@dataclasses.dataclass
class Context:
    """The traced job: ``device_s`` {device op: seconds}, ``busy_s`` and
    ``window_s`` (its span), its ``epochs`` and ``groups`` (runs per group,
    as the trainer folded them), and the cell's ``shapes``."""

    device_s: Dict[str, float]
    busy_s: float
    window_s: float
    epochs: int
    groups: Sequence[int]
    shapes: costs.Shapes

    def claimed(self, patterns: Sequence[str]) -> float:
        """Device seconds of the ops whose name, without its return type,
        starts with one of ``patterns`` (the port's kernels, which live in
        no namespace)."""
        return sum(s for name, s in self.device_s.items()
                   if kernel_base(name).startswith(tuple(patterns)))

    def unclaimed(self, patterns: Sequence[str]) -> float:
        return sum(self.device_s.values()) - self.claimed(patterns)

    def ms_per_epoch(self, seconds: float) -> float:
        return seconds * 1e3 / self.epochs

    def share(self, bound_s_per_epoch: float, seconds: float) -> float:
        """Percent of the least time (per epoch) in the measured time."""
        return 100.0 * bound_s_per_epoch * self.epochs / seconds
