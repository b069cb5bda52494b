"""Batch: the bundle every model consumes, on an explicit device.

Counterpart of ``allset_tpu/graph/batch.py``: features, labels, the
incidence (None for the structure-free MLP and HyperGCN's reapprox
path; the V2V graph for CEGCN/CEGAT, the Laplacian for HyperGCN) and the
per-model extras (HNHN's norm vectors, UniGNN's degrees as tensors;
HAN's metapath graphs as whole Incidences), all on one device; the
edge-partitioned exchange ``shex`` (``parallel/sharded.py``), through
which SetGNN, HCHA and UniGNN route their exchanges when it is set; and
``split_masks``. The device is the card unless the caller
names another; without a card that default raises, it never falls back
to the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from allset_tpu_torch.graph.incidence import Incidence
from allset_tpu_torch.graph.transforms import HyperData


@dataclasses.dataclass(frozen=True)
class Batch:
    x: torch.Tensor  # [N, F] float32
    y: torch.Tensor  # [N] int64
    inc: Optional[Incidence]
    extras: Dict[str, Union[torch.Tensor, Incidence]] = dataclasses.field(default_factory=dict)
    # a placed parallel.sharded.ShardedExchange (ShardedExchange.shard),
    # on its Comm's device
    shex: Optional[object] = None

    @property
    def num_nodes(self) -> int:
        return self.x.shape[0]

    @classmethod
    def from_hyperdata(
        cls, data: HyperData, device="cuda", bucket: int = 256,
        with_incidence: bool = True,
    ) -> "Batch":
        inc = data.to_incidence(bucket=bucket) if with_incidence else None
        return cls.from_incidence(data, inc, device)

    @classmethod
    def from_incidence(cls, data: HyperData, inc: Optional[Incidence],
                       device="cuda") -> "Batch":
        """``data``'s features, labels and extras with another structure
        ``inc`` (a V2V graph, a Laplacian, or None), all on ``device``."""
        return cls(
            x=torch.as_tensor(data.x, dtype=torch.float32),
            y=torch.as_tensor(data.y, dtype=torch.int64),
            inc=inc,
            extras={k: torch.as_tensor(v) for k, v in data.extras.items()},
        ).to(device)

    def to(self, device) -> "Batch":
        """Every tensor and Incidence of the batch, extras included, on
        ``device`` (a CUDA device raises where there is none). A ``shex``
        is kept as it is: it was placed on its Comm's device."""
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Batch: no CUDA device is available "
                               "(pass device='cpu' for the plain versions)")
        return Batch(
            x=self.x.to(device),
            y=self.y.to(device),
            inc=None if self.inc is None else self.inc.to(device),
            extras={k: v.to(device) for k, v in self.extras.items()},
            shex=self.shex,
        )


def split_masks(split_idx: Dict[str, np.ndarray], num_nodes: int) -> Dict[str, torch.Tensor]:
    """Index arrays -> boolean node masks [num_nodes] (on the CPU)."""
    out = {}
    for k, idx in split_idx.items():
        m = np.zeros(num_nodes, dtype=bool)
        m[np.asarray(idx)] = True
        out[k] = torch.from_numpy(m)
    return out
