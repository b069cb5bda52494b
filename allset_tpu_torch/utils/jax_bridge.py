"""Carry the JAX package's parameters across, without importing jax.

The port's modules use the flax names (``V2E_0/prop/lin_K/kernel``,
``att_r``, ``ln0/scale``, ``rFF/lin{i}``, ``classifier/lin0``...; the
zoo's ``conv{i}/weight``, ``conv{i}/W/kernel``, ``att_e``, ``eps``,
``weight_v2e``, ``lin_in``, ``mlp/norm0/LayerNorm_0``, ``PReLU_0/
negative_slope``...; CEGCN's and CEGAT's ``conv{i}/weight``,
``conv{i}/att_l``, ``conv{i}/att_r``, ``conv{i}/bias``; HyperGCN's
``layer{i}/W``, ``layer{i}/bias`` and, on the reapprox path, ``W{i}``,
``bias{i}``; HAN's and MetapathHAN's ``gat_l{i}_p{j}/fc``, ``attn_l``,
``attn_r``, ``sem_l{i}/proj1``, ``proj2``, ``predict``, SampledHAN's
``gat_p{j}``, ``sem``), so a ``state_dict`` key is the flax path joined by dots. Kernels keep the flax
layout ``[in, out]``: nothing is transposed. The input is the flax
``params`` tree with its leaves converted to numpy arrays. A vmapped
tree (a leading runs axis on every leaf, the same keys) gives the
parameters of the port's runs model, built with a list of generators.
The flax ``batch_stats`` collection (the running 'mean' and 'var' of
every BatchNorm) goes into the buffers of the same names.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def params_from_jax(tree: Mapping, prefix: str = "",
                    batch_stats: Optional[Mapping] = None) -> dict:
    """Nested {name: subtree | array} -> {"a.b.c": float32 tensor}; with
    ``batch_stats`` (the flax collection of the same model) its entries
    too, so the result loads as the port model's whole ``state_dict``."""
    out = {}
    for name, v in tree.items():
        key = f"{prefix}{name}"
        if isinstance(v, Mapping):
            out.update(params_from_jax(v, key + "."))
        else:
            out[key] = torch.from_numpy(np.array(v, dtype=np.float32))
    if batch_stats:
        out.update(params_from_jax(batch_stats, prefix))
    return out
