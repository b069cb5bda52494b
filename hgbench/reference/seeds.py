"""Where each run's randomness comes from: frozen copies of the rules of
``allset_tpu_torch/train/trainer.py::run_seeds`` and ``Trainer.masks`` and
of ``graph/transforms.py::rand_train_test_idx`` at commit b978a993e545.

Run r of a job with seed s: its split is the r-th draw of
``numpy.random.default_rng(s)``, its parameters come from a CPU
``torch.Generator`` seeded with the first word of
``numpy.random.SeedSequence([s, r])``, and its dropout masks from a
generator on the job's device seeded with the second.
"""

from __future__ import annotations

import numpy as np
import torch


def run_seeds(seed: int, run: int) -> tuple:
    """(init seed, dropout seed) of run ``run``."""
    a, b = np.random.SeedSequence([seed, run]).generate_state(2, dtype=np.uint64)
    return int(a), int(b)


def split_indices(label: np.ndarray, train_prop: float, valid_prop: float,
                  rng: np.random.Generator) -> dict:
    """One random split of the labelled nodes (reference
    ``src/preprocessing.py:472-519``, unbalanced): {train, valid, test}
    index arrays."""
    labeled = np.where(label != -1)[0]
    n = len(labeled)
    train_num = int(n * train_prop)
    valid_num = int(n * valid_prop)
    perm = rng.permutation(n)
    return {"train": labeled[perm[:train_num]],
            "valid": labeled[perm[train_num:train_num + valid_num]],
            "test": labeled[perm[train_num + valid_num:]]}


def split_masks(label: np.ndarray, runs: int, train_prop: float, valid_prop: float,
                seed: int) -> list:
    """Each run's {train, valid, test: [N] bool numpy masks}."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(runs):
        idx = split_indices(label, train_prop, valid_prop, rng)
        masks = {}
        for k, v in idx.items():
            m = np.zeros(len(label), bool)
            m[v] = True
            masks[k] = m
        out.append(masks)
    return out


def init_generator(seed: int, run: int) -> torch.Generator:
    return torch.Generator().manual_seed(run_seeds(seed, run)[0])


def dropout_generator(seed: int, run: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(run_seeds(seed, run)[1])
