"""The comparison that decides ``correct``: the numbers read from the
program's first steps of a job against the reference's, each beside its
limit.

  * ``train_loss``: the largest relative gap of a training loss (the
    forward with dropout, before each step), over every run and step of
    every job compared;
  * ``eval_loss``: the same of the validation and test losses after each
    step (the evaluation forward);
  * ``grad``: the worst leaf's gap between the program's and the
    reference's norm of the first gradient, against the larger of the
    reference's norm of that leaf and of the median leaf;
  * ``update``: the same of each leaf's change over the steps, leaving out
    the leaves whose first gradient in the reference is under a thousandth
    of the median leaf's (round-off alone moves them under Adam).

A leaf is one run's slice of one parameter. A number that is not finite
fails its limit.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

NAMES = ("train_loss", "eval_loss", "grad", "update")
QUIET = 1e-3  # a leaf whose reference gradient is under this share of the median's


def _rel_gap(got: np.ndarray, want: np.ndarray) -> float:
    if got.shape != want.shape:
        return float("inf")
    gap = np.abs(got - want) / np.abs(want)
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else float("inf")


def _leaf_gap(got: np.ndarray, want: np.ndarray, keep=None) -> float:
    if got.shape != want.shape:
        return float("inf")
    scale = np.maximum(want, np.median(want))
    gap = np.abs(got - want) / scale
    if keep is not None:
        gap = gap[keep]
    return float(np.max(gap)) if np.all(np.isfinite(gap)) else float("inf")


def loss_numbers(jobs: Sequence[Dict[str, np.ndarray]], ref: Dict[str, np.ndarray]) -> dict:
    """train_loss and eval_loss over the jobs' losses (``program.losses``)."""
    return {"train_loss": max(_rel_gap(j["train_loss"], ref["train_loss"]) for j in jobs),
            "eval_loss": max(_rel_gap(j["eval_loss"], ref["eval_loss"]) for j in jobs)}


def leaf_numbers(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> dict:
    """grad and update over [runs, leaves] norms."""
    if got is None:
        return {"grad": float("inf"), "update": float("inf")}
    keep = ref["grad"] >= QUIET * np.median(ref["grad"])
    return {"grad": _leaf_gap(got["grad"], ref["grad"]),
            "update": _leaf_gap(got["update"], ref["update"], keep)}


def worst(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> dict:
    """Where grad and update read their number: {key: (leaf name, run,
    gap)}, for the record."""
    out = {}
    if got is None or got["grad"].shape != ref["grad"].shape:
        return out
    keep = ref["grad"] >= QUIET * np.median(ref["grad"])
    for k in ("grad", "update"):
        gap = np.abs(got[k] - ref[k]) / np.maximum(ref[k], np.median(ref[k]))
        gap = np.where(np.isnan(gap), np.inf, gap)
        if k == "update":
            gap = np.where(keep, gap, -np.inf)
        r, i = np.unravel_index(np.argmax(gap), gap.shape)
        out[k] = (ref["names"][i], int(r), float(gap[r, i]))
    return out


def numbers(jobs, leaves, ref) -> dict:
    return {**loss_numbers(jobs, ref), **leaf_numbers(leaves, ref)}


def judge(nums: dict, limits: dict) -> bool:
    """Every number finite and at most its limit."""
    return all(np.isfinite(nums[k]) and nums[k] <= limits[k] for k in NAMES)


def job_ok(job: Dict[str, np.ndarray], ref: Dict[str, np.ndarray], limits: dict) -> bool:
    """One job's losses within the limits."""
    n = loss_numbers([job], ref)
    return all(np.isfinite(v) and v <= limits[k] for k, v in n.items())
