"""A cell at a size a CPU test holds: the cell's configuration on a
small walmart-shaped graph, 2 runs x 4 epochs."""

import copy

from hgbench import manifest

GRAPH = {"generator": "cornell_like", "graph_seed": 0, "num_nodes": 400, "num_hyperedges": 300,
         "avg_edge_size": 5, "num_classes": 5, "feature_dim": 24, "feature_noise": 1.0,
         "exponent": 1.2, "homophily": 0.6}
JOB = {"runs": 2, "epochs": 4, "vmap_chunk": None, "train_prop": 0.5, "valid_prop": 0.25}
# at this size a relu that flips on rounding moves a leaf by up to a few
# 1e-5 (a hundredth of the update's); the faults read 1e-2 and more
LIMITS = {"train_loss": 1e-4, "eval_loss": 1e-3, "grad": 1e-3, "update": 0.05}


def tiny_cell(workload: str = "ast-walmart-r20", chunk=None) -> manifest.Cell:
    cell = manifest.cell(workload)
    cell.traffic = {"graph": dict(GRAPH), "job": dict(JOB, vmap_chunk=chunk)}
    cell.limits = dict(LIMITS)
    return copy.deepcopy(cell)
