"""Dataset statistics (reference ``src/print_dataset_statistics.py:22-79``).

Counterpart of ``allset_tpu/data/statistics.py``: node and hyperedge
counts, feature and class counts, the hyperedge-size and node-degree
distributions (max, min, mean, median), and the per-shard entry skew of
the edge-partitioned exchange (``parallel/sharded.py``) at ``num_shards``:
the largest shard's entries over the mean, under equal row blocks and
under the segment-aware balanced cuts, for each direction's
destination-sorted entry stream.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from allset_tpu_torch.graph.transforms import HyperData
from allset_tpu_torch.parallel.sharded import shard_entry_counts


def dataset_statistics(data: HyperData, num_shards: int = 8) -> Dict[str, float]:
    he_sizes = np.bincount(data.edge, minlength=data.num_hyperedges)
    he_sizes = he_sizes[he_sizes > 0]
    v_deg = np.bincount(data.node, minlength=data.num_nodes)

    def dist(x, prefix):
        return {
            f"{prefix}_max": float(x.max()),
            f"{prefix}_min": float(x.min()),
            f"{prefix}_avg": float(x.mean()),
            f"{prefix}_median": float(np.median(x)),
        }

    out = {
        "num_nodes": data.num_nodes,
        "num_hyperedges": data.num_hyperedges,
        "nnz": data.nnz,
        "num_features": data.num_features,
        "num_classes": data.num_classes,
    }
    out.update(dist(he_sizes, "he_size"))
    out.update(dist(v_deg, "node_degree"))
    avg = max(data.nnz / num_shards, 1.0)
    for side, ids, num in (("v2e", data.edge, data.num_hyperedges),
                           ("e2v", data.node, data.num_nodes)):
        eq, bal, _ = shard_entry_counts(np.sort(np.asarray(ids)), num, num_shards)
        out[f"shard{num_shards}_{side}_skew_rowblock"] = float(eq.max() / avg)
        out[f"shard{num_shards}_{side}_skew_balanced"] = float(bal.max() / avg)
    return out


def print_statistics_table(names_and_data) -> str:
    """One CSV row of statistics per (name, HyperData), printed and
    returned."""
    rows = {name: dataset_statistics(data) for name, data in names_and_data}
    keys = list(next(iter(rows.values())).keys())
    lines = ["dataset," + ",".join(keys)]
    for name, st in rows.items():
        lines.append(name + "," + ",".join(f"{st[k]:g}" for k in keys))
    table = "\n".join(lines)
    print(table)
    return table
