"""The plain reference against the port's plain CPU path, and what the
reference imports."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hgbench import compare, control, graphs, manifest
from hgbench.reference import model as ref
from hgbench.reference.follow import follow
from tiny import tiny_cell

REFERENCE = Path(__file__).resolve().parents[1] / "reference"


@pytest.mark.parametrize("workload", ["ast-walmart-r20", "ads-walmart-r20"])
def test_names_and_shapes_are_the_ports(workload):
    from allset_tpu_torch.models import build_model
    from allset_tpu_torch.train.factory import ExperimentConfig, prepare
    from allset_tpu_torch.graph.transforms import HyperData
    from hgbench.program import FLAGS

    cell = tiny_cell(workload)
    g = graphs.make_graph(cell.traffic["graph"], 1)
    cfg = ExperimentConfig(**{f: cell.config[k] for k, f in FLAGS.items() if k in cell.config})
    mcfg, _ = prepare(cfg, HyperData(x=g.x, y=g.y, node=g.node, edge=g.edge,
                                     num_nodes=g.num_nodes, num_hyperedges=g.num_hyperedges),
                      "cpu")
    gens = [torch.Generator().manual_seed(s) for s in (4, 9)]
    port = build_model(mcfg, gens)
    mine = [ref.init_params(ref.model_of(cell.config, g), torch.Generator().manual_seed(s))
            for s in (4, 9)]
    got = list(port.named_parameters())
    assert [n for n, _ in got] == list(mine[0])
    for (name, p), r0, r1 in zip(got, mine[0].values(), mine[1].values()):
        assert torch.equal(p[0], r0) and torch.equal(p[1], r1), name


@pytest.mark.parametrize("workload,chunk", [("ast-walmart-r20", None), ("ads-walmart-r20", 1)])
@pytest.mark.parametrize("seed", [2, 2**31 + 3])
def test_reference_follows_the_plain_path(workload, chunk, seed):
    """2 runs x 3 steps on the CPU: the program's plain versions and the
    reference agree within the tiny cell's limits."""
    cell = tiny_cell(workload, chunk)
    g = graphs.make_graph(cell.traffic["graph"], seed)
    want = follow(cell.config, cell.traffic["job"], g, seed, 3, "cpu")
    nums = control.program_numbers(cell, seed, "cpu", 3, want)
    assert compare.judge(nums, cell.limits), nums


def test_reference_imports_nothing_of_the_program():
    for path in REFERENCE.glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                top = m.split(".")[0]
                assert top not in ("allset_tpu_torch", "allset_tpu", "jax", "jaxlib", "flax"), \
                    (path.name, m)
                if top == "hgbench":
                    assert m in ("hgbench.graphs",) or m.startswith("hgbench.reference"), m
    code = ("import json, sys; from hgbench import manifest, graphs; "
            "from hgbench.reference.follow import follow; "
            "sys.path.insert(0, 'hgbench/tests'); from tiny import tiny_cell; "
            "c = tiny_cell(); g = graphs.make_graph(c.traffic['graph'], 1); "
            "follow(c.config, c.traffic['job'], g, 1, 2, 'cpu'); "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT, capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    loaded = set(__import__("json").loads(out))
    assert not loaded & {"allset_tpu_torch", "allset_tpu", "jax", "jaxlib", "flax"}, loaded
