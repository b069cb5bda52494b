"""BENCHMARK.json against the benchmark's contract, every cell's files
found by name, and a cell added as files alone."""

import json
import re
import shutil

import pytest

from hgbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = manifest.load()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["hgbench"]
    assert all(_line(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    # 2 + 14 runs a cell of run_seconds + 60 s, 180 s a cell to compile,
    # 1200 s spare, at the full 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_entries():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("hgbench/") and c["reduced"] == []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] == 1 and _line(w["why"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in names
        assert m["better"] in ("lower", "higher")
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in names
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]} and _line(m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", manifest.workloads())
def test_cell_files_found_by_name(workload):
    cell = manifest.cell(workload)
    assert cell.config["name"] == cell.config_name
    assert {"graph", "job"} <= set(cell.traffic)
    assert set(cell.limits) == {"train_loss", "eval_loss", "grad", "update"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "run_epochs_per_s"}
    assert cell.per_layer
    for name, mod in manifest.readers(cell).items():
        assert callable(mod.read), name


def test_a_cell_added_as_files(tmp_path):
    """A throwaway configuration, mix, limits and metric, added as files
    and entries in a copy, are listed and found without an edit."""
    root = tmp_path / "copy"
    shutil.copytree(manifest.ROOT / "hgbench", root / "hgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    conf = json.loads((manifest.ROOT / "hgbench/configs/allset_transformer-walmart.json")
                      .read_text())
    conf.update(name="allset_transformer-tiny", MLP_hidden=64, heads=1)
    (root / "hgbench/configs/allset_transformer-tiny.json").write_text(json.dumps(conf))
    (root / "hgbench/traffic/tiny-r2.json").write_text(json.dumps({
        "graph": {"generator": "scale_free", "graph_seed": 0, "num_nodes": 300,
                  "num_hyperedges": 150, "avg_edge_size": 5, "feature_dim": 16},
        "job": {"runs": 2, "epochs": 3, "vmap_chunk": 1, "train_prop": 0.5,
                "valid_prop": 0.25}}))
    (root / "hgbench/limits/tiny-cell.json").write_text(json.dumps(
        {"train_loss": 1e-4, "eval_loss": 1e-3, "grad": 1e-3, "update": 0.05}))
    (root / "hgbench/metrics/groups.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx.groups))\n")
    bench["configs"].append({"name": "allset_transformer-tiny", "source": "a test",
                             "file": "hgbench/configs/allset_transformer-tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny-cell", "config": "allset_transformer-tiny",
                               "traffic": "tiny-r2", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "groups.count", "unit": "groups", "better": "lower",
                               "source": "program_counter", "layer": "trainer",
                               "moves": "run_epochs_per_s", "workloads": ["tiny-cell"]})
    for m in bench["end_to_end"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    assert "tiny-cell" in manifest.workloads(root)
    cell = manifest.cell("tiny-cell", root)
    assert cell.config["MLP_hidden"] == 64 and cell.traffic["job"]["vmap_chunk"] == 1
    assert [m["name"] for m in cell.per_layer] == ["groups.count"]

    from hgbench import run

    out = run.run(cell, 5, 0.1, True, device="cpu", root=root)
    assert out["correct"], out["checks"]
    assert out["metrics"]["groups.count"]["value"] == 2.0
