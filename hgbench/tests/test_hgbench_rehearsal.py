"""The harness end to end on the CPU at a tiny size, and its refusals."""

import json
import shutil
import subprocess
import sys

from hgbench import manifest

REHEARSE = ("import json, sys; sys.path.insert(0, 'hgbench/tests'); "
            "from tiny import tiny_cell; from hgbench import run; "
            "out = run.run(tiny_cell('{w}'), 12, 0.2, {t}, device='cpu'); "
            "print(json.dumps({{'correct': out['correct'], 'metrics': sorted(out['metrics']), "
            "'forbidden': run.forbidden_modules(), "
            "'loaded': sorted({{m.split('.')[0] for m in sys.modules}})}}))")


def _rehearse(workload, trace):
    p = subprocess.run([sys.executable, "-c", REHEARSE.format(w=workload, t=trace)],
                       cwd=manifest.ROOT, capture_output=True, text=True, check=True)
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_rehearsal_loads_no_jax():
    """A whole run, window and reference, on the CPU: correct, and no module
    whose top-level name is jax, jaxlib, flax or allset_tpu loaded; the
    port (allset_tpu_torch, whose name begins with allset_tpu) is."""
    out = _rehearse("ads-walmart-r20", False)
    assert out["correct"]
    assert out["metrics"] == ["run_epochs_per_s", "setup_s"]
    assert out["forbidden"] == []
    assert "allset_tpu_torch" in out["loaded"]
    assert not set(out["loaded"]) & {"jax", "jaxlib", "flax", "allset_tpu"}


def test_traced_rehearsal():
    out = _rehearse("ast-walmart-r20", True)
    assert out["correct"] and out["forbidden"] == []
    assert "runs_per_group" in out["metrics"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "-m", "hgbench.run", "--workload", "ast-walmart-r20",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=manifest.ROOT,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copytree(manifest.ROOT / "hgbench", tmp_path / "hgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-m", "hgbench.run", "--workload", "ast-walmart-r20",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True)
    assert p.returncode != 0 and p.stdout.strip() == ""
