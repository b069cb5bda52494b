"""The port's profiling utilities (``allset_tpu_torch/utils/profiling.py``)
against the JAX package's (``allset_tpu/utils/profiling.py``): the same
keys from ``time_fn`` and ``StepTimer.summary`` on the same trivial work;
``trace`` writes a trace file of CPU activity on the CPU and refuses a
CUDA trace it cannot take; ``trace_summary`` reads the device ops, their
times and the busy share of a trace. ``--profile`` on the CLI:
``tests/test_torch_trainer.py::test_cli_unported_parts_raise``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from allset_tpu.utils import profiling as jprof
from allset_tpu_torch.utils import profiling as prof


def test_time_fn_keys_equal_the_jax_time_fn():
    want = jprof.time_fn(lambda a: a + 1, jnp.ones(4), iters=3, warmup=1)
    got = prof.time_fn(lambda a: a + 1, torch.ones(4), iters=3, warmup=1)
    assert set(got) == set(want)
    assert got["iters"] == want["iters"] == 3
    assert 0 < got["min_s"] <= got["median_s"] and got["mean_s"] > 0


def test_time_fn_fences_nested_outputs():
    """Outputs in tuples, lists and dicts (a CPU output needs no fence)."""
    got = prof.time_fn(lambda: {"a": (torch.ones(2), [torch.zeros(1)])}, iters=2, warmup=1)
    assert got["iters"] == 2


def test_step_timer_summary_keys_equal_the_jax_one():
    for timer in (jprof.StepTimer(), prof.StepTimer()):
        for _ in range(3):
            with timer:
                sum(range(100))
    assert set(prof.StepTimer().summary()) == set(jprof.StepTimer().summary())
    t = prof.StepTimer()
    with t:
        pass
    assert t.summary()["n"] == 1


def test_trace_writes_a_cpu_trace(tmp_path):
    x = torch.randn(64, 64)
    with prof.trace(str(tmp_path), device="cpu") as d:
        y = x @ x
    assert d == str(tmp_path) and torch.isfinite(y).all()
    path = prof.latest_trace(str(tmp_path))
    assert path.endswith(prof.TRACE_SUFFIX)
    events = json.load(open(path))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    summ = prof.trace_summary(path)
    assert summ["ops"] == [] and summ["busy_share"] == 0.0 and summ["span_ms"] > 0


def test_trace_refuses_cuda_without_cupti(monkeypatch, tmp_path):
    """Where CUPTI cannot trace the card, a CUDA trace raises and writes
    nothing."""
    monkeypatch.setattr(torch.profiler, "supported_activities",
                        lambda: {torch.profiler.ProfilerActivity.CPU})
    with pytest.raises(RuntimeError, match="CUPTI"):
        with prof.trace(str(tmp_path / "t"), device="cuda"):
            pass
    assert not (tmp_path / "t").exists()


def test_trace_summary_reads_device_ops_and_busy_share(tmp_path):
    """Two overlapping kernels and a copy over a 100 us window: the union
    of their intervals is busy, the ops largest first."""
    events = [{"ph": "X", "cat": "cpu_op", "name": "step", "ts": 0, "dur": 100},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "k2", "ts": 20, "dur": 20},
              {"ph": "X", "cat": "kernel", "name": "k1", "ts": 60, "dur": 10},
              {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90, "dur": 5},
              {"ph": "i", "cat": "kernel", "name": "marker", "ts": 99}]
    path = tmp_path / ("x" + prof.TRACE_SUFFIX)
    path.write_text(json.dumps({"traceEvents": events}))
    s = prof.trace_summary(str(path), top=2)
    assert [r[0] for r in s["ops"]] == ["k1", "k2"]
    np.testing.assert_allclose([s["ops"][0][1], s["ops"][0][2]], [0.030, 2])
    assert s["kernels"] == ["k1", "k2"]
    np.testing.assert_allclose([s["busy_ms"], s["span_ms"], s["busy_share"]],
                               [0.045, 0.100, 0.45])


def test_latest_trace_without_a_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        prof.latest_trace(str(tmp_path))
