"""The port's profiling utilities (``allset_tpu_torch/utils/profiling.py``)
and the benchmark's readers of them: spans nest with their parent's and
their fit's ids, build no profiler range with the profiler off, stop at
the recorder's cap; ``Trainer.fit`` records its spans and reads its wall
time from them; the ranges show in a trace; the span and counter metrics
of ``hgbench/metrics/`` read a recorder, and give None without one.
``trace`` writes a trace file of CPU activity on the CPU and refuses a
CUDA trace it cannot take; ``trace_summary`` reads the device ops, their
times and the busy share of a trace. ``--profile`` on the CLI:
``tests/test_torch_trainer.py::test_cli_unported_parts_raise``."""

import collections
import json
import sys
import threading
import types

import numpy as np
import pytest
import torch

import allset_tpu_torch.data.registry as treg
import allset_tpu_torch.graph.transforms as ttr
from allset_tpu_torch.graph.batch import Batch
from allset_tpu_torch.models import SetGNNConfig
from allset_tpu_torch.train import TrainConfig, Trainer
from allset_tpu_torch.utils import profiling as prof
from hgbench import manifest
from hgbench import spans as hspans

PHASES = ("trainer.forward", "trainer.backward", "trainer.optimizer", "trainer.eval")
READERS = ("forward_ms", "backward_ms", "optimizer_ms", "eval_ms", "runs_init_ms",
           "first_epoch_s", "launches_per_epoch")


def _trainer(epochs=3, runs=4, chunk=2, device="cpu", name="synthetic", hidden=32, heads=2):
    """A SetGNN Trainer of ``runs`` runs in groups of ``chunk`` on a
    synthetic set (the small one by default)."""
    data = treg.load_dataset(name, feature_noise=1.0)
    tb = Batch.from_hyperdata(ttr.norm_construction(ttr.add_self_loops(data), "all_one"),
                              device=device)
    cfg = SetGNNConfig(num_features=data.num_features, num_classes=data.num_classes,
                       all_num_layers=1, mlp_hidden=hidden, heads=heads, classifier_hidden=16)
    return Trainer(cfg, tb, TrainConfig(epochs=epochs, runs=runs, vmap_chunk=chunk, seed=1))


def _fit(**kw):
    """A fit on an emptied recorder: (its Results, the spans it recorded)."""
    prof.reset()
    res = _trainer(**kw).fit()
    return res, prof.spans()


def test_spans_nest_with_parent_and_fit_ids():
    rec = prof.Recorder()
    with rec.span("outside") as out:
        pass
    with rec.span("job", fit=True) as job:
        with rec.span("a") as a:
            with rec.span("b") as b:
                pass
        with rec.span("c") as c:
            c.counts["n"] = 3
    with rec.span("job", fit=True) as job2:
        pass
    assert [s.name for s in rec.spans()] == ["outside", "b", "a", "c", "job", "job"]
    assert (out.parent, out.fit) == (None, None)
    assert (job.parent, job.fit) == (None, job.id)
    assert (a.parent, b.parent, c.parent) == (job.id, a.id, job.id)
    assert a.fit == b.fit == c.fit == job.id != job2.fit == job2.id
    assert len({s.id for s in rec.spans()}) == 6 and c.counts == {"n": 3}
    assert job.t0_ns <= a.t0_ns <= b.t0_ns <= b.t1_ns <= a.t1_ns <= c.t0_ns <= job.t1_ns
    assert job.seconds >= a.seconds >= 0 and job.device_ms is None and not job.profiled


def test_spans_nest_on_the_opening_thread():
    """A span another thread opens inside the main thread's span is not
    its child."""
    rec = prof.Recorder()
    got = {}

    def worker():
        with rec.span("other") as s:
            got["span"] = s

    with rec.span("main", fit=True):
        t = threading.Thread(target=worker)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive()
    assert (got["span"].parent, got["span"].fit) == (None, None)


def test_no_profiler_range_with_the_profiler_off(monkeypatch):
    """With the profiler off a span and ``annotate`` build no
    record_function (one that raises shows it) and no timing event; with
    it on, both open one."""
    def refuse(*a, **k):
        raise AssertionError("record_function built with the profiler off")

    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    rec = prof.Recorder()
    with rec.span("x", device="cpu") as s, prof.annotate("y"):
        pass
    assert not s.profiled and s.device_ms is None
    built = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: built.append(name) or real(name))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with rec.span("x", device="cpu") as s, prof.annotate("y"):
            pass
    assert s.profiled and s.device_ms is None and built == ["x", "y"]


def test_recorder_keeps_its_cap_and_counts_the_rest():
    rec = prof.Recorder(cap=3)
    for i in range(5):
        with rec.span(f"s{i}"):
            pass
    assert [s.name for s in rec.spans()] == ["s0", "s1", "s2"] and rec.dropped == 2
    rec.reset()
    assert rec.spans() == [] and rec.dropped == 0
    with rec.span("again"):
        pass
    assert [s.name for s in rec.spans()] == ["again"]


def test_trainer_fit_records_its_spans():
    """2 groups x 3 epochs: one fit, its splits, an init a group, 6 epochs,
    each with the four phases and a launch count, a collect a group and
    the final one; every span carries the fit's id, each phase an epoch
    as its parent."""
    res, sp = _fit()
    assert res.groups == [2, 2]
    counts = collections.Counter(s.name for s in sp)
    assert counts == {"trainer.fit": 1, "trainer.masks": 1, "trainer.init": 2,
                      "trainer.epoch": 6, **{p: 6 for p in PHASES}, "trainer.collect": 3}
    fit = [s for s in sp if s.name == "trainer.fit"][0]
    assert {s.fit for s in sp} == {fit.id} and sp[-1] is fit
    by_id = {s.id: s for s in sp}
    for s in sp:
        want = "trainer.epoch" if s.name in PHASES else "trainer.fit"
        assert s is fit or by_id[s.parent].name == want
    epochs = [s for s in sp if s.name == "trainer.epoch"]
    assert all(s.counts == {"launches": 0} for s in epochs)  # the CPU launches no kernel
    assert all(s.device_ms is None and not s.profiled for s in sp)


def test_wall_time_is_the_fit_span():
    res, sp = _fit(epochs=2, runs=2, chunk=None)
    fit = [s for s in sp if s.name == "trainer.fit"][0]
    assert res.wall_time == fit.seconds > 0
    assert fit.seconds >= sum(s.seconds for s in sp if s.parent == fit.id)


def test_trace_shows_the_trainer_and_model_ranges(tmp_path):
    """A CPU trace from ``profiling.trace`` holds each trainer span and
    the model's V2E, E2V and classifier ranges as user annotations; the
    recorded spans say they were profiled."""
    with prof.trace(str(tmp_path), device="cpu"):
        _, sp = _fit(epochs=2, runs=2, chunk=None)
    events = json.load(open(prof.latest_trace(str(tmp_path))))["traceEvents"]
    names = collections.Counter(e["name"] for e in events if e.get("cat") == "user_annotation")
    for name in ("trainer.fit", "trainer.masks", "trainer.init", "trainer.collect"):
        assert names[name] >= 1, name
    for name in ("trainer.epoch",) + PHASES:
        assert names[name] == 2, name
    # the training and the evaluation forward of each epoch
    assert names["model.V2E_0"] == names["model.E2V_0"] == names["model.classifier"] == 4
    assert all(s.profiled for s in sp)


def _span(name, id, fit, seconds=0.0, device_ms=None, launches=None, profiled=True):
    return types.SimpleNamespace(name=name, id=id, parent=None, fit=fit,
                                 seconds=seconds, device_ms=device_ms, profiled=profiled,
                                 counts={} if launches is None else {"launches": launches})


def _recorder(spans, dropped=0):
    return types.SimpleNamespace(spans=lambda: list(spans), dropped=lambda: dropped)


# a check job (fit 0, not profiled) and a traced job (fit 10) of 2 epochs
# in 2 groups; the readers divide by the job's 2 epochs
SYNTHETIC = (
    [_span("trainer.masks", 1, 0, 0.5, profiled=False),
     _span("trainer.init", 2, 0, 1.0, profiled=False),
     _span("trainer.epoch", 3, 0, 9.0, launches=100, profiled=False),
     _span("trainer.epoch", 4, 0, 0.4, launches=100, profiled=False),
     _span("trainer.fit", 0, 0, 12.0, profiled=False),
     _span("trainer.masks", 11, 10, 0.002),
     _span("trainer.init", 12, 10, 0.010)]
    + [_span(n, 13 + 6 * i + j, 10, 0.1, device_ms=ms, **kw)
       for i in range(4)
       for j, (n, ms, kw) in enumerate([("trainer.forward", 10.0, {}),
                                        ("trainer.backward", 20.0, {}),
                                        ("trainer.optimizer", 3.0, {}),
                                        ("trainer.eval", 5.0 + i, {}),
                                        ("trainer.epoch", 40.0, {"launches": 7 + i})])]
    + [_span("trainer.init", 40, 10, 0.020), _span("trainer.fit", 10, 10, 1.0)])
WANT = {"forward_ms": 20.0, "backward_ms": 40.0, "optimizer_ms": 6.0, "eval_ms": 13.0,
        "runs_init_ms": 32.0, "first_epoch_s": 9.0, "launches_per_epoch": 17.0}
CTX = types.SimpleNamespace(epochs=2)


@pytest.mark.parametrize("metric", READERS)
def test_reader_without_a_recorder_gives_none(metric, monkeypatch):
    """Neither the module (a process that never imported it) nor a module
    without the recorder (the tree before the spans) raises."""
    read = manifest.reader(metric).read
    monkeypatch.delitem(sys.modules, hspans.MODULE, raising=False)
    assert read(CTX) is None
    monkeypatch.setitem(sys.modules, hspans.MODULE, types.ModuleType(hspans.MODULE))
    assert read(CTX) is None


@pytest.mark.parametrize("metric", READERS)
def test_reader_reads_a_recorder(metric, monkeypatch):
    """The value from a synthetic recorder; None where its spans were
    dropped beyond the cap, and where no fit was profiled."""
    read = manifest.reader(metric).read
    monkeypatch.setitem(sys.modules, hspans.MODULE, _recorder(SYNTHETIC))
    assert read(CTX) == pytest.approx(WANT[metric])
    monkeypatch.setitem(sys.modules, hspans.MODULE, _recorder(SYNTHETIC, dropped=1))
    assert read(CTX) is None
    monkeypatch.setitem(sys.modules, hspans.MODULE, _recorder(SYNTHETIC[:5]))
    assert read(CTX) is None


def test_readers_of_a_cpu_fit_under_the_profiler(tmp_path):
    """A check fit, then a traced CPU fit: the device readers give None (no
    device time); the host readers and the launch count read the spans."""
    _fit(epochs=2, runs=2, chunk=None)
    first = [s for s in prof.spans() if s.name == "trainer.epoch"][0]
    with prof.trace(str(tmp_path), device="cpu"):
        _trainer(epochs=2, runs=2, chunk=None).fit()
    got = {m: manifest.reader(m).read(CTX) for m in READERS}
    assert [got[m] for m in READERS[:4]] == [None] * 4
    traced = [s for s in prof.spans() if s.profiled]
    setup = [s.seconds for s in traced if s.name in ("trainer.masks", "trainer.init")]
    assert len(setup) == 2 and got["runs_init_ms"] == pytest.approx(sum(setup) * 1e3)
    assert got["first_epoch_s"] == first.seconds and got["launches_per_epoch"] == 0.0


@pytest.mark.cuda
def test_phases_add_up_to_the_epoch_on_the_card(tmp_path):
    """On the card under the profiler: each epoch's four phases' device ms
    add up, within 5%, to its ``trainer.epoch`` span's device ms, and each
    epoch counts the port's launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the timing events exist only on the card)")
    trainer = _trainer(epochs=3, runs=4, chunk=None, device="cuda", name="synthetic-large",
                       hidden=256, heads=8)
    prof.reset()
    with prof.trace(str(tmp_path), device="cuda"):
        trainer.fit()
    sp = prof.spans()
    epochs = [s for s in sp if s.name == "trainer.epoch"]
    assert len(epochs) == 3
    for e in epochs:
        phases = [s.device_ms for s in sp if s.parent == e.id]
        assert len(phases) == 4 and min(phases) > 0
        assert sum(phases) == pytest.approx(e.device_ms, rel=0.05)
        assert e.counts["launches"] > 0


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
