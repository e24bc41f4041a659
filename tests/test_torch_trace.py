"""The port's tracing (``gnn_bfs_rans_tpu_torch/utils/trace.py``).

* The device-trace aggregation on a hand-made Chrome trace, mirroring the
  JAX module's tests (``tests/test_trace.py``): only the card's events
  (kernels, copies, memsets) are summed — not the host lanes, not the
  annotation ranges that span kernels already counted; then a live
  ``torch.profiler`` capture on the CPU, and the profiling aids of
  ``utils/profiling.py``.
* The program's spans and counters: nesting and parent links, counter
  deltas (``kernels._build.LAUNCHES`` among them), the bounded store and
  its drop count, the store turned off, threads, stamps on the profiler's
  clock, and a two-block ``Trainer`` run on the CPU (the 336-cell case of
  ``tests/test_torch_epoch_block.py``, 2 layers).
"""

import gzip
import json
import logging
import os
import sys
import threading
import time

import pytest
import torch

from gnn_bfs_rans_tpu_torch.foam import drifting_box_fields, generate_box_case
from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
from gnn_bfs_rans_tpu_torch.train import checkpoint as checkpoint_mod
from gnn_bfs_rans_tpu_torch.train import trainer as trainer_mod
from gnn_bfs_rans_tpu_torch.train.data import load_dataset
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig
from gnn_bfs_rans_tpu_torch.utils import profiling, trace
from gnn_bfs_rans_tpu_torch.utils.trace import (
    aggregate_device_trace,
    top_ops,
    trace_steps,
)

EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 1,
     "args": {"name": "python host"}},
    # device work over 2 steps: gat kernel (30+28), copy (6+4), memset 2
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
     "name": "gat_fwd_kernel", "dur": 30.0,
     "args": {"grid": [94, 1, 1], "block": [256, 1, 1]}},
    {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7,
     "name": "gat_fwd_kernel", "dur": 28.0},
    {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
     "name": "Memcpy DtoD (Device -> Device)", "dur": 6.0},
    {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 7,
     "name": "Memcpy DtoD (Device -> Device)", "dur": 4.0},
    {"ph": "X", "cat": "gpu_memset", "pid": 0, "tid": 7,
     "name": "Memset (Device)", "dur": 2.0},
    # annotation ranges span the kernels above — must NOT be counted
    {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
     "name": "Optimizer.step#Adam.step", "dur": 500.0},
    {"ph": "X", "cat": "user_annotation", "pid": 1, "tid": 1,
     "name": "Optimizer.step#Adam.step", "dur": 700.0},
    # host lanes — not device time
    {"ph": "X", "cat": "cuda_runtime", "pid": 1, "tid": 1,
     "name": "cudaGraphLaunch", "dur": 9.0},
    {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1,
     "name": "aten::mm", "dur": 400.0},
    # a flow event and an instant event of a device category
    {"ph": "f", "cat": "kernel", "pid": 0, "tid": 7, "name": "flow"},
    {"ph": "i", "cat": "kernel", "pid": 0, "tid": 7, "name": "marker"},
]


@pytest.fixture(params=["json", "gz"])
def trace_dir(tmp_path, request):
    d = tmp_path / "plugins" / "profile"
    d.mkdir(parents=True)
    if request.param == "gz":
        with gzip.open(d / "host.pt.trace.json.gz", "wt") as f:
            json.dump({"traceEvents": EVENTS}, f)
    else:
        (d / "host.pt.trace.json").write_text(
            json.dumps({"traceEvents": EVENTS}))
    return str(tmp_path)


def test_aggregates_device_events_only(trace_dir):
    res = aggregate_device_trace(trace_dir, n_steps=2)
    # (30+28+6+4+2) us / 2 steps = 35 us/step
    assert res["device_total_s_per_step"] == pytest.approx(35e-6)
    assert res["ops_us_per_step"] == {
        "gat_fwd_kernel": 29.0, "Memcpy DtoD (Device -> Device)": 5.0,
        "Memset (Device)": 1.0}
    for name in ("Optimizer.step#Adam.step", "cudaGraphLaunch", "aten::mm",
                 "flow", "marker"):
        assert name not in res["ops_us_per_step"]
    assert res["op_detail"]["gat_fwd_kernel"] == (
        "kernel grid [94, 1, 1] block [256, 1, 1]")
    assert res["op_detail"]["Memset (Device)"] == "gpu_memset"
    assert res["n_steps"] == 2


def test_top_ops_truncates(trace_dir):
    res = aggregate_device_trace(trace_dir, n_steps=2)
    t = top_ops(res, n=1)
    assert list(t["top_ops_us_per_step"]) == ["gat_fwd_kernel"]
    assert list(t["op_detail"]) == ["gat_fwd_kernel"]
    assert t["device_total_ms_per_step"] == pytest.approx(0.035)


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        aggregate_device_trace(str(tmp_path), n_steps=1)


def test_trace_steps_live_on_the_cpu():
    """A real capture: every step launched, no device time without a
    card."""
    x = torch.ones(64, 64)
    calls = []

    def launch(i):
        calls.append(i)
        return x @ x

    res = trace_steps(launch, n_steps=4)
    assert calls == [0, 1, 2, 3]
    assert res["n_steps"] == 4
    if not torch.cuda.is_available():
        assert res["device_total_s_per_step"] == 0.0


def test_profiling_aids():
    profiling.enable_nan_checks(True)
    try:
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
    finally:
        profiling.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
    stats = profiling.device_memory_stats()
    if not torch.cuda.is_available():
        assert stats == {"cpu": None}
    profiling.log_compile_times(True)
    try:
        assert _build.LOG.isEnabledFor(logging.INFO)
    finally:
        profiling.log_compile_times(False)
    assert not _build.LOG.isEnabledFor(logging.INFO)


# ------------------------------------------------------ spans and counters
@pytest.fixture
def store(monkeypatch):
    """An empty store, on; left empty and on."""
    monkeypatch.setattr(trace, "MAX_SPANS", trace.MAX_SPANS)
    trace.reset()
    trace.enable(True)
    yield trace
    trace.enable(True)
    monkeypatch.undo()
    trace.reset()


def _by_name(spans):
    return {s.name: s for s in spans}


def test_spans_nest_and_link_their_parents(store):
    with trace.span("a", tag=1) as a:
        with trace.span("b") as b:
            with trace.span("c"):
                pass
        with trace.span("d", name="x"):
            pass
    with trace.span("e"):
        pass
    got = _by_name(trace.records())
    assert [s.name for s in trace.records()] == ["c", "b", "d", "a", "e"]
    assert got["a"] is a and got["b"] is b
    assert a.parent is None and got["e"].parent is None
    assert b.parent == a.id and got["d"].parent == a.id
    assert got["c"].parent == b.id
    assert a.attrs == {"tag": 1} and got["d"].attrs == {"name": "x"}
    # ids grow in the order spans open; the stamps nest
    assert a.id < b.id < got["c"].id < got["d"].id < got["e"].id
    assert a.start_ns <= b.start_ns <= got["c"].start_ns
    assert got["c"].end_ns <= b.end_ns <= got["d"].start_ns <= a.end_ns
    assert all(s.device_ms is None for s in trace.records())
    summary = trace.summary()
    assert summary.startswith("spans: a 1 x ") and "e 1 x " in summary


def test_counter_deltas_attach_to_a_span(store, monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", _build.LAUNCHES.copy())
    trace.count("outside", 5)
    _build.LAUNCHES["k"] += 1
    since = trace.mark()
    with trace.span("s", counters=True) as s:
        trace.count("c")
        trace.count("c", 2)
        _build.LAUNCHES["k"] += 4
        with trace.span("inner"):
            trace.count("d", 7)
    assert s.counters == {"c": 3, "d": 7, "launches.k": 4}
    assert _by_name(trace.records())["inner"].counters is None
    snap = trace.counters()
    assert snap["outside"] == 5 and snap["c"] == 3
    assert snap["launches.k"] == _build.LAUNCHES["k"]
    line = trace.summary(since)
    assert "counters: c 3, d 7, launches.k 4" in line
    assert "outside" not in line


def test_the_store_is_bounded_and_counts_what_it_drops(store, monkeypatch):
    monkeypatch.setattr(trace, "MAX_SPANS", 4)
    trace.reset()
    with trace.span("first") as first:
        pass
    with trace.span("outer") as outer:
        for i in range(5):
            with trace.span("inner", i=i):
                pass
    kept = trace.records()
    assert len(kept) == 4 and trace.dropped() == 3
    assert [s.name for s in kept] == ["inner"] * 3 + ["outer"]
    assert [s.attrs["i"] for s in kept[:3]] == [2, 3, 4]
    # the first span and two of the outer one's children went
    assert trace.dropped_since(first) and trace.dropped_since(outer)
    with trace.span("later") as later:
        pass
    assert not trace.dropped_since(later)
    # the totals count every span, kept or dropped
    assert "inner 5 x " in trace.summary()


def test_off_records_nothing(store):
    trace.enable(False)
    with trace.span("a", device=True, counters=True) as a:
        trace.count("c")
    assert a is None
    assert trace.span("b") is trace.span("c")   # one shared no-op
    assert trace.records() == [] and trace.summary() == ""
    assert "c" not in trace.counters()
    trace.enable(True)
    with trace.span("d"):
        pass
    assert [s.name for s in trace.records()] == ["d"]


def test_threads_keep_their_own_parents_and_lose_no_count(store):
    """More threads than cores, a short switch interval: every count lands
    and each thread's spans nest under its own."""
    n_threads, n = 4 * (os.cpu_count() or 1), 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            with trace.span("outer", t=t):
                for _ in range(n):
                    trace.count("hits")
                    with trace.span("inner", t=t):
                        pass

        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    assert trace.counters()["hits"] == n_threads * n
    spans = trace.records()
    outer = {s.attrs["t"]: s.id for s in spans if s.name == "outer"}
    inner = [s for s in spans if s.name == "inner"]
    assert len(outer) == n_threads and len(inner) == n_threads * n
    assert all(s.parent == outer[s.attrs["t"]] for s in inner)


def test_span_stamps_are_on_the_profilers_clock(store, tmp_path):
    """A span's start and end lie within 1 ms of its ``user_annotation``
    event in the profiler's Chrome trace (``ts`` µs +
    ``baseTimeNanoseconds``).  The first range of a profiler session
    spends about 1 ms inside the profiler's own call after its stamp, so
    one span goes first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("trainer.first"):
            pass
        with trace.span("trainer.probe") as s:
            time.sleep(0.02)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    data = json.loads(path.read_text())
    base = data["baseTimeNanoseconds"]
    (event,) = [e for e in data["traceEvents"]
                if e.get("name") == "trainer.probe"
                and e.get("cat") == "user_annotation"]
    start = base + event["ts"] * 1e3
    end = start + event["dur"] * 1e3
    assert abs(s.start_ns - start) < 1e6, (s.start_ns - start)
    assert abs(s.end_ns - end) < 1e6, (s.end_ns - end)
    assert s.ms >= 20


@pytest.fixture(scope="module")
def small_case(tmp_path_factory):
    path = tmp_path_factory.mktemp("torch_trace") / "case"
    times = ["100", "200", "282"]
    generate_box_case(path, 24, 14, 1, time_dirs=times,
                      time_field_fn=drifting_box_fields)
    return load_dataset(path, times, with_band=False)


def test_a_two_block_trainer_run_is_traced(store, small_case, tmp_path,
                                           monkeypatch):
    """Two blocks of 2 epochs (GCN dense, 2 layers, BatchNorm
    recalibration on): one ``trainer.init`` with its three parts, one
    ``trainer.run`` with its two blocks and their epochs, then its
    ``checkpoint.wait``; one ``trainer.enqueue``, ``trainer.sync`` and
    ``trainer.record`` a block, one ``trainer.save`` per checkpoint queued
    (its ``checkpoint.exact_stats`` and one ``checkpoint.async_saves``),
    and on the writer's thread one ``checkpoint.write`` a save, in order,
    with its parts, all ended inside the run; ``checkpoint.bytes`` equal
    to the files' sizes on disk."""
    written = []
    write = checkpoint_mod.write_checkpoint

    def recording_write(directory, name, *args, **kwargs):
        written.append((name, threading.current_thread()))
        return write(directory, name, *args, **kwargs)

    monkeypatch.setattr(checkpoint_mod, "write_checkpoint", recording_write)
    lines = []
    out = tmp_path / "run"
    tr = trainer_mod.Trainer(
        small_case, ModelConfig(hidden_dim=16, num_layers=2,
                                layer_type="GCN", backend="dense"),
        TrainConfig(lr=1e-3, epochs=4, epoch_block=2, save_every=2,
                    bn_recal="on"),
        output_dir=out, log_fn=lines.append, device="cpu")
    tr.train()
    spans = trace.records()
    ids = {s.id: s for s in spans}

    def kids(parent, name=None):
        return [s for s in spans if s.parent == parent.id
                and (name is None or s.name == name)]

    (init,) = [s for s in spans if s.name == "trainer.init"]
    assert [s.name for s in kids(init)] == [
        "trainer.model_init", "trainer.to_device", "trainer.optimizer"]
    (run,) = [s for s in spans if s.name == "trainer.run"]
    blocks = kids(run, "trainer.block")
    assert [(b.attrs["first"], b.attrs["last"]) for b in blocks] == [
        (1, 2), (3, 4)]
    assert [s.name for s in kids(run)] == [
        "trainer.block", "trainer.block", "checkpoint.wait"]
    for b in blocks:
        for name in ("trainer.enqueue", "trainer.sync", "trainer.record"):
            (s,) = kids(b, name)
            assert b.start_ns <= s.start_ns <= s.end_ns <= b.end_ns
            assert s.device_ms is None                  # the CPU
        (sync,), (rec,) = kids(b, "trainer.sync"), kids(b, "trainer.record")
        assert sync.end_ns <= rec.start_ns
    saves = [s for s in spans if s.name == "trainer.save"]
    writes = [s for s in spans if s.name == "checkpoint.write"]
    assert [s.attrs["name"] for s in saves] == \
        [s.attrs["name"] for s in writes] == [n for n, _ in written]
    assert {"epoch_2", "epoch_4"} <= {n for n, _ in written}
    assert all(t is not threading.main_thread() for _, t in written)
    for s in saves:
        # under its block, or under a trainer.save_state under it
        parent = ids[s.parent]
        if parent.name == "trainer.save_state":
            assert s.attrs["name"] == parent.attrs["name"] == "best"
            parent = ids[parent.parent]
        assert parent in blocks
        assert [k.name for k in kids(s)] == ["checkpoint.exact_stats"]
        assert s.counters["checkpoint.async_saves"] == 1
    for w in writes:
        # on the writer's thread, ended before the run
        assert w.parent is None and w.end_ns <= run.end_ns
        assert [k.name for k in kids(w)] == [
            "checkpoint.model", "checkpoint.optimizer", "checkpoint.meta"]
    last = {s.attrs["name"]: s for s in writes}
    for name, s in last.items():
        on_disk = sum(os.path.getsize(out / f"{name}{ext}")
                      for ext in (".pt", ".train.pt", ".meta.json"))
        assert s.attrs["bytes"] == on_disk, name
    assert run.counters["checkpoint.bytes"] == sum(
        s.attrs["bytes"] for s in writes)
    assert run.counters["checkpoint.async_saves"] == len(saves)
    # the log: a line a block at its end (no device time off the card),
    # then the trace's summary
    assert [ln.split(":")[0] for ln in lines
            if ln.startswith("Epochs ")] == ["Epochs 1-2", "Epochs 3-4"]
    assert all("device" not in ln for ln in lines if ln.startswith("Epochs"))
    assert lines[-1].startswith("Trace: spans: checkpoint.exact_stats ")
    assert f"checkpoint.bytes {run.counters['checkpoint.bytes']}" in lines[-1]
