"""The port's device-trace aggregation (``gnn_bfs_rans_tpu_torch/utils/
trace.py``) on a hand-made Chrome trace, mirroring the JAX module's tests
(``tests/test_trace.py``): only the card's events (kernels, copies,
memsets) are summed — not the host lanes, not the annotation ranges that
span kernels already counted.  Then a live ``torch.profiler`` capture on
the CPU, and the profiling aids of ``utils/profiling.py``.
"""

import gzip
import json
import logging

import pytest
import torch

from gnn_bfs_rans_tpu_torch.kernels import _build
from gnn_bfs_rans_tpu_torch.utils import profiling
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


def test_profiling_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(tmp_path / "tb"):
        torch.ones(8, 8).sum()
    assert list((tmp_path / "tb").glob("*.pt.trace.json"))


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
