"""Spans and the device trace of a ``--trace 1`` run.

:class:`Tracer` puts the benchmark's spans (``perfbench.<name>``) around
its calls into the program as ``torch.profiler.record_function`` ranges,
and, when on, runs ``torch.profiler`` (CPU and CUDA activities) over the
traced window.  :func:`read_trace` reduces the exported Chrome trace:

* device events are the ``ph == "X"`` events of the categories
  ``kernel``, ``gpu_memcpy`` and ``gpu_memset`` (a frozen copy of
  ``gnn_bfs_rans_tpu_torch/utils/trace.py::DEVICE_CATEGORIES``: the host
  lanes and the annotation ranges, which span device events already
  counted, are left out);
* ``busy_s``: the union of the device events' intervals inside the
  window span (``perfbench.window``), ``window_s`` its length;
* ``ops``: device seconds by kernel name;
* ``idle``: each gap of the device inside the window, by the innermost
  benchmark span the host was in at the gap's middle.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
from pathlib import Path

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "perfbench.window"


class Tracer:
    def __init__(self, enabled: bool, out_dir: Path):
        self.enabled = enabled
        self.out_dir = out_dir
        self.prof = None
        self.result = None

    def span(self, name: str):
        return torch.profiler.record_function(f"perfbench.{name}")

    @contextlib.contextmanager
    def window(self, device):
        """The traced window: the profiler runs around it when enabled; it
        ends when the device is done."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
                if torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / "trace.json"
        prof.export_chrome_trace(str(path))
        try:
            self.result = read_trace(path)
        finally:
            os.unlink(path)


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.]+", "_", name)[:64]


def read_trace(path: Path) -> dict:
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = json.load(fh).get("traceEvents", [])
    device, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat"), e.get("name", "?")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if cat in DEVICE_CATEGORIES:
            device.append((ts, ts + dur, name))
        elif cat == "user_annotation" and name.startswith("perfbench."):
            if name == WINDOW:
                window = (ts, ts + dur)
            else:
                spans.append((ts, ts + dur, name))
    if window is None:
        raise RuntimeError("the trace holds no window span")
    w0, w1 = window
    ops: dict[str, float] = {}
    intervals = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ops[_short(name)] = ops.get(_short(name), 0.0) + (b - a) * 1e-6
        intervals.append((a, b))
    intervals.sort()
    busy, merged = 0.0, []
    for a, b in intervals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    gaps, edge = [], w0
    for a, b in merged:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    if w1 > edge:
        gaps.append((edge, w1))
    idle: dict[str, float] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        inside = [s for s in spans if s[0] <= mid <= s[1]]
        # the innermost span: the latest to start
        name = max(inside)[2] if inside else WINDOW
        idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    return {"busy_s": busy, "window_s": (w1 - w0) * 1e-6, "ops": ops,
            "idle": idle, "n_device_events": len(intervals)}


def breakdown(trace: dict) -> dict:
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(trace["ops"]), "idle_gaps": top(trace["idle"])}
