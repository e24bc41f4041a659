"""Per-op device-trace timing — the dispatch-independent timing witness.

Counterpart of ``gnn_bfs_rans_tpu/utils/trace.py``.  The bench harness
(``utils/bench.py``) has two wall-clock methods: chained-marginal (device
work isolated by subtraction) and steady-state (back-to-back dispatch).
This module supplies the third: a ``torch.profiler`` trace of a few real
steps, whose device events' durations sum to the pure device execution
per step, independent of dispatch.  Kernels launched by CUDA-graph
replays appear in the trace as kernels.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import tempfile
from typing import Callable

import torch

# Chrome-trace categories of work on the card.  Left out: the host lanes
# (``cpu_op``, ``cuda_runtime``, ``python_function``) and the annotation
# ranges (``user_annotation``, ``gpu_user_annotation``: record_function
# ranges, Adam's step among them), which span device events already
# counted — the counterpart of the JAX module's "XLA Ops lane only" rule
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def aggregate_device_trace(trace_dir: str, n_steps: int) -> dict:
    """Parse a Chrome trace under ``trace_dir`` → per-op device µs/step.

    Sums the ``ph == "X"`` events whose ``cat`` is a device category
    (:data:`DEVICE_CATEGORIES`).  Returns ``{device_total_s_per_step,
    ops_us_per_step, op_detail, n_steps}``; the ops dict is sorted by
    descending cost.
    """
    trace_files = sorted(
        glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
        + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"),
                    recursive=True))
    if not trace_files:
        raise FileNotFoundError(f"no Chrome trace (*.json[.gz]) under "
                                f"{trace_dir}")
    path = trace_files[0]
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    ev = data.get("traceEvents", [])

    dur: collections.Counter = collections.Counter()
    detail: dict[str, str] = {}
    total = 0.0
    for e in ev:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            name = e.get("name", "?")
            d = e.get("dur", 0.0)
            dur[name] += d
            total += d
            eargs = e.get("args") or {}
            if name not in detail:
                launch = " ".join(f"{k} {eargs[k]}" for k in ("grid", "block")
                                  if k in eargs)
                detail[name] = f"{e['cat']} {launch}".strip()[:300]
    ops = dict(sorted(dur.items(), key=lambda kv: -kv[1]))
    return {
        "device_total_s_per_step": total / n_steps / 1e6,
        "ops_us_per_step": {k: v / n_steps for k, v in ops.items()},
        "op_detail": {k: detail.get(k, "") for k in ops},
        "n_steps": n_steps,
    }


def trace_steps(
    launch: Callable[[int], object],
    n_steps: int = 32,
    sync: Callable[[], None] | None = None,
) -> dict:
    """Run ``launch(i)`` for i in [0, n_steps) under ``torch.profiler``
    (CPU and, with a card, CUDA activities) and aggregate its device events.

    ``launch`` must dispatch one already-warm step (a first call's builds
    and warm-up would pollute the trace).  ``sync`` fences after the last
    dispatch; by default one element of the last launch's output is
    fetched.  The Chrome trace goes to a temporary directory, removed after
    it is read.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = None
    with profile(activities=activities) as prof:
        for i in range(n_steps):
            out = launch(i)
        if sync is not None:
            sync()
        elif out is not None:
            from .bench import _fetch_scalar

            _fetch_scalar(out)
    with tempfile.TemporaryDirectory(prefix="device-trace-") as tdir:
        prof.export_chrome_trace(os.path.join(tdir, "trace.json"))
        return aggregate_device_trace(tdir, n_steps)


def top_ops(result: dict, n: int = 25) -> dict:
    """First ``n`` ops of an :func:`aggregate_device_trace` result."""
    items = list(result["ops_us_per_step"].items())[:n]
    return {
        "device_total_ms_per_step": result["device_total_s_per_step"] * 1e3,
        "top_ops_us_per_step": dict(items),
        "op_detail": {k: result["op_detail"].get(k, "") for k, _ in items},
    }
