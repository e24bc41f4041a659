"""The program's spans and counters, and per-op device-trace timing.

Spans and counters
------------------
One process-wide store records where the program's own work goes.  It is
on by default; :func:`enable` turns it off (or on again), and nothing
else configures it.  Nothing is written to disk.

* :func:`span` (``name, device=False, counters=False, **attrs``) is a
  context manager that records a :class:`Span`: its name, start and end
  on ``time.time_ns()`` (the clock of a ``torch.profiler`` Chrome trace,
  whose event ``ts`` in µs plus the file's ``baseTimeNanoseconds`` is the
  same instant), the span open around it in the same thread (its
  ``parent``) and ``attrs``.  Under a profiler it also opens a
  ``torch.profiler.record_function(name)`` range, so that the spans sit
  on the device trace's own timeline (without one it skips the range,
  which would record nothing and costs most of a span's time).
  ``device=True`` also records a pair of CUDA events on the current
  stream (without a card: none, and ``device_ms`` stays None).  Their
  elapsed time is read lazily, at the first :func:`records` or
  :func:`device_ms` after the events completed, that is after a
  synchronization the caller makes anyway: the store never synchronizes.
  ``counters=True`` attaches the change in :func:`counters` over the
  span (its nonzero entries).
* :func:`count` (``name, n=1``) adds to one counter.  :func:`counters` is
  a snapshot of them and of ``kernels._build.LAUNCHES``, read in place as
  ``launches.<kernel>``.
* Spans go to a deque of ``MAX_SPANS``, whose oldest are dropped and
  counted (:func:`dropped_since` says whether a span or any span opened
  after it was).  Per-name totals (count, ns) and the counters feed the
  operator's :func:`summary`.
* Off, :func:`span` returns one shared no-op context (None on entry) and
  :func:`count` returns at once.

The names are the program's layers:

=======================  =================================================
``trainer.init``         ``Trainer.__init__``; children ``trainer.model_init``
                         (``FlowGNN`` on the host), ``trainer.to_device``
                         (model, graph, targets, generator; the first CUDA
                         use), ``trainer.optimizer``
``trainer.run``          one ``Trainer._run_blocks`` call (counters)
``trainer.block``        a block (``first``, ``last`` epoch; counters);
                         children ``trainer.enqueue`` (``device``: its
                         replays), ``trainer.sync`` (the host waiting for
                         the card), ``trainer.record`` (history rows), the
                         block's checkpoints
``trainer.save_state``   ``best`` from the carry: copy in, save, copy back
``trainer.save``         a checkpoint queued (``name``); child
                         ``checkpoint.exact_stats``
``checkpoint.wait``      the trainer waiting for its checkpoint writer: for
                         a free buffer set, or for the queued writes at the
                         end of a ``trainer.run`` (its last child)
``checkpoint.write``     on the writer's thread: a checkpoint's files
                         (``name``, ``bytes``); children
                         ``checkpoint.model``, ``checkpoint.optimizer``,
                         ``checkpoint.meta`` (their own spans where
                         ``save_checkpoint`` writes on the calling thread)
``graphs.warmup``,       a ``Graphed`` function's eager first call and its
``graphs.capture``       capture (``fn``)
``mgn.forward``          a ``MeshGraphNet`` forward run eagerly (a warm-up,
                         a capture, a served case; ``train``; counters);
                         children ``mgn.encode``, ``mgn.process`` (the
                         message-passing steps), ``mgn.decode``
=======================  =================================================

Counters: ``graphs.warmups``, ``graphs.captures``, ``graphs.replays`` (one
a replay: no span), ``checkpoint.bytes`` (the files written, by size on
disk), ``checkpoint.async_saves`` (checkpoints handed to the writer),
``mgn.edge_rows`` (edges × message-passing steps a ``MeshGraphNet``
forward), ``mgn.saved_bytes`` (the bytes its processor keeps for the
backward, each storage once, counted as autograd saves them), and
``launches.mgn_edge_fwd``, ``.mgn_edge_fixup``, ``.mgn_edge_bwd``,
``.mgn_edge_senders`` (the edge block's kernel launches).

Per-op device trace
-------------------
Counterpart of ``gnn_bfs_rans_tpu/utils/trace.py``.  The bench harness
(``utils/bench.py``) has two wall-clock methods: chained-marginal (device
work isolated by subtraction) and steady-state (back-to-back dispatch).
:func:`trace_steps` supplies the third: a ``torch.profiler`` trace of a
few real steps, whose device events' durations sum to the pure device
execution per step, independent of dispatch.  Kernels launched by
CUDA-graph replays appear in the trace as kernels.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import gzip
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Callable

import torch

from ..kernels import _build

MAX_SPANS = 1 << 16


@dataclasses.dataclass(eq=False)
class Span:
    """One span; ``parent`` is the ``id`` of the span open around it in its
    thread (None at the top).  Ids grow in the order spans open, so a
    span's descendants have larger ids."""

    id: int
    name: str
    attrs: dict
    parent: int | None = None
    start_ns: int = 0
    end_ns: int = 0
    counters: dict | None = None
    device_ms: float | None = None

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


class _Store:
    def __init__(self):
        self.on = True
        self.lock = threading.Lock()
        self.local = threading.local()
        self.ids = itertools.count()
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.spans: collections.deque = collections.deque(
                maxlen=MAX_SPANS)
            self.dropped = 0
            self.max_dropped_id = -1
            self.totals: dict[str, list] = {}
            self.counts: collections.Counter = collections.Counter()
            self.pending: list = []     # (span, start event, end event)

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def add(self, span: Span, events) -> None:
        with self.lock:
            if len(self.spans) == self.spans.maxlen:
                self.dropped += 1
                self.max_dropped_id = max(self.max_dropped_id,
                                          self.spans[0].id)
            self.spans.append(span)
            total = self.totals.setdefault(span.name, [0, 0])
            total[0] += 1
            total[1] += span.end_ns - span.start_ns
            if events is not None:
                self.pending.append((span, *events))

    def resolve(self) -> None:
        """Read the device time of every span whose end event completed."""
        with self.lock:
            waiting = []
            for span, start, end in self.pending:
                if end.query():
                    span.device_ms = start.elapsed_time(end)
                else:
                    waiting.append((span, start, end))
            self.pending = waiting


_STORE = _Store()
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("span", "device", "with_counters", "range", "events",
                 "before")

    def __init__(self, span: Span, device: bool, with_counters: bool):
        self.span = span
        self.device = device
        self.with_counters = with_counters
        self.range = self.events = self.before = None

    def __enter__(self) -> Span:
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.span.name)
            self.range.__enter__()
        if self.with_counters:
            self.before = counters()
        if self.device and torch.cuda.is_available():
            _STORE.resolve()
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack = _STORE.stack()
        span = self.span
        span.parent = stack[-1] if stack else None
        stack.append(span.id)
        span.start_ns = time.time_ns()
        return span

    def __exit__(self, *exc) -> bool:
        span = self.span
        span.end_ns = time.time_ns()
        _STORE.stack().pop()
        if self.events is not None:
            self.events[1].record()
        if self.before is not None:
            after, before = counters(), self.before
            span.counters = {k: after.get(k, 0) - before.get(k, 0)
                             for k in after.keys() | before.keys()
                             if after.get(k, 0) != before.get(k, 0)}
        _STORE.add(span, self.events)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str, /, *, device: bool = False, counters: bool = False,
         **attrs):
    """A context manager that records the span ``name`` (see the module
    docstring); on entry it gives the :class:`Span`, or None when off."""
    if not _STORE.on:
        return _OFF
    return _Open(Span(next(_STORE.ids), name, attrs), device, counters)


def count(name: str, n: int = 1) -> None:
    if not _STORE.on:
        return
    with _STORE.lock:
        _STORE.counts[name] += n


def counters() -> dict[str, int]:
    """The counters now, with ``kernels._build.LAUNCHES`` as
    ``launches.<kernel>``."""
    with _STORE.lock:
        snap = dict(_STORE.counts)
    snap.update((f"launches.{k}", v) for k, v in _build.LAUNCHES.items())
    return snap


def enable(on: bool = True) -> None:
    _STORE.on = on


def counting() -> bool:
    """Whether the store records (:func:`enable`)."""
    return _STORE.on


def reset() -> None:
    """Forget every span, total and counter (not ``LAUNCHES``)."""
    _STORE.reset()


def records() -> list[Span]:
    """The spans kept, oldest first by end, device times read where their
    events completed."""
    _STORE.resolve()
    with _STORE.lock:
        return list(_STORE.spans)


def device_ms(span: Span | None) -> float | None:
    """``span``'s device milliseconds, once its events completed (None
    before, without a card, or for no span)."""
    if span is None:
        return None
    _STORE.resolve()
    return span.device_ms


def dropped() -> int:
    return _STORE.dropped


def dropped_since(span: Span) -> bool:
    """Whether ``span`` or a span opened after it was dropped."""
    return _STORE.max_dropped_id >= span.id


def mark() -> tuple[dict, dict]:
    """The totals and counters now, for :func:`summary`."""
    with _STORE.lock:
        totals = {k: tuple(v) for k, v in _STORE.totals.items()}
    return totals, counters()


def summary(since: tuple[dict, dict] | None = None) -> str:
    """Each span's count and mean ms and each counter (since a
    :func:`mark`), on one line; empty when off or nothing was recorded."""
    if not _STORE.on:
        return ""
    t0, c0 = since or ({}, {})
    t1, c1 = mark()
    spans = []
    for name, (n, ns) in sorted(t1.items()):
        n0, ns0 = t0.get(name, (0, 0))
        if n > n0:
            spans.append(f"{name} {n - n0} x {(ns - ns0) / (n - n0) / 1e6:.2f}"
                         " ms")
    counts = [f"{k} {v - c0.get(k, 0)}" for k, v in sorted(c1.items())
              if v != c0.get(k, 0)]
    parts = [("spans: " + ", ".join(spans)) if spans else "",
             ("counters: " + ", ".join(counts)) if counts else ""]
    return "; ".join(p for p in parts if p)


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
