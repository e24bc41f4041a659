"""The program's own spans and counters, read after the window.

The port records its spans and counters in one process-wide store
(``gnn_bfs_rans_tpu_torch/utils/trace.py``).  :func:`window` gives the
window's ``trainer.run`` span, the last one (the window's one
``Trainer._run_blocks`` call), with its descendants; :func:`last` the
last span of a name.  Both give None where the program keeps no such
store (an older program), recorded no such span, or dropped any of the
spans asked for: a reader then reports nothing.
"""

from __future__ import annotations

import collections
import importlib


def _store():
    try:
        trace = importlib.import_module("gnn_bfs_rans_tpu_torch.utils.trace")
    except ImportError:
        return None
    if not all(hasattr(trace, f) for f in ("records", "dropped_since")):
        return None
    return trace


class Run:
    """A ``trainer.run`` span (``run``) and its descendants by name."""

    def __init__(self, run, descendants: list):
        self.run = run
        self.spans = descendants

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def child(self, parent, name: str):
        """``parent``'s first child of that name, or None."""
        return next((s for s in self.spans
                     if s.parent == parent.id and s.name == name), None)


def window() -> Run | None:
    trace = _store()
    if trace is None:
        return None
    spans = trace.records()
    runs = [s for s in spans if s.name == "trainer.run"]
    if not runs:
        return None
    run = max(runs, key=lambda s: s.id)
    if trace.dropped_since(run):
        return None
    children = collections.defaultdict(list)
    for s in spans:
        children[s.parent].append(s)
    found, todo = [], [run.id]
    while todo:
        kids = children.get(todo.pop(), [])
        found += kids
        todo += [s.id for s in kids]
    return Run(run, sorted(found, key=lambda s: s.id))


def last(name: str):
    trace = _store()
    if trace is None:
        return None
    return max((s for s in trace.records() if s.name == name),
               key=lambda s: s.id, default=None)
