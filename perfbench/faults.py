"""Faults planted under the timed path, for the check's own tests.

Each is a context manager that patches the port while a run is set up
and its window runs, so that the run's check must come out false:

* ``frozen`` — the optimizer's update left out: a step returns its
  state unchanged;
* ``frozen_replay`` — the same, but only in the epoch graph's replays
  (every call of a trainer's epoch graph after its first, the eager
  warm-up): the replays leave the parameters, statistics and optimizer
  state as they found them;
* ``half_batch`` — half of the batch left out, the mean taken over the
  rest: a training loss over the first half of the real rows;
* ``altered`` — an answer altered where it is produced: the prediction
  of the first row moved by 10 in every channel, by a forward hook on
  whatever module the ``Trainer`` trains.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import torch

from gnn_bfs_rans_tpu_torch.train import loop
from gnn_bfs_rans_tpu_torch.train.trainer import Trainer

FAULTS = ("frozen", "frozen_replay", "half_batch", "altered")


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _frozen_replays():
    inner = Trainer._epoch
    calls: collections.Counter = collections.Counter()

    def _epoch(self, freeze):
        body = inner(self, freeze)

        def call(*args):
            calls[id(body)] += 1
            if calls[id(body)] == 1:
                return body(*args)
            state = [*self.model.parameters(), *self.model.buffers(),
                     *(t for s in self.optimizer.state.values()
                       for t in s.values() if torch.is_tensor(t))]
            kept = [t.detach().clone() for t in state]
            out = body(*args)
            with torch.no_grad():
                for t, k in zip(state, kept):
                    t.copy_(k)
            return out
        return call
    return _patched(Trainer, "_epoch", _epoch)


def planted(fault: str):
    """The patch of ``fault`` for a training run."""
    if fault == "frozen":
        return _patched(loop, "apply_update", lambda *a, **k: None)
    if fault == "frozen_replay":
        return _frozen_replays()
    if fault == "half_batch":
        inner = loop.batch_loss

        def half(out, targets, graph, cfg):
            keep = torch.arange(graph.n_pad, device=out.device) \
                < graph.n_nodes // 2
            return inner(out, targets,
                         dataclasses.replace(graph, node_mask=keep), cfg)
        return _patched(loop, "batch_loss", half)
    if fault == "altered":
        inner_init = Trainer.__init__

        def moved(module, args, out):
            return torch.cat([out[:1] + 10.0, out[1:]])

        def init(self, *a, **k):
            inner_init(self, *a, **k)
            self.model.register_forward_hook(moved)
        return _patched(Trainer, "__init__", init)
    raise ValueError(f"unknown fault {fault!r}")
