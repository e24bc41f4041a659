"""CUDA graphs of the train step, the eval step, the epoch body and the
serving forward: the port's counterpart of ``jax.jit``.

A :class:`Graphed` wraps one function.  On the CPU it calls the function
each time.  On the card:

* the first call runs the function eagerly on a side stream and returns
  its result: the warm-up every capture needs (the epilogue kernels'
  barrier bank, row 6's work plan on the device, Adam's state, the
  kernels' first launches all happen here, outside any capture);
* the second call captures the function into a ``torch.cuda.CUDAGraph``
  on that side stream, with static copies of its arguments, then
  replays it;
* every later call copies its arguments into the static ones and
  replays.

What the function returns on a replay is the graph's static output,
overwritten by the next replay: a caller keeps it by copying it.  Python
floats among the arguments become 0-d f32 tensors on the device when the
graph is captured, so the captured function must accept either.  A
capture that fails raises; nothing runs eagerly in its place.

The generators given are registered with the graph, so every replay draws
fresh numbers from them, continuing their streams as eager calls would.
Graphs that share a memory pool (``pool``) must read each other's outputs
before the next replay of another graph of the pool, and keep no state
across replays in memory the capture allocated: the train step, eval step
and epoch body of a trainer keep parameters, optimizer state, statistics
and counters in tensors made before any capture.

Launch counts: a capture launches nothing, so the kernel wrappers'
additions to ``kernels._build.LAUNCHES`` during it are taken back and
added again at each replay, and the counters keep meaning launches on the
card.
"""

from __future__ import annotations

import collections
from typing import Callable, Iterable

import torch

from ..kernels import _build

_SIDE: dict = {}


def side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream a device's warm-ups and captures run on (the
    epilogue kernels keep one barrier word a stream)."""
    stream = _SIDE.get(device)
    if stream is None:
        stream = _SIDE[device] = torch.cuda.Stream(device)
    return stream


class Graphed:
    """``fn`` called eagerly on the CPU, replayed as a CUDA graph on the
    card (see the module docstring)."""

    def __init__(self, fn: Callable, device: torch.device, *,
                 pool=None, generators: Iterable[torch.Generator] = (),
                 before_capture: Callable[[], None] | None = None):
        self.fn = fn
        self.device = torch.device(device)
        self.pool = pool
        self.generators = tuple(generators)
        self.before_capture = before_capture
        self.warmed = False
        self.graph = None
        self.static = ()
        self.outputs = None
        self.launches: collections.Counter = collections.Counter()

    def __call__(self, *args):
        if self.device.type != "cuda":
            return self.fn(*args)
        if not self.warmed:
            self.warmed = True
            return self._on_side_stream(lambda: self.fn(*args))
        if self.graph is None:
            self._capture(args)
        else:
            self._load(args)
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        return self.outputs

    def _on_side_stream(self, run: Callable):
        side = side_stream(self.device)
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = run()
        main.wait_stream(side)
        return out

    def _load(self, args) -> None:
        for buf, arg in zip(self.static, args):
            if isinstance(buf, torch.Tensor) and buf is not arg:
                if isinstance(arg, torch.Tensor):
                    buf.copy_(arg)
                else:
                    buf.fill_(arg)

    def _capture(self, args) -> None:
        self.static = tuple(
            a.clone() if isinstance(a, torch.Tensor)
            else torch.full((), a, dtype=torch.float32, device=self.device)
            if isinstance(a, float) else a
            for a in args)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        if self.before_capture is not None:
            self.before_capture()
        counts = collections.Counter(_build.LAUNCHES)
        with torch.cuda.graph(graph, pool=self.pool,
                              stream=side_stream(self.device),
                              capture_error_mode="thread_local"):
            self.outputs = self.fn(*self.static)
        self.launches = _build.LAUNCHES - counts
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(counts)
        self.graph = graph
