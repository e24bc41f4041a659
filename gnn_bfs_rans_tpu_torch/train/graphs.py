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

Arguments may be dataclasses of tensors (a ``Graph`` with its ``Band``, a
multi-case ``CaseBatch``, a ``PartitionedGraph``): the static copy clones
every tensor field, at any depth (and the transposed band planes a
``Band`` keeps), and each replay copies the call's fields into it, so a
graph captured on one mesh replays on another of the same shapes.  What is
no tensor (an int such as ``n_nodes``, a flag, None) is part of the
capture: a call whose non-tensor fields, tensor shapes or dtypes differ
from the captured ones raises.  :func:`signature` is that specialization
as a key, for callers that keep one graph per key (``jax.jit``'s cache):
:class:`GraphCache` keeps one :class:`Graphed` a key for a function
whose other arguments (a generator, a flag) are static.

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
card.  The warm-up and the capture are spans of ``utils/trace.py``
(``graphs.warmup``, ``graphs.capture``) and counts (``graphs.warmups``,
``graphs.captures``); each replay is a count (``graphs.replays``), not a
span.
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
from typing import Callable, Iterable

import torch

from ..kernels import _build
from ..utils import trace

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
            trace.count("graphs.warmups")
            with trace.span("graphs.warmup", fn=_name(self.fn)):
                return self._on_side_stream(lambda: self.fn(*args))
        if self.graph is None:
            trace.count("graphs.captures")
            with trace.span("graphs.capture", fn=_name(self.fn)):
                self._capture(args)
        else:
            self._load(args)
        self.graph.replay()
        _build.LAUNCHES.update(self.launches)
        trace.count("graphs.replays")
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
        if len(args) != len(self.static):
            raise ValueError(f"captured with {len(self.static)} arguments, "
                             f"called with {len(args)}")
        for i, (buf, arg) in enumerate(zip(self.static, args)):
            _load_into(buf, arg, f"argument {i}")

    def _capture(self, args) -> None:
        self.static = tuple(
            torch.full((), a, dtype=torch.float32, device=self.device)
            if isinstance(a, float) else _static_copy(a) for a in args)
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


def _name(fn: Callable) -> str:
    return getattr(fn, "__qualname__", type(fn).__name__)


def _fields(obj) -> list[str]:
    return [f.name for f in dataclasses.fields(obj)]


def _is_struct(obj) -> bool:
    return dataclasses.is_dataclass(obj) and not isinstance(obj, type)


def _static_copy(obj):
    """A capture's own copy of an argument: tensors cloned, a dataclass
    rebuilt from copies of its fields (a ``Band`` with clones of the
    transposed planes it keeps), anything else kept as it is."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if not _is_struct(obj):
        return obj
    copy = dataclasses.replace(obj, **{
        name: _static_copy(getattr(obj, name)) for name in _fields(obj)})
    kept = obj.__dict__.get("_transposed")
    if kept:
        copy.__dict__["_transposed"] = {k: v.clone() for k, v in kept.items()}
    return copy


def _load_into(static, arg, where: str) -> None:
    """Copy ``arg``'s tensors into the static copy ``static``; raise where
    the two differ in anything that is not a tensor's values."""
    if isinstance(static, torch.Tensor):
        if static is arg:
            return
        if not isinstance(arg, torch.Tensor):
            if static.dim() == 0 and isinstance(arg, (int, float)):
                static.fill_(arg)
                return
            raise ValueError(f"{where}: captured a tensor, got {type(arg)}")
        if arg.shape != static.shape or arg.dtype != static.dtype:
            raise ValueError(f"{where}: captured {tuple(static.shape)} "
                             f"{static.dtype}, got {tuple(arg.shape)} "
                             f"{arg.dtype}")
        static.copy_(arg)
        return
    if _is_struct(static):
        if type(arg) is not type(static):
            raise ValueError(f"{where}: captured a {type(static).__name__}, "
                             f"got {type(arg).__name__}")
        for name in _fields(static):
            _load_into(getattr(static, name), getattr(arg, name),
                       f"{where}.{name}")
        for name, buf in static.__dict__.get("_transposed", {}).items():
            _load_into(buf, arg.transposed(name), f"{where}.transposed")
        return
    if static is not arg and static != arg:
        raise ValueError(f"{where}: captured {static!r}, got {arg!r}")


def signature(*args) -> tuple:
    """What a capture of ``args`` is specialized on: each tensor's shape
    and dtype, at any depth of a dataclass, and every other value but a
    float, which a capture takes as a 0-d tensor (as ``jax.jit`` keys its
    cache on shapes and static arguments)."""
    out = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            out.append((tuple(obj.shape), obj.dtype))
        elif isinstance(obj, float):
            out.append(float)
        elif _is_struct(obj):
            out.append(type(obj).__name__)
            for name in _fields(obj):
                walk(getattr(obj, name))
        else:
            out.append(obj)

    for a in args:
        walk(a)
    return tuple(out)


class GraphCache:
    """``fn`` replayed as one CUDA graph a key: the :func:`signature` of
    its ``dynamic`` arguments (named; copied into the capture before each
    replay) and the values of all its other arguments, which the capture
    keeps (a ``torch.Generator`` among them is registered with the graph,
    a flag such as ``freeze_pressure`` selects the graph).  What a call
    returns is copied out of the graph's static output, so it is a fresh
    tensor as an eager call's is.  With ``capture`` False (the CPU, or a
    process group whose collectives cannot be captured) every call runs
    ``fn`` eagerly; ``eager`` is ``fn`` itself."""

    def __init__(self, fn: Callable, device: torch.device,
                 dynamic: tuple[str, ...], *, capture: bool,
                 before_capture: Callable[[], None] | None = None):
        self.eager = fn
        self.device = torch.device(device)
        self.dynamic = dynamic
        self.capture = capture and self.device.type == "cuda"
        self.before_capture = before_capture
        self.pool = (torch.cuda.graph_pool_handle() if self.capture
                     else None)
        self.graphs: dict = {}
        self._sig = inspect.signature(fn)

    def __call__(self, *args, **kwargs):
        if not self.capture:
            return self.eager(*args, **kwargs)
        bound = self._sig.bind(*args, **kwargs)
        bound.apply_defaults()
        dyn = [bound.arguments[name] for name in self.dynamic]
        static = {k: v for k, v in bound.arguments.items()
                  if k not in self.dynamic}
        key = (signature(*dyn), tuple(static.items()))
        graph = self.graphs.get(key)
        if graph is None:
            names = self.dynamic

            def run(*values):
                return self.eager(**dict(zip(names, values)), **static)

            graph = self.graphs[key] = Graphed(
                run, self.device, pool=self.pool,
                generators=[v for v in static.values()
                            if isinstance(v, torch.Generator)],
                before_capture=self.before_capture)
        return _copy_out(graph(*dyn))


def _copy_out(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(_copy_out(o) for o in out)
    return out
