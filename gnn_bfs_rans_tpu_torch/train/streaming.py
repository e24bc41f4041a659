"""Streamed many-case loading: chunks copied to the device ahead of use.

Counterpart of ``gnn_bfs_rans_tpu/train/streaming.py``.  ``FlowDataset``
holds every snapshot of one case; multi-case training
(``parallel/multicase.py``) iterates cases that need not fit in host
memory at once, whose parsing is host work that should overlap the
card's.

* :class:`Prefetcher` iterates a source on a daemon thread and keeps
  ``depth`` items ready on the device.  Its default ``put``
  (:func:`stage`) pins each array in host memory on that thread and copies
  it with ``non_blocking=True`` on a side CUDA stream, then records an
  event; the consumer's stream waits on the event before it uses the
  item, and each tensor is marked as used by the consumer's stream
  (``record_stream``), so its memory is not reused before the consumer's
  work on it is done.  A copy from pageable memory would run synchronously
  and overlap nothing: hence the pinning.  On the CPU the items become
  tensors and nothing is copied.
* Case sources yielding :class:`~..parallel.multicase.CaseBatch` chunks:
  :func:`perturbed_case_source` (a synthetic perturbed-geometry family
  around a base mesh, each case from its own
  ``numpy.random.default_rng(seed + case_id)``) and
  :func:`foam_case_source` (OpenFOAM case directories sharing one mesh
  topology, parsed lazily a chunk at a time).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..foam.reader import DEFAULT_FIELDS, FoamCase
from ..graph.build import build_graph, compute_edge_features
from ..graph.structs import Graph
from .normalization import FieldNormalizer, pack_targets


@dataclasses.dataclass
class Staged:
    """An item on the device, and the event its copies end with (None on
    the CPU)."""

    item: object
    event: torch.cuda.Event | None


def _map(item, fn):
    """``fn`` on each array of ``item`` (an array or a dataclass of
    arrays)."""
    if dataclasses.is_dataclass(item):
        return dataclasses.replace(item, **{
            f.name: _map(getattr(item, f.name), fn)
            for f in dataclasses.fields(item)})
    if isinstance(item, (np.ndarray, torch.Tensor)):
        return fn(item)
    return item


def _tensors(item) -> list[torch.Tensor]:
    out: list[torch.Tensor] = []
    _map(item, lambda t: out.append(t) or t)
    return out


def stage(item, device: str | torch.device,
          stream: torch.cuda.Stream | None = None) -> Staged:
    """Copy ``item``'s arrays to ``device``: on the card from pinned host
    memory, ``non_blocking``, on ``stream`` (a side stream), ending in an
    event; on the CPU as tensors."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return Staged(_map(item, torch.as_tensor), None)
    stream = stream or torch.cuda.Stream(dev)
    with torch.cuda.stream(stream):
        out = _map(item, lambda a: torch.as_tensor(a).pin_memory().to(
            dev, non_blocking=True))
        event = torch.cuda.Event()
        event.record(stream)
    return Staged(out, event)


class Prefetcher:
    """Iterate ``source`` with ``depth`` items prepared ahead on a
    background thread.

    ``put(item)`` prepares an item on the thread: by default
    :func:`stage` to ``device`` (the card unless the caller asks for the
    CPU) on a side stream (see the module doc); a ``put`` of the caller's
    returns the item to hand out, or a :class:`Staged`.  Items come out
    in order; an exception of the source (or of ``put``) is raised to the
    consumer at its position; the thread is a daemon, and :meth:`close`
    (also on garbage collection) stops it and unblocks it from a full
    queue.  ``wait_s`` sums the consumer's waits on the queue."""

    def __init__(self, source: Iterable, device: str | torch.device = "cuda",
                 depth: int = 2, put: Callable | None = None):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        if put is None:
            dev = resolve_device(device)
            stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

            def put(item):
                return stage(item, dev, stream)

        self._put = put
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.wait_s = 0.0
        self._thread = threading.Thread(target=self._run,
                                        args=(iter(source),), daemon=True)
        self._thread.start()

    def _run(self, it: Iterator) -> None:
        try:
            for item in it:
                if self._stop.is_set():
                    return
                self._q.put(("item", self._put(item)))
        except Exception as e:  # noqa: BLE001 — raised again by the consumer
            self._q.put(("error", e))
            return
        self._q.put(("done", None))

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        kind, payload = self._q.get()
        self.wait_s += time.perf_counter() - t0
        if kind == "error":
            self.close()
            raise payload
        if kind == "done":
            raise StopIteration
        if not isinstance(payload, Staged):
            return payload
        if payload.event is not None:
            consumer = torch.cuda.current_stream(payload.event.device)
            consumer.wait_event(payload.event)
            for t in _tensors(payload.item):
                t.record_stream(consumer)
        return payload.item

    def close(self) -> None:
        self._stop.set()
        # drain, so that a producer blocked on a full queue moves on
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __del__(self):
        if hasattr(self, "_q"):    # not when __init__ raised
            self.close()


def perturbed_case_source(base: Graph, n_cases: int, chunk: int,
                          amplitude: float = 0.02, seed: int = 0,
                          targets_for: Callable[[int, np.ndarray],
                                                np.ndarray] | None = None):
    """Yield CaseBatch chunks (numpy) of a synthetic perturbed-geometry
    family, each made when the consumer's thread asks for it.  Case
    ``cid`` jitters the cell centres from ``default_rng(seed + cid)``, so a
    case is the same whatever the chunking; ``targets_for(cid, coords)``
    gives its [N_pad, 7] targets (zeros by default)."""
    from ..parallel.multicase import CaseBatch, perturber

    perturb = perturber(base, amplitude)

    def gen():
        for start in range(0, n_cases, chunk):
            ids = range(start, min(start + chunk, n_cases))
            nf = np.zeros((len(ids), base.n_pad, 3), np.float32)
            efs = np.zeros((len(ids), base.e_pad, 4), np.float32)
            tg = np.zeros((len(ids), base.n_pad, 7), np.float32)
            for j, cid in enumerate(ids):
                _, nf[j], efs[j] = perturb(np.random.default_rng(seed + cid))
                if targets_for is not None:
                    tg[j] = targets_for(cid, nf[j])
            yield CaseBatch(node_feats=nf, edge_feats=efs, targets=tg)

    return gen()


def foam_case_source(case_paths: list[str | Path], chunk: int,
                     time_dir: str,
                     fields: tuple[str, ...] = DEFAULT_FIELDS,
                     normalizer: FieldNormalizer | None = None,
                     node_align: int = 128, edge_align: int = 128
                     ) -> tuple[Graph, FieldNormalizer, Iterator]:
    """Stream OpenFOAM cases sharing one mesh topology: ``(graph,
    normalizer, chunk iterator)``.  The first case defines the graph and,
    without a ``normalizer``, fits one on its fields (a stream allows no
    global two-pass fit); the other cases are parsed a chunk at a time as
    the iterator is drawn, and a case whose topology differs from the
    first raises."""
    from ..parallel.multicase import CaseBatch

    if not case_paths:
        raise ValueError("no case paths")
    first = FoamCase(case_paths[0])
    mesh0 = first.load_mesh()
    graph = build_graph(mesh0, node_align=node_align, edge_align=edge_align)
    perm = (graph.perm.numpy()[: graph.n_nodes]
            if graph.perm is not None else None)
    f0 = first.load_fields(time_dir, fields=fields, n_cells=mesh0.n_cells,
                           strict=True)
    if normalizer is None:
        normalizer = FieldNormalizer().fit(f0)

    senders = graph.senders.numpy()
    receivers = graph.receivers.numpy()

    def load_case(path) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        case = FoamCase(path)
        mesh = case.load_mesh()
        if (mesh.n_cells != mesh0.n_cells
                or mesh.owner.shape != mesh0.owner.shape
                or not np.array_equal(mesh.owner, mesh0.owner)
                or not np.array_equal(mesh.neighbour, mesh0.neighbour)):
            raise ValueError(
                f"case {path} mesh topology differs from {case_paths[0]}")
        coords = np.zeros((graph.n_pad, 3), np.float64)
        cc = mesh.cell_centers
        if perm is not None:
            cc = cc[perm]
        coords[: graph.n_nodes] = cc
        ef = compute_edge_features(coords, senders, receivers)
        ef[graph.n_edges:] = 0.0
        f = case.load_fields(time_dir, fields=fields, n_cells=mesh.n_cells,
                             strict=True)
        packed = pack_targets(normalizer.transform(f))
        if perm is not None:
            packed = packed[perm]
        tg = np.zeros((graph.n_pad, 7), np.float32)
        tg[: packed.shape[0]] = packed
        return coords.astype(np.float32), ef.astype(np.float32), tg

    def gen():
        for start in range(0, len(case_paths), chunk):
            paths = case_paths[start:start + chunk]
            nf = np.zeros((len(paths), graph.n_pad, 3), np.float32)
            efs = np.zeros((len(paths), graph.e_pad, 4), np.float32)
            tg = np.zeros((len(paths), graph.n_pad, 7), np.float32)
            for j, p in enumerate(paths):
                nf[j], efs[j], tg[j] = load_case(p)
            yield CaseBatch(node_feats=nf, edge_feats=efs, targets=tg)

    return graph, normalizer, gen()
