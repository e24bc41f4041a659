"""The port's checkpoint format: a state dict plus the JAX package's meta.

``<dir>/<name>.pt`` holds the model's ``state_dict`` (``torch.save``);
``<dir>/<name>.meta.json`` uses the same schema as the JAX package's
sidecar (``gnn_bfs_rans_tpu/train/checkpoint.py:63-73``): epoch, val_loss,
model_config, train_config, normalizer, plus any extra keys such as
``bn_recalibrated`` and the trainer's resume fields (``best_val``, ``lr``,
``sched_best``).  A training checkpoint adds ``<dir>/<name>.train.pt``:
the optimizer's state dict (Adam's moments and step), which ``--resume``
needs.  A save's parts are spans of ``utils/trace.py``
(``checkpoint.model``, ``checkpoint.optimizer``, ``checkpoint.meta``) and
the files' sizes on disk a count (``checkpoint.bytes``).
Orbax checkpoints need JAX to read and are not read here: carry JAX
weights over with :mod:`..compat.from_jax`.

:func:`save_checkpoint` writes on the calling thread.  The ``Trainer``
saves through a :class:`CheckpointWriter`: a snapshot of the tensors in
host memory, taken in the card's stream order, and the files written by
:func:`write_checkpoint` on a thread of their own while training goes
on.  Both write the same files; a ``.train.pt`` written from the
snapshot holds CPU tensors where a synchronous save of the card's state
holds CUDA ones (``load_train_state`` maps both to the CPU).
"""

from __future__ import annotations

import collections
import json
import os
import threading
from pathlib import Path
from typing import Any

import torch

from ..models.flow_gnn import ModelConfig
from ..utils import trace
from .normalization import FieldNormalizer


def save_checkpoint(
    directory: str | Path,
    name: str,
    state_dict: dict[str, torch.Tensor],
    *,
    model_config: ModelConfig,
    normalizer: FieldNormalizer | None,
    epoch: int = 0,
    val_loss: float = float("nan"),
    train_config: dict | None = None,
    extra: dict | None = None,
    train_state: dict | None = None,
) -> Path:
    """``train_state``: ``{"optimizer": state_dict}`` for resume."""
    write_checkpoint(directory, name, state_dict, checkpoint_meta(
        model_config=model_config, normalizer=normalizer, epoch=epoch,
        val_loss=val_loss, train_config=train_config, extra=extra),
        train_state)
    return Path(directory) / f"{name}.pt"


def checkpoint_meta(
    *,
    model_config: ModelConfig,
    normalizer: FieldNormalizer | None,
    epoch: int = 0,
    val_loss: float = float("nan"),
    train_config: dict | None = None,
    extra: dict | None = None,
) -> dict[str, Any]:
    """The ``.meta.json`` sidecar's contents."""
    return {
        "epoch": epoch,
        "val_loss": float(val_loss),
        "model_config": model_config.to_dict(),
        "train_config": dict(train_config or {}),
        "normalizer": normalizer.to_dict() if normalizer is not None else None,
        **(extra or {}),
    }


def write_checkpoint(directory: str | Path, name: str,
                     state_dict: dict[str, torch.Tensor], meta: dict,
                     train_state: dict | None = None) -> int:
    """Write ``<name>.pt`` (the state dict's tensors on the CPU),
    ``<name>.train.pt`` (``train_state``, as given) and, last,
    ``<name>.meta.json``, so that a meta file is never found without its
    tensors.  Returns the bytes written."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{name}.pt"
    with trace.span("checkpoint.model"):
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
                   path)
        written = _written(path)
    if train_state is not None:
        with trace.span("checkpoint.optimizer"):
            train_path = directory / f"{name}.train.pt"
            torch.save(train_state, train_path)
            written += _written(train_path)
    with trace.span("checkpoint.meta"):
        meta_path = directory / f"{name}.meta.json"
        meta_path.write_text(json.dumps(meta, indent=2))
        written += _written(meta_path)
    return written


def _written(path: Path) -> int:
    n = os.path.getsize(path)
    trace.count("checkpoint.bytes", n)
    return n


def _map_tensors(tree, fn):
    """``tree`` (dicts, lists, tuples) with each tensor ``t`` replaced by
    ``fn(t)``, in order; other leaves kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(v, fn) for v in tree)
    return tree


class CheckpointWriter:
    """Checkpoints written on a thread of their own, in the order saved.

    :meth:`save` copies every tensor of a checkpoint into a set of host
    buffers and returns.  On the card the buffers are pinned and the
    copies do not block: they run on the device's current stream, after
    the work queued before them, so they read the state as it is at the
    save even when the caller goes on to change it, and an event after
    them marks the snapshot done.  On the CPU the copies are made on the
    calling thread.  No device memory is taken.

    A writer thread, started when a save is queued and none is running
    and ended when the queue runs dry, takes the saves in order: it waits
    for the save's event (a wait that releases the GIL), writes its files
    with :func:`write_checkpoint` in a ``checkpoint.write`` span (attrs
    ``name`` and, once written, ``bytes``) and hands the buffers back.

    Buffer sets are kept per layout of the checkpoint's tensors, at most
    ``SETS`` of each (a block end may save ``best`` and ``epoch_N``); when
    none is free, :meth:`save` waits for the writer in a
    ``checkpoint.wait`` span.  :meth:`wait` waits for every queued write,
    in a ``checkpoint.wait`` span.  A write that failed is raised by the
    next :meth:`save` or :meth:`wait`, chained to the writer's error.
    Counts ``checkpoint.async_saves``, one a save queued.
    """

    SETS = 2

    def __init__(self, device: str | torch.device):
        self.device = torch.device(device)
        self._cond = threading.Condition()
        self._queue: collections.deque = collections.deque()
        self._running = False
        self._free: dict[tuple, list] = collections.defaultdict(list)
        self._sets: collections.Counter = collections.Counter()
        self._failed: list = []

    def save(self, directory: str | Path, name: str,
             state_dict: dict[str, torch.Tensor], meta: dict,
             train_state: dict | None = None) -> None:
        """Snapshot ``state_dict`` and ``train_state`` and queue their
        files (:func:`write_checkpoint`'s arguments)."""
        self._raise_failed()
        tree = ({k: v.detach() for k, v in state_dict.items()}, train_state)
        tensors: list = []
        _map_tensors(tree, tensors.append)
        key = tuple((t.shape, t.stride(), t.dtype) for t in tensors)
        bufs = self._take(key, tensors)
        try:
            fill = iter(bufs)
            with torch.no_grad():
                state, train = _map_tensors(
                    tree, lambda t: next(fill).copy_(t, non_blocking=True))
            done = None
            if self.device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.device))
        except BaseException:
            self._give_back(key, bufs)
            raise
        trace.count("checkpoint.async_saves")
        with self._cond:
            self._queue.append((Path(directory), name, state, meta, train,
                                done, key, bufs))
            if not self._running:
                self._running = True
                threading.Thread(target=self._drain,
                                 name="checkpoint-writer").start()

    def wait(self, raise_failed: bool = True) -> None:
        """Return once every queued write has ended; then raise a failed
        one unless ``raise_failed`` is False (it is raised later)."""
        with trace.span("checkpoint.wait"), self._cond:
            self._cond.wait_for(lambda: not self._running)
        if raise_failed:
            self._raise_failed()

    def _take(self, key: tuple, tensors: list) -> list:
        """A free buffer set of the layout ``key``: one made while fewer
        than ``SETS`` exist, else one the writer hands back."""
        with self._cond:
            free = self._free[key]
            if not free and self._sets[key] >= self.SETS:
                with trace.span("checkpoint.wait"):
                    self._cond.wait_for(lambda: free)
            if free:
                return free.pop()
            self._sets[key] += 1
        pinned = self.device.type == "cuda"
        return [torch.empty_like(t, device="cpu", pin_memory=pinned)
                for t in tensors]

    def _give_back(self, key: tuple, bufs: list) -> None:
        with self._cond:
            self._free[key].append(bufs)
            self._cond.notify_all()

    def _drain(self) -> None:
        while True:
            with self._cond:
                if not self._queue:
                    self._running = False
                    self._cond.notify_all()
                    return
                directory, name, state, meta, train, done, key, bufs = \
                    self._queue[0]
            failed = None
            try:
                if done is not None:
                    done.synchronize()
                with trace.span("checkpoint.write", name=name) as span:
                    written = write_checkpoint(directory, name, state, meta,
                                               train)
                    if span is not None:
                        span.attrs["bytes"] = written
            except Exception as err:    # raised in the saving thread
                failed = err
            finally:
                with self._cond:
                    self._queue.popleft()
                    if failed is not None:
                        self._failed.append((name, failed))
                self._give_back(key, bufs)

    def _raise_failed(self) -> None:
        with self._cond:
            if not self._failed:
                return
            name, err = self._failed.pop(0)
        raise RuntimeError(f"writing checkpoint {name!r} failed") from err


def load_meta(directory: str | Path, name: str) -> dict[str, Any]:
    return json.loads((Path(directory) / f"{name}.meta.json").read_text())


def load_checkpoint(
    directory: str | Path, name: str
) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """(state_dict on the CPU, meta)."""
    state = torch.load(Path(directory) / f"{name}.pt", map_location="cpu",
                       weights_only=True)
    return state, load_meta(directory, name)


def load_train_state(directory: str | Path, name: str) -> dict:
    """The optimizer state saved beside a training checkpoint."""
    return torch.load(Path(directory) / f"{name}.train.pt",
                      map_location="cpu", weights_only=True)


def latest_checkpoint(directory: str | Path) -> str | None:
    """Name of the newest ``epoch_N`` checkpoint (for resume), else
    ``best``, else None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    epochs = []
    for p in directory.glob("epoch_*.meta.json"):
        try:
            epochs.append((int(p.name[len("epoch_"):-len(".meta.json")]),
                           p.name[:-len(".meta.json")]))
        except ValueError:
            continue
    if epochs:
        return max(epochs)[1]
    if (directory / "best.meta.json").exists():
        return "best"
    return None
