"""Process groups: one rank per device, and the collectives the port uses.

Counterpart of ``gnn_bfs_rans_tpu/parallel/distributed.py`` and of the JAX
package's 1-D ``data`` mesh.  A JAX mesh axis spans the devices of one
program; here each device is one process (a rank) of a
``torch.distributed`` group, NCCL on the card and gloo on the CPU.
:func:`init_distributed` is ``initialize_multihost``'s counterpart and
returns the same four keys; rank ``r`` owns ``torch.device("cuda", r)``
(one host: the local rank is the rank).

:func:`launch` runs a function on ``world`` ranks.  A world of 1 runs in
this process and still initializes a group, so the same collectives run;
a larger world spawns one process a rank (``torch.multiprocessing``,
``spawn``), whose function must live in a module (the package's rank
functions are in ``parallel/ranks.py``) so that the children can unpickle
it.  Every group is initialized with a timeout (``TIMEOUT_S``, 60 s)
that bounds each collective, and the launcher's wait on its ranks takes
one too: a hung or failed rank fails the call, it never stalls it.

The collectives: :func:`psum` is the autograd-aware all-reduce (its
backward all-reduces the cotangent, the transpose of ``lax.psum``; an
in-place ``dist.all_reduce`` has no backward), :func:`all_reduce_` the
in-place sum of a tensor that needs no gradient, and
:func:`all_reduce_grads` one flat SUM all-reduce of every gradient.
Without an initialized group each is the identity (a world of 1 with no
collective), so the same model code runs alone.

:func:`capturable` says where the scale-out steps run as CUDA graphs
(``train/graphs.py``): on the card, alone or in a NCCL group, whose
collectives (and ``psum``'s backward) are captured with the step; a gloo
group's are not capturable, so its steps run eagerly.
"""

from __future__ import annotations

import datetime
import os
import queue
import socket
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist

from ..device import resolve_device

# seconds every group waits on a collective, and the launcher on its ranks
TIMEOUT_S = 60.0


def active(group=None) -> bool:
    """Whether collectives run: a process group is initialized."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    return dist.get_world_size(group) if active(group) else 1


def capturable(device: torch.device, group=None) -> bool:
    """Whether a step on ``device`` whose collectives run in ``group`` can
    be captured into a CUDA graph: on the card, with no group or a NCCL
    one."""
    if torch.device(device).type != "cuda":
        return False
    return not active(group) or dist.get_backend(group) == "nccl"


def rank_of(group=None) -> int:
    return dist.get_rank(group) if active(group) else 0


def global_rank(group, rank: int) -> int:
    """The default group's rank of ``group``'s rank ``rank``."""
    return rank if group is None else dist.get_global_rank(group, rank)


def rank_device(rank: int, device: str | torch.device = "cuda"
                ) -> torch.device:
    """The device rank ``rank`` owns: ``cuda:rank``, or the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if rank >= n:
            raise ValueError(f"rank {rank} needs a card, {n} visible")
        return torch.device("cuda", rank)
    return dev


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(backend: str | None = None,
                     init_method: str | None = None, world_size: int = 1,
                     rank: int = 0, device: str | torch.device = "cuda"
                     ) -> dict:
    """Join (or create) the default process group; returns the JAX
    ``initialize_multihost`` keys.  ``backend``: ``nccl`` on the card,
    ``gloo`` on the CPU by default.  ``init_method``: the rendezvous
    (``file://...`` or ``tcp://host:port``); a world of 1 may omit it (a
    free localhost port).  An initialized group is kept as it is."""
    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not active():
        if init_method is None:
            if world_size != 1:
                raise ValueError("a world larger than 1 needs init_method")
            init_method = f"tcp://127.0.0.1:{_free_port()}"
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method, world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return {
        "process_index": dist.get_rank(),
        "process_count": dist.get_world_size(),
        "local_devices": 1,
        "global_devices": dist.get_world_size(),
    }


def _rank_main(rank, fn, world, args, device, init_method, results):
    if torch.device(device).type == "cpu":
        # the CPU ranks share the host's cores
        torch.set_num_threads(1)
    init_distributed(None, init_method, world, rank, device)
    try:
        out = fn(rank, world, *args)
        results.put((rank, out))
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: tuple = (), *,
           device: str | torch.device = "cuda",
           init_method: str | None = None,
           join_timeout_s: float | None = TIMEOUT_S) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks, each in a group
    (``init_distributed``: NCCL on the card, gloo on the CPU), and return
    the results by rank.  A world of 1 runs here; a larger one spawns a
    process a rank (rank r on ``cuda:r``; on the CPU each with one
    thread), rendezvousing at ``init_method`` (default: a file store in a
    temporary directory).  ``join_timeout_s``: the longest the ranks may
    run (None: no limit; each collective still times out after
    ``TIMEOUT_S``).  A rank that raises, or a run past the limit, ends
    every rank and raises here."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    resolve_device(device)
    if world == 1:
        owned = not active()
        init_distributed(None, init_method, 1, 0, device)
        try:
            return [fn(0, 1, *args)]
        finally:
            if owned:
                dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp:
        if init_method is None:
            init_method = f"file://{os.path.join(tmp, 'store')}"
        ctx = torch.multiprocessing.get_context("spawn")
        results = ctx.Queue()
        procs = torch.multiprocessing.spawn(
            _rank_main, nprocs=world, join=False,
            args=(fn, world, args, str(device), init_method, results))
        deadline = (None if join_timeout_s is None
                    else time.monotonic() + join_timeout_s)
        out: dict = {}
        try:
            # drain the queue before joining the ranks that write to it
            while len(out) < world:
                try:
                    rank, value = results.get(timeout=0.5)
                    out[rank] = value
                    continue
                except queue.Empty:
                    pass
                if procs.join(timeout=0) and results.empty():
                    raise RuntimeError(f"ranks ended with {len(out)} of "
                                       f"{world} results")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"ranks ran past {join_timeout_s} s")
            while not procs.join(timeout=0.5):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"ranks ran past {join_timeout_s} s")
        finally:
            for p in procs.processes:
                if p.is_alive():
                    p.kill()
                p.join(timeout=10)
    return [out[r] for r in range(world)]


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum of ``x`` over the group's ranks, differentiable: the backward
    sums the cotangents over the ranks (``lax.psum``'s transpose)."""
    return _Psum.apply(x, group) if active(group) else x


def all_reduce_(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``x`` over the ranks (no gradient); returns x."""
    if active(group):
        dist.all_reduce(x, group=group)
    return x


def all_reduce_grads(params, group=None) -> None:
    """One flat SUM all-reduce of the parameters' gradients (a missing
    gradient counts as zero); each ``p.grad`` becomes its slice of the
    reduced buffer."""
    params = list(params)
    if not active(group) or not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p)
        offset += n


def broadcast_(tensors, group=None, src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s."""
    if active(group):
        for t in tensors:
            dist.broadcast(t, global_rank(group, src), group=group)


def all_gather_rows(x: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along dim 0 in rank
    order."""
    if not active(group):
        return x
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0)
