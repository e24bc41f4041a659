"""Data parallelism over a process group: snapshots sharded over the ranks.

Counterpart of ``gnn_bfs_rans_tpu/parallel/data_parallel.py``: the graph,
the parameters and the optimizer state are replicated (every rank holds
the whole mesh), the snapshot targets ``[S, N_pad, 7]`` are split over the
ranks in contiguous blocks, and one step reduces the gradients over the
ranks.

* :func:`shard_targets` pads S to a multiple of the world size by
  repeating snapshots round-robin, and gives every copy of snapshot i the
  weight ``1/(c_i·S)`` (c_i its number of copies), so the sum over the
  ranks of ``Σ w_j·loss_j`` is the exact mean over the S snapshots;
* :func:`make_dp_train_step` runs the local weighted loss, then one flat
  SUM all-reduce of the gradients (no division by the world size: the
  weights already sum to 1 over all ranks) and of the loss, then the
  pressure freeze, clip and Adam of ``train/loop.py``.  BatchNorm needs no
  synchronization: every rank forwards the same geometry, so its batch
  statistics are the same on every rank;
* :func:`make_dp_forward` forwards the whole graph on each rank;
  :func:`gather_predictions` returns rows ``[:n_nodes]`` on the host.

The reduction is one ``all_reduce`` of a flat buffer
(``distributed.all_reduce_grads``), not ``DistributedDataParallel``,
whose bucketed hooks average by default and would sit inside the step's
backward.

On the card the step and the forward replay CUDA graphs, the port's
``jax.jit`` of the JAX functions (``train/graphs.py::GraphCache``: one
graph a ``freeze_pressure``, generator and argument shape; the first call
runs eagerly, which also creates the NCCL communicator, the second
captures the step with its all-reduces).  In a gloo group, or on the CPU,
they run eagerly.  ``make_dp_train_step(jit=False)`` returns the eager
step, as the JAX function does the traced body; each graphed function's
``eager`` attribute is its eager form too.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..graph.structs import Graph
from ..models.flow_gnn import FlowGNN
from ..train.graphs import GraphCache
from ..train.loop import TrainConfig, apply_update
from ..train.normalization import weighted_fieldwise_mse
from .distributed import (all_reduce_, all_reduce_grads, broadcast_,
                          capturable, rank_of, world_size)


def shard_targets(targets: np.ndarray, world: int | None = None,
                  rank: int | None = None,
                  device: str | torch.device = "cuda"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's block of the padded snapshots and their weights
    ``(targets [S_pad / world, N_pad, 7], weights [S_pad / world])`` on
    ``device`` (see the module doc for the padding and weights)."""
    n = world_size() if world is None else world
    r = rank_of() if rank is None else rank
    s = targets.shape[0]
    s_pad = -(-s // n) * n
    idx = np.arange(s_pad) % s
    counts = np.bincount(idx, minlength=s)
    weights = (1.0 / (counts[idx].astype(np.float64) * s)).astype(np.float32)
    per = s_pad // n
    block = slice(r * per, (r + 1) * per)
    return (torch.from_numpy(np.ascontiguousarray(targets[idx][block]))
            .to(device),
            torch.from_numpy(weights[block]).to(device))


def replicate(model: torch.nn.Module, group=None) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank; returns the model."""
    with torch.no_grad():
        broadcast_(list(model.parameters()) + list(model.buffers()), group)
    return model


def make_dp_train_step(model: FlowGNN, optimizer: torch.optim.Optimizer,
                       cfg: TrainConfig, group=None,
                       jit: bool = True) -> Callable:
    """``step(graph, targets, weights, lr, generator=None,
    freeze_pressure=False) -> loss``: one data-parallel train step on this
    rank's ``targets`` and ``weights`` (from :func:`shard_targets`); the
    loss returned is the global one, on every rank.  ``jit``: replayed as
    a CUDA graph where :func:`~.distributed.capturable` (see the module
    doc); False: always eager."""

    def step(graph: Graph, targets: torch.Tensor, weights: torch.Tensor,
             lr, generator: torch.Generator | None = None,
             freeze_pressure: bool = False) -> torch.Tensor:
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(graph, train=True, generator=generator)
        per = torch.stack([
            weighted_fieldwise_mse(out, t, graph.node_mask,
                                   pressure_ref_weight=cfg.pressure_ref_weight)
            for t in targets])
        # this rank's share of the global mean
        share = (per * weights).sum()
        share.backward()
        all_reduce_grads(model.parameters(), group)
        loss = all_reduce_(share.detach().clone(), group)
        apply_update(model, optimizer, lr, cfg, freeze_pressure)
        return loss

    if not jit:
        return step
    dev = next(model.parameters()).device
    return GraphCache(step, dev, ("graph", "targets", "weights", "lr"),
                      capture=capturable(dev, group),
                      before_capture=lambda: optimizer.zero_grad(
                          set_to_none=True))


def make_dp_forward(model: FlowGNN) -> Callable:
    """``forward(graph) -> [N_pad, out]``: the eval forward of the whole
    graph on this rank (the node-sharded forward is ``partition``'s),
    replayed as a CUDA graph on the card."""

    @torch.no_grad()
    def forward(graph: Graph) -> torch.Tensor:
        model.eval()
        return model(graph)

    dev = next(model.parameters()).device
    return GraphCache(forward, dev, ("graph",), capture=True)


def gather_predictions(out: torch.Tensor, graph: Graph) -> np.ndarray:
    """Device → host, rows in the graph's order, padding dropped."""
    return out.detach().cpu().numpy()[:graph.n_nodes]
