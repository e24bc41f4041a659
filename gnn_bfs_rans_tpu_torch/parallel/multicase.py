"""Multi-case data parallelism: perturbed-geometry variants over the ranks.

Counterpart of ``gnn_bfs_rans_tpu/parallel/multicase.py``
(``BASELINE.json`` config 5).  The cases share one mesh topology (one
padded adjacency, replicated); each case has its own geometry (node and
edge features) and targets:

* :class:`CaseBatch` stacks per-case ``node_feats`` / ``edge_feats`` /
  ``targets`` on a leading case axis; :func:`shard_cases` gives each rank
  its contiguous block of cases;
* :func:`make_multicase_train_step`: each rank forwards its cases one by
  one, the BatchNorm running statistics threaded through them; the loss is
  the sum over all cases divided by their number; the gradients get one
  SUM all-reduce; after the step the running statistics are averaged over
  the ranks.  The forward normalizes with each rank's own batch moments
  (the JAX ``FlowGNN``'s BatchNorm has no ``axis_name``), so no
  synchronized BatchNorm runs in it;
* :func:`make_multicase_forward` and :func:`gather_case_predictions` (case
  order, then each case's rows in original cell order through
  ``graph.perm``).

On the card the step and the forward replay CUDA graphs (the JAX
functions are jitted; see ``data_parallel.py``), one a case count of the
chunk, ``freeze_pressure`` and generator: the shared graph and the
chunk's ``CaseBatch`` are copied into the capture before each replay.  In
a gloo group, or on the CPU, they run eagerly; ``eager`` is each one's
eager form.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..foam.reader import FoamMesh
from ..graph.build import build_graph, compute_edge_features
from ..graph.structs import Graph
from ..models.flow_gnn import FlowGNN
from ..models.norm import MaskedBatchNorm
from ..train.graphs import GraphCache
from ..train.loop import TrainConfig, apply_update
from ..train.normalization import weighted_fieldwise_mse
from .distributed import (all_gather_rows, all_reduce_, all_reduce_grads,
                          capturable, rank_of, world_size)


@dataclasses.dataclass(frozen=True)
class CaseBatch:
    """Per-case geometry and targets over a shared topology (numpy arrays
    on the host, tensors on a device)."""

    node_feats: np.ndarray | torch.Tensor   # [C, N_pad, F]
    edge_feats: np.ndarray | torch.Tensor   # [C, E_pad, 4]
    targets: np.ndarray | torch.Tensor      # [C, N_pad, 7]

    @property
    def n_cases(self) -> int:
        return self.node_feats.shape[0]


def perturber(base: Graph, amplitude: float) -> Callable:
    """``perturb(rng) -> (coords f64 [N_pad, 3], node_feat f32, edge_feat
    f32 [E_pad, 4])``: one geometry variant of ``base``, its cell centres
    jittered by ``amplitude`` × the mean edge length drawn from ``rng``
    (z kept: planar cases stay planar; padding rows and edges stay
    zero)."""
    senders = base.senders.numpy()
    receivers = base.receivers.numpy()
    base_coords = base.node_feat.numpy().astype(np.float64)
    ef = base.edge_feat.numpy()
    scale = float(ef[: base.n_edges, 3].mean()) if base.n_edges else 1.0
    mask = base.node_mask.numpy()[:, None]

    def perturb(rng: np.random.Generator):
        jitter = rng.normal(size=base_coords.shape) * (amplitude * scale)
        jitter[:, 2] = 0.0
        coords = base_coords + jitter * mask
        edge_feat = compute_edge_features(coords, senders, receivers)
        edge_feat[base.n_edges:] = 0.0
        return coords, coords.astype(np.float32), edge_feat

    return perturb


def make_perturbed_cases(mesh: FoamMesh, n_cases: int,
                         amplitude: float = 0.02, seed: int = 0,
                         targets: np.ndarray | None = None
                         ) -> tuple[Graph, CaseBatch]:
    """Geometry-perturbed variants of one mesh (shared topology): each case
    jitters the cell centres by ``amplitude`` × the mean edge length (z
    kept: planar cases stay planar), drawn from one
    ``numpy.random.default_rng(seed)`` in case order, as the JAX module
    draws them.  ``targets`` default to zeros."""
    base = build_graph(mesh)
    rng = np.random.default_rng(seed)
    perturb = perturber(base, amplitude)
    node_feats = np.zeros((n_cases, base.n_pad, 3), dtype=np.float32)
    edge_feats = np.zeros((n_cases, base.e_pad, 4), dtype=np.float32)
    for c in range(n_cases):
        coords, node_feats[c], edge_feats[c] = perturb(rng)
    if targets is None:
        targets = np.zeros((n_cases, base.n_pad, 7), dtype=np.float32)
    return base, CaseBatch(node_feats=node_feats, edge_feats=edge_feats,
                           targets=np.asarray(targets, dtype=np.float32))


def local_cases(batch: CaseBatch, world: int | None = None,
                rank: int | None = None) -> CaseBatch:
    """This rank's contiguous block of ``batch``'s cases (the case count
    must divide by the world size)."""
    n = world_size() if world is None else world
    r = rank_of() if rank is None else rank
    if batch.n_cases % n:
        raise ValueError(f"{batch.n_cases} cases do not split over {n} "
                         "ranks")
    per = batch.n_cases // n
    return CaseBatch(*(a[r * per:(r + 1) * per] for a in (
        batch.node_feats, batch.edge_feats, batch.targets)))


def shard_cases(batch: CaseBatch, world: int | None = None,
                rank: int | None = None,
                device: str | torch.device = "cuda") -> CaseBatch:
    """This rank's block of cases as tensors on ``device``."""
    mine = local_cases(batch, world, rank)
    return CaseBatch(*(torch.as_tensor(np.ascontiguousarray(a)).to(device)
                       for a in (mine.node_feats, mine.edge_feats,
                                 mine.targets)))


def _case_graph(graph: Graph, node_feat, edge_feat) -> Graph:
    return dataclasses.replace(graph, node_feat=node_feat,
                               edge_feat=edge_feat)


def _running_stats(model: torch.nn.Module) -> list[torch.Tensor]:
    return [t for m in model.modules() if isinstance(m, MaskedBatchNorm)
            for t in (m.running_mean, m.running_var)]


def make_multicase_train_step(model: FlowGNN,
                              optimizer: torch.optim.Optimizer,
                              cfg: TrainConfig, group=None) -> Callable:
    """``step(graph, batch, lr, generator=None, freeze_pressure=False) ->
    loss``: one step over this rank's cases (``batch`` from
    :func:`shard_cases`), see the module doc.  Each case's backward runs
    right after its forward (the gradients add up), so one case's
    activations are held at a time."""

    def step(graph: Graph, batch: CaseBatch, lr,
             generator: torch.Generator | None = None,
             freeze_pressure: bool = False) -> torch.Tensor:
        n_world = world_size(group)
        total_cases = batch.n_cases * n_world
        model.train()
        optimizer.zero_grad(set_to_none=True)
        share = torch.zeros((), device=batch.targets.device)
        for c in range(batch.n_cases):
            g = _case_graph(graph, batch.node_feats[c], batch.edge_feats[c])
            out = model(g, train=True, generator=generator)
            loss_c = weighted_fieldwise_mse(
                out, batch.targets[c], graph.node_mask,
                pressure_ref_weight=cfg.pressure_ref_weight) / total_cases
            loss_c.backward()
            share = share + loss_c.detach()
        all_reduce_grads(model.parameters(), group)
        loss = all_reduce_(share, group)
        with torch.no_grad():
            # inputs differ by rank: average the running moments
            for t in _running_stats(model):
                all_reduce_(t, group).div_(n_world)
        apply_update(model, optimizer, lr, cfg, freeze_pressure)
        return loss

    dev = next(model.parameters()).device
    return GraphCache(step, dev, ("graph", "batch", "lr"),
                      capture=capturable(dev, group),
                      before_capture=lambda: optimizer.zero_grad(
                          set_to_none=True))


def make_multicase_forward(model: FlowGNN) -> Callable:
    """``forward(graph, batch) -> [C_local, N_pad, out]``: the eval forward
    of this rank's cases, replayed as a CUDA graph on the card."""

    @torch.no_grad()
    def forward(graph: Graph, batch: CaseBatch) -> torch.Tensor:
        model.eval()
        return torch.stack([
            model(_case_graph(graph, batch.node_feats[c],
                              batch.edge_feats[c]))
            for c in range(batch.n_cases)])

    dev = next(model.parameters()).device
    return GraphCache(forward, dev, ("graph", "batch"), capture=True)


def gather_case_predictions(out: torch.Tensor, graph: Graph,
                            group=None) -> np.ndarray:
    """The ranks' [C_local, N_pad, 7] → host [C, n_nodes, 7] in case order
    and original cell order."""
    return cell_order(all_gather_rows(out, group).cpu().numpy(), graph)


def cell_order(cases: np.ndarray, graph: Graph) -> np.ndarray:
    """[C, N_pad, ...] in graph order → [C, n_nodes, ...] in original cell
    order (``graph.perm``)."""
    host = cases[:, :graph.n_nodes]
    if graph.perm is not None:
        perm = graph.perm.cpu().numpy()[:graph.n_nodes]
        unperm = np.empty_like(host)
        unperm[:, perm] = host
        host = unperm
    return host
