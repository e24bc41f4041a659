"""FlowGNN forward over a node shard with a halo exchange after each layer.

Counterpart of ``gnn_bfs_rans_tpu/models/partitioned.py``.
:class:`PartitionedFlowGNN` is a :class:`FlowGNN` (the same modules and
parameter names, so any port checkpoint runs partitioned unchanged) whose
forward runs on one rank's shard of a node-partitioned graph
(``parallel/partition.py``): rows ``[halo from rank−1 | owned | halo from
rank+1]``.  Where it differs from ``FlowGNN.forward`` it follows the JAX
partitioned module (``partitioned.py:45-127``):

* ``dtype`` is bf16 only for ``bfloat16``; ``mixed`` runs in f32;
* BatchNorm is always the unfused chain: ``x + x_new``, then
  ``MaskedBatchNorm`` in f32 over the **owned** rows, its sums added over
  the ranks (the group's psum), then a cast back; no fused epilogue;
* the GAT runs without ``fuse_train`` (training takes rows 4, 5, 6; eval
  row 1) and the Transformer without ``fuse_eval``;
* on a shard without a band the convs take their dense branches (the
  partitioned layout carries no COO edges, so ``segment`` runs ``dense``);
* the Transformer is edge-conditioned only where ``edge_ok`` holds
  (``:69-77``): BatchNorm aside, ``use_edge_attr``, ``pallas``, a band with
  ``geo`` or ``edge`` planes, and — where the JAX rule asks for the TPU's
  in-kernel dropout — either no dropout in training or the card, whose
  kernels draw their dropout in the kernel as the TPU's do;
* dropout follows each ReLU and differs by rank (the JAX module folds the
  axis index into its key): its keep bits are the port's hash stream
  (``kernels/dropout.py``) of a seed drawn from the generator, draw index
  the rank; the output MLP has no dropout;
* each layer ends with :func:`halo_exchange`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..graph.structs import Graph
from ..kernels.dropout import draw_seed, hash_bits, threshold
from ..parallel.distributed import global_rank, rank_of, world_size
from .convs import GATConv, TransformerConv, dense
from .flow_gnn import FlowGNN


def _exchange(sends, recvs, group) -> list[torch.Tensor]:
    """Post every (tensor, peer) send and (shape-of, peer) receive of one
    round as one ``batch_isend_irecv``; returns the received tensors."""
    got = [torch.empty_like(like) for like, _ in recvs]
    ops = [dist.P2POp(dist.isend, t.contiguous(), global_rank(group, p),
                      group) for t, p in sends]
    ops += [dist.P2POp(dist.irecv, buf, global_rank(group, p), group)
            for buf, (_, p) in zip(got, recvs)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return got


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, halo, group):
        ctx.halo, ctx.group = halo, group
        world, rank = world_size(group), rank_of(group)
        n_loc = x.shape[0] - 2 * halo
        out = x.clone()
        out[:halo] = 0
        out[halo + n_loc:] = 0
        sends, recvs, into = [], [], []
        if rank + 1 < world:
            # my last owned rows → rank+1's left halo; its first → my right
            sends.append((x[n_loc:n_loc + halo], rank + 1))
            recvs.append((x[:halo], rank + 1))
            into.append(slice(halo + n_loc, None))
        if rank > 0:
            sends.append((x[halo:2 * halo], rank - 1))
            recvs.append((x[:halo], rank - 1))
            into.append(slice(0, halo))
        for rows, got in zip(into, _exchange(sends, recvs, group)):
            out[rows] = got
        return out

    @staticmethod
    def backward(ctx, g):
        halo, group = ctx.halo, ctx.group
        world, rank = world_size(group), rank_of(group)
        n_loc = g.shape[0] - 2 * halo
        dx = g.clone()
        dx[:halo] = 0
        dx[halo + n_loc:] = 0
        # the halo rows' cotangents go back to their owners
        sends, recvs, into = [], [], []
        if rank + 1 < world:
            sends.append((g[halo + n_loc:], rank + 1))
            recvs.append((g[:halo], rank + 1))
            into.append(slice(n_loc, n_loc + halo))
        if rank > 0:
            sends.append((g[:halo], rank - 1))
            recvs.append((g[:halo], rank - 1))
            into.append(slice(halo, 2 * halo))
        for rows, got in zip(into, _exchange(sends, recvs, group)):
            dx[rows] += got
        return dx, None, None


def halo_exchange(x: torch.Tensor, halo: int, group=None) -> torch.Tensor:
    """Refresh the halo rows from the neighbouring ranks' owned rows.

    Layout ``[halo from rank−1 | owned | halo from rank+1]``; the boundary
    ranks' outer halos become zeros (``ppermute``'s semantics); a world of
    1 returns x as it is.  Differentiable: the backward sends the halo
    rows' cotangents to their owners, which add them to their owned rows
    (``ppermute``'s transpose)."""
    if world_size(group) == 1:
        return x
    return _HaloExchange.apply(x, halo, group)


def rank_dropout(x: torch.Tensor, rate: float, seed: torch.Tensor,
                 rank: int) -> torch.Tensor:
    """flax-style dropout of x with keep bits ``hash_bits(seed, i, rank)``
    (element i of x): one stream a rank."""
    flat = torch.arange(x.numel(), device=x.device).view(x.shape)
    keep = hash_bits(seed, flat, rank) >= threshold(rate)
    div = float(torch.tensor(1.0 - rate).to(x.dtype))
    return torch.where(keep, x / div, torch.zeros_like(x))


class PartitionedFlowGNN(FlowGNN):
    """A :class:`FlowGNN` run on a node shard (see the module doc)."""

    def __init__(self, config, generator: torch.Generator | None = None):
        super().__init__(config, generator)
        self.dtype = (torch.bfloat16 if config.compute_dtype == "bfloat16"
                      else None)
        for conv in self.convs:
            conv.dtype = self.dtype
            if conv.backend == "segment":
                conv.backend = "dense"
            if isinstance(conv, GATConv):
                conv.fuse_train = False
            if isinstance(conv, TransformerConv):
                conv.fuse_eval = False

    @classmethod
    def from_model(cls, model: FlowGNN) -> "PartitionedFlowGNN":
        """The partitioned form of ``model``: its parameters and buffers,
        on its device."""
        dev = next(model.parameters()).device
        part = cls(model.config).to(dev)
        part.load_state_dict(model.state_dict())
        return part

    def forward(self, graph: Graph, owned_mask: torch.Tensor, halo: int,
                train: bool = False, generator: torch.Generator | None = None,
                group=None) -> torch.Tensor:
        """[N_ext, out]: the shard's rows (only the owned ones are
        complete).  ``graph``: the shard's local graph
        (``partition._local_graph``); ``owned_mask`` [N_ext] its owned real
        rows; ``train`` with ``generator``: dropout and the running
        statistics' update."""
        cfg = self.config
        dt = self.dtype
        dev = graph.node_feat.device
        band = graph.band
        rate = cfg.dropout if (train and generator is not None) else 0.0
        edge_ok = (cfg.use_edge_attr and cfg.backend == "pallas"
                   and band is not None
                   and (band.edge is not None or band.geo is not None)
                   and (cfg.dropout == 0 or not train or dev.type == "cuda"))
        bn_group = group if group is not None else dist.group.WORLD

        def seed():
            return draw_seed(generator, dev) if rate > 0 else None

        conv_gen = generator if rate > 0 else None
        # the input projection is per node: the halo rows are right already
        x = dense(self.input_proj, graph.node_feat, dt)
        for i, conv in enumerate(self.convs):
            if cfg.layer_type == "GAT":
                x_new = conv(x, graph, train=train, seed=seed(),
                             generator=conv_gen)
            elif cfg.layer_type == "Transformer":
                x_new = conv(x, graph, train=train, seed=seed(),
                             fused_ok=False, generator=conv_gen,
                             use_edge=edge_ok)
            else:
                x_new = conv(x, graph)
            x = x + x_new
            if self.bn:
                # statistics over the owned real rows of every rank
                norm = self.norms[i]
                x = (norm.batch_norm(x.float(), owned_mask, update=True,
                                     group=bn_group) if train
                     else norm(x.float()))
                if dt is not None:
                    x = x.to(dt)
            elif self.ln:
                x = self.norms[i](x)
            x = torch.relu(x)
            if rate > 0:
                x = rank_dropout(x, rate, draw_seed(generator, dev),
                                 rank_of(group))
            # the halo rows saw incomplete neighbourhoods: refresh them
            x = halo_exchange(x, halo, group)
        h = torch.relu(dense(self.out_0, x, dt))
        h = torch.relu(dense(self.out_1, h, dt))
        h = torch.relu(dense(self.out_2, h, dt))
        return dense(self.out_3, h.float(), None)
