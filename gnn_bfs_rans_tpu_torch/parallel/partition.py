"""Node-sharded graphs with a halo exchange: meshes larger than one card.

Counterpart of ``gnn_bfs_rans_tpu/parallel/partition.py``.  After RCM
reordering (``graph/reorder.py``) the adjacency is banded, so a contiguous
split of the rows keeps every cross-shard edge within a band of ``halo``
rows (128 by default) of the shard boundary, and each layer exchanges one
halo with each neighbouring rank (``models/partitioned.py::halo_exchange``)
instead of gathering the graph:

    rank d's rows: [ halo from d−1 | n_loc owned rows | halo from d+1 ]

Each layer's conv runs on the extended rows (the halo rows' outputs are
incomplete, their neighbourhoods cut), then the halo is refreshed from the
owners.  BatchNorm sums its statistics over the ranks (the owned rows:
each node once).  A rank holds O(N / world · H) rows.

:func:`build_partition` runs on the host and returns a
:class:`PartitionedGraph` of every shard (leading axis: the shard);
:func:`shard_partition` moves shard d's slice to its device, and
:func:`_local_graph` views it as a port :class:`Graph`.  When the graph
carries a band and the boundaries are tile-aligned, each shard carries its
contiguous slice of the global band planes (:func:`_slice_band`), so the
shard runs the same banded kernels as the whole graph.  Misaligned
boundaries (or a halo narrower than the band's reach) route the shard to
the dense branches: the JAX package's own rule, a routing rule of the
layout, not a fallback from a failure.

On the card the partitioned forward and step replay CUDA graphs (the JAX
functions are jitted; see ``data_parallel.py``), the shard's
``PartitionedGraph`` copied into the capture before each replay, the
halo exchange and the all-reduces captured with them; in a gloo group, or
on the CPU, they run eagerly (``eager``: each one's eager form).  At one
rank the exchange does not run (a shard has no peers).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..graph.band import Band
from ..graph.structs import Graph
from ..train.graphs import GraphCache
from ..train.loop import TrainConfig, apply_update
from ..train.normalization import weighted_fieldwise_mse
from .distributed import (all_gather_rows, all_reduce_, all_reduce_grads,
                          capturable, psum, rank_of, world_size)

# the band planes a partition slices, in the JAX field order
BAND_PLANES = ("adj", "gcn", "bias_self", "bias_noself", "edge", "geo")
# the fields that are no tensors
STATIC = ("halo", "n_loc", "n_nodes", "band_tile")


@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Stacked per-shard local graphs (leading axis: the shard), CPU
    tensors from :func:`build_partition`, or one shard's slice on its
    device from :func:`shard_partition`."""

    node_feat: torch.Tensor   # [n_dev, N_ext, F]
    nbr_idx: torch.Tensor     # [n_dev, N_ext, D] — indices into the ext rows
    nbr_mask: torch.Tensor    # [n_dev, N_ext, D]
    real_mask: torch.Tensor   # [n_dev, N_ext] real nodes incl. halo rows
    owned_mask: torch.Tensor  # [n_dev, N_ext] owned real rows (BN, output)
    in_degree: torch.Tensor   # [n_dev, N_ext] true degrees, halo rows too

    halo: int
    n_loc: int
    n_nodes: int

    # slices of the band planes (graph/band.py layouts, tile axis first)
    band_adj: torch.Tensor | None = None
    band_gcn: torch.Tensor | None = None
    band_bias_self: torch.Tensor | None = None
    band_bias_noself: torch.Tensor | None = None
    band_edge: torch.Tensor | None = None
    band_geo: torch.Tensor | None = None
    band_pos: torch.Tensor | None = None     # [n_dev, N_ext, 4]
    band_tile: int = 0

    @property
    def n_dev(self) -> int:
        return self.node_feat.shape[0]

    @property
    def n_ext(self) -> int:
        return self.node_feat.shape[1]

    @property
    def has_band(self) -> bool:
        return self.band_tile > 0


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def build_partition(graph: Graph, n_dev: int, halo: int = 128
                    ) -> PartitionedGraph:
    """Split a (bandwidth-reordered) graph into ``n_dev`` contiguous node
    shards.  Needs ``n_pad % n_dev == 0``, shards of at least ``halo``
    rows, and every edge within ``halo`` of its shard boundary (an RCM
    bandwidth below ``halo``)."""
    n_pad = graph.n_pad
    if n_pad % n_dev != 0:
        raise ValueError(f"n_pad {n_pad} not divisible by {n_dev} shards")
    n_loc = n_pad // n_dev
    if n_loc < halo:
        raise ValueError(f"shard size {n_loc} smaller than halo {halo}")
    n_ext = n_loc + 2 * halo
    d_max = graph.max_degree

    g_nbr = _np(graph.nbr_idx)
    g_mask = _np(graph.nbr_mask)
    g_feat = _np(graph.node_feat)
    g_nodemask = _np(graph.node_mask)
    g_deg = _np(graph.in_degree)
    f_dim = g_feat.shape[1]

    node_feat = np.zeros((n_dev, n_ext, f_dim), dtype=g_feat.dtype)
    nbr_idx = np.zeros((n_dev, n_ext, d_max), dtype=np.int32)
    nbr_mask = np.zeros((n_dev, n_ext, d_max), dtype=bool)
    real_mask = np.zeros((n_dev, n_ext), dtype=bool)
    owned_mask = np.zeros((n_dev, n_ext), dtype=bool)
    in_degree = np.zeros((n_dev, n_ext), dtype=g_deg.dtype)

    for d in range(n_dev):
        s, e = d * n_loc, (d + 1) * n_loc
        lo, hi = s - halo, e + halo
        src_lo, src_hi = max(lo, 0), min(hi, n_pad)
        dst_lo = src_lo - lo
        span = src_hi - src_lo
        node_feat[d, dst_lo:dst_lo + span] = g_feat[src_lo:src_hi]
        # degrees and real flags hold on halo rows too: a cross-boundary
        # GCN coefficient reads the neighbour's degree
        real_mask[d, dst_lo:dst_lo + span] = g_nodemask[src_lo:src_hi]
        in_degree[d, dst_lo:dst_lo + span] = g_deg[src_lo:src_hi]
        # owned rows carry the aggregation; halo rows are inert.  Masked
        # (padding) slots point at row 0 globally: retarget them to the row
        # itself so they stay inside the window
        rows_global = np.arange(s, e)[:, None]
        shard_mask = g_mask[s:e]
        local = np.where(shard_mask, g_nbr[s:e], rows_global) - lo
        if len(local) and ((local < 0).any() or (local >= n_ext).any()):
            bad = int(
                np.where(shard_mask, np.abs(g_nbr[s:e] - rows_global), 0).max()
            )
            raise ValueError(
                f"edge exceeds halo {halo} on shard {d} (bandwidth {bad}); "
                "reorder the graph (rcm) or increase halo"
            )
        nbr_idx[d, halo:halo + n_loc] = local
        nbr_mask[d, halo:halo + n_loc] = g_mask[s:e]
        owned_mask[d, halo:halo + n_loc] = g_nodemask[s:e]

    band_slices, band_tile = _slice_band(graph, n_dev, n_loc, halo)
    t = torch.from_numpy
    return PartitionedGraph(
        node_feat=t(node_feat), nbr_idx=t(nbr_idx), nbr_mask=t(nbr_mask),
        real_mask=t(real_mask), owned_mask=t(owned_mask),
        in_degree=t(in_degree), halo=halo, n_loc=n_loc,
        n_nodes=graph.n_nodes, band_tile=band_tile, **band_slices)


def _slice_band(graph: Graph, n_dev: int, n_loc: int, halo: int
                ) -> tuple[dict, int]:
    """Per-shard slices of the global band planes (CPU tensors).

    Shard d's extended rows are global rows ``[d·n_loc − halo, (d+1)·n_loc
    + halo)``, so its planes are the same contiguous slice of the global
    planes along the tile axis (window offsets are relative).  Tiles
    outside the global range (the outer halos of the first and last shard)
    stay all-zero, except ``bias_self``'s diagonal, set so that every row
    of the GAT softmax has an entry: row i's self-loop column in the [T,
    Wcols] layout is ``i + (Wcols − T)/2``.  Misaligned boundaries, or a
    halo narrower than the band's reach, return no slices: the shards run
    the dense branches (the routing rule of the module doc)."""
    band = graph.band
    if band is None:
        return {}, 0
    tile = band.tile
    if halo % tile or n_loc % tile or halo < band.reach:
        return {}, 0
    ht, lt = halo // tile, n_loc // tile
    n_ext_tiles = lt + 2 * ht
    n_tiles = graph.n_pad // tile

    out: dict[str, torch.Tensor] = {}
    diag = torch.arange(tile)
    for name in BAND_PLANES:
        arr = getattr(band, name)
        if arr is None:
            continue
        arr = arr.cpu()
        local = arr.new_zeros((n_dev, n_ext_tiles) + tuple(arr.shape[1:]))
        for d in range(n_dev):
            t_s = d * lt - ht
            src_lo, src_hi = max(t_s, 0), min(t_s + n_ext_tiles, n_tiles)
            local[d, src_lo - t_s:src_hi - t_s] = arr[src_lo:src_hi]
            if name == "bias_self":
                pad_left = (arr.shape[-1] - tile) // 2
                for j in list(range(0, src_lo - t_s)) + list(
                        range(src_hi - t_s, n_ext_tiles)):
                    local[d, j, diag, diag + pad_left] = 1
        out[f"band_{name}"] = local
    if band.pos is not None:
        # node positions are row-indexed: sliced as node_feat
        pos = band.pos.cpu()
        n_ext = n_ext_tiles * tile
        n_pad = n_tiles * tile
        local_pos = pos.new_zeros((n_dev, n_ext, pos.shape[1]))
        for d in range(n_dev):
            s = d * n_loc - halo
            src_lo, src_hi = max(s, 0), min(s + n_ext, n_pad)
            local_pos[d, src_lo - s:src_hi - s] = pos[src_lo:src_hi]
        out["band_pos"] = local_pos
    return out, tile


def shard_partition(pgraph: PartitionedGraph, rank: int | None = None,
                    device: str | torch.device = "cuda") -> PartitionedGraph:
    """Shard ``rank``'s slice (default: this process's rank), a leading
    axis of 1, on ``device``."""
    d = rank_of() if rank is None else rank
    return dataclasses.replace(pgraph, **{
        f.name: getattr(pgraph, f.name)[d:d + 1].to(device)
        for f in dataclasses.fields(pgraph)
        if f.name not in STATIC and getattr(pgraph, f.name) is not None})


def _local_graph(pg: PartitionedGraph) -> Graph:
    """A port :class:`Graph` over one shard's extended rows (``pg`` from
    :func:`shard_partition`).  The COO fields are unused by the dense and
    banded branches: single-entry dummies keep the container whole.  With
    band slices, a :class:`Band` of its own (which computes its own
    transposed planes) runs the banded kernels."""
    band = None
    if pg.band_tile:
        def plane(name):
            v = getattr(pg, f"band_{name}")
            return None if v is None else v[0]

        band = Band(adj=plane("adj"), gcn=plane("gcn"),
                    bias_self=plane("bias_self"),
                    bias_noself=plane("bias_noself"), tile=pg.band_tile,
                    edge=plane("edge"), geo=plane("geo"), pos=plane("pos"))
    dev = pg.node_feat.device
    dummy = torch.zeros(8, dtype=torch.int32, device=dev)
    return Graph(
        node_feat=pg.node_feat[0], senders=dummy, receivers=dummy,
        edge_feat=torch.zeros((8, 4), dtype=torch.float32, device=dev),
        node_mask=pg.real_mask[0],
        edge_mask=torch.zeros(8, dtype=torch.bool, device=dev),
        in_degree=pg.in_degree[0], nbr_idx=pg.nbr_idx[0],
        nbr_mask=pg.nbr_mask[0], nbr_edge=torch.zeros_like(pg.nbr_idx[0]),
        n_nodes=pg.n_ext, n_edges=0, band=band)


def make_partitioned_forward(model, halo: int = 128, group=None
                             ) -> Callable:
    """``forward(pshard) -> [n_loc, out]``: the eval forward of ``model``
    (any port ``FlowGNN``: its parameters and statistics, unchanged) on
    this rank's shard, the owned rows."""
    from ..models.partitioned import PartitionedFlowGNN

    part = (model if isinstance(model, PartitionedFlowGNN)
            else PartitionedFlowGNN.from_model(model))
    part.eval()

    @torch.no_grad()
    def forward(pg: PartitionedGraph) -> torch.Tensor:
        out = part(_local_graph(pg), pg.owned_mask[0], halo, group=group)
        return out[halo:halo + pg.n_loc]

    dev = next(part.parameters()).device
    return GraphCache(forward, dev, ("pg",), capture=capturable(dev, group))


def gather_partitioned(out: torch.Tensor, pgraph: PartitionedGraph,
                       group=None) -> np.ndarray:
    """The ranks' [n_loc, out] rows, gathered in rank order → [n_nodes,
    out] host array in graph order."""
    rows = all_gather_rows(out, group)
    return rows.cpu().numpy()[:pgraph.n_nodes]


def shard_partitioned_targets(targets: np.ndarray, pgraph: PartitionedGraph,
                              rank: int | None = None,
                              device: str | torch.device = "cuda"
                              ) -> torch.Tensor:
    """[S, N_pad, 7] graph-order targets → this rank's [S, n_loc, 7]."""
    d = rank_of() if rank is None else rank
    t = np.asarray(targets)[:, d * pgraph.n_loc:(d + 1) * pgraph.n_loc]
    return torch.from_numpy(np.ascontiguousarray(t)).to(device)


def make_partitioned_train_step(model, optimizer,
                                train_cfg: TrainConfig, halo: int = 128,
                                group=None) -> Callable:
    """``step(pshard, targets, lr, generator=None, freeze_pressure=False)
    -> loss``: one node-sharded train step (JAX ``partition.py:335-438``)
    of ``model``, a ``models.partitioned.PartitionedFlowGNN``.

    The loss is this rank's owned rows' mean over the snapshots, weighted
    by its share of the real nodes (``local_count / Σ count``), so the sum
    over the ranks is the global masked mean; the pressure anchor, which
    is nonlinear in the global mean, is built from sums over the ranks.
    The gradients get one explicit SUM all-reduce, then the pressure
    freeze, clip and Adam of ``train/loop.py``.  ``targets``: from
    :func:`shard_partitioned_targets`."""
    def step(pg: PartitionedGraph, targets: torch.Tensor, lr,
             generator: torch.Generator | None = None,
             freeze_pressure: bool = False) -> torch.Tensor:
        g = _local_graph(pg)
        own = pg.owned_mask[0]
        n_loc = pg.n_loc
        local_count = own.float().sum()
        n_total = all_reduce_(local_count.clone(), group).clamp_min(1.0)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(g, own, halo, train=True, generator=generator,
                    group=group)
        out_owned = out[halo:halo + n_loc]
        own_rows = own[halo:halo + n_loc]
        ow = own_rows.to(out.dtype)
        per = torch.stack([
            weighted_fieldwise_mse(out_owned, t, own_rows,
                                   pressure_ref_weight=0.0)
            for t in targets])
        share = per.mean() * (local_count / n_total)
        lam = train_cfg.pressure_ref_weight
        if lam > 0:
            p_pred_mean = psum((out_owned[:, 3] * ow).sum(), group) / n_total
            p_tgt_means = all_reduce_(
                (targets[:, :, 3] * ow[None, :]).sum(1), group) / n_total
            anchor = ((p_pred_mean - p_tgt_means) ** 2).mean()
            w_p = 3.0  # the pressure field weight (DEFAULT_FIELD_WEIGHTS)
            share = share + w_p * lam * anchor / world_size(group)
        share.backward()
        all_reduce_grads(model.parameters(), group)
        loss = all_reduce_(share.detach().clone(), group)
        apply_update(model, optimizer, lr, train_cfg, freeze_pressure)
        return loss

    dev = next(model.parameters()).device
    return GraphCache(step, dev, ("pg", "targets", "lr"),
                      capture=capturable(dev, group),
                      before_capture=lambda: optimizer.zero_grad(
                          set_to_none=True))
