"""Static padded graph container, as torch tensors.

Counterpart of ``gnn_bfs_rans_tpu/graph/structs.py``: the graph is built
once on the host (numpy), padded so the node count is a multiple of the
band tile, and moved to the device once with :meth:`Graph.to`.  Two
adjacency encodings are carried, as in the JAX package: the COO edge list
sorted by receiver (the ``segment`` backend) and the padded dense-neighbour
layout ``nbr_idx`` / ``nbr_mask`` / ``nbr_edge`` ``[N_pad, D_max]`` (the
``dense`` backend, and ``pallas`` on a mesh without a band).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """A padded static graph; tensor fields move together with :meth:`to`."""

    # --- COO encoding, sorted by receiver ---
    node_feat: torch.Tensor   # [N_pad, F] float32 — cell-center coordinates
    senders: torch.Tensor     # [E_pad] int32 (padded entries point at node 0)
    receivers: torch.Tensor   # [E_pad] int32
    edge_feat: torch.Tensor   # [E_pad, 4] float32 — [unit dir xyz, distance]
    node_mask: torch.Tensor   # [N_pad] bool
    edge_mask: torch.Tensor   # [E_pad] bool
    in_degree: torch.Tensor   # [N_pad] float32 — true in-degree (no self loop)

    # --- dense neighbour layout ---
    nbr_idx: torch.Tensor     # [N_pad, D_max] int32 — sender per incoming slot
    nbr_mask: torch.Tensor    # [N_pad, D_max] bool
    nbr_edge: torch.Tensor    # [N_pad, D_max] int32 — COO edge id per slot

    n_nodes: int
    n_edges: int

    # node permutation (new index → original cell id) when the graph was
    # bandwidth-reordered, and the banded adjacency (graph.band.Band)
    perm: torch.Tensor | None = None   # [N_pad] int32
    band: "object | None" = None

    @property
    def n_pad(self) -> int:
        return self.node_feat.shape[0]

    @property
    def e_pad(self) -> int:
        return self.senders.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr_idx.shape[1]

    def to(self, device: str | torch.device) -> "Graph":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor) or (f.name == "band" and v is not None):
                moved[f.name] = v.to(device)
        return dataclasses.replace(self, **moved)


def build_padded_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    edge_feat: np.ndarray,
    node_feat: np.ndarray,
    node_align: int = 128,
    edge_align: int = 128,
    degree_align: int = 4,
) -> Graph:
    """Pad a host-side COO graph into a :class:`Graph` (CPU tensors).

    Edges are sorted by receiver (then sender) exactly as the JAX package
    sorts them; padded edges carry ``senders = receivers = 0`` and a zero
    mask.  The dense layout lists each receiver's senders in that order,
    in ``D_max`` slots (the largest in-degree rounded up to
    ``degree_align``); empty slots hold sender 0, edge 0 and a zero mask.
    """
    n_nodes = int(node_feat.shape[0])
    n_edges = int(senders.shape[0])
    order = np.lexsort((senders, receivers))
    senders = np.asarray(senders, dtype=np.int32)[order]
    receivers = np.asarray(receivers, dtype=np.int32)[order]
    edge_feat = np.asarray(edge_feat, dtype=np.float32)[order]

    n_pad = _round_up(max(n_nodes, 1), node_align)
    e_pad = _round_up(max(n_edges, 1), edge_align)

    node_feat_p = np.zeros((n_pad, node_feat.shape[1]), dtype=np.float32)
    node_feat_p[:n_nodes] = node_feat
    senders_p = np.zeros(e_pad, dtype=np.int32)
    senders_p[:n_edges] = senders
    receivers_p = np.zeros(e_pad, dtype=np.int32)
    receivers_p[:n_edges] = receivers
    edge_feat_p = np.zeros((e_pad, edge_feat.shape[1]), dtype=np.float32)
    edge_feat_p[:n_edges] = edge_feat
    node_mask = np.zeros(n_pad, dtype=bool)
    node_mask[:n_nodes] = True
    edge_mask = np.zeros(e_pad, dtype=bool)
    edge_mask[:n_edges] = True
    deg = np.bincount(receivers, minlength=n_pad).astype(np.float32)

    max_deg = int(deg.max()) if n_edges else 1
    d_max = _round_up(max(max_deg, 1), degree_align)
    nbr_idx = np.zeros((n_pad, d_max), dtype=np.int32)
    nbr_mask = np.zeros((n_pad, d_max), dtype=bool)
    nbr_edge = np.zeros((n_pad, d_max), dtype=np.int32)
    if n_edges:
        # slot index within each receiver's contiguous run
        starts = np.searchsorted(receivers, np.arange(n_pad))
        slot = np.arange(n_edges) - starts[receivers]
        nbr_idx[receivers, slot] = senders
        nbr_mask[receivers, slot] = True
        nbr_edge[receivers, slot] = np.arange(n_edges, dtype=np.int32)

    t = torch.from_numpy
    return Graph(
        node_feat=t(node_feat_p),
        senders=t(senders_p),
        receivers=t(receivers_p),
        edge_feat=t(edge_feat_p),
        node_mask=t(node_mask),
        edge_mask=t(edge_mask),
        in_degree=t(deg),
        nbr_idx=t(nbr_idx),
        nbr_mask=t(nbr_mask),
        nbr_edge=t(nbr_edge),
        n_nodes=n_nodes,
        n_edges=n_edges,
    )
