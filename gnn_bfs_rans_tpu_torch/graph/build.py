"""Vectorized graph construction from a parsed OpenFOAM mesh.

Counterpart of ``gnn_bfs_rans_tpu/graph/build.py`` (numpy, same edge order,
RCM permutation and band): bidirectional owner↔neighbour edges from internal
faces, optional boundary self-loops, edge attributes ``[unit direction xyz,
distance]``; ``boundary_cell_mask`` marks the cells that own a patch's
faces.  The result is a :class:`Graph` of CPU tensors; move it with
``graph.to(device)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..foam.reader import FoamMesh
from .structs import Graph, build_padded_graph


def build_edges(
    mesh: FoamMesh,
    boundary_self_loops: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Bidirectional cell-adjacency edge list from owner/neighbour pairs.

    Returns ``(senders, receivers)``, each ``[2 * n_internal_faces (+ n_boundary)]``.
    """
    n_int = mesh.n_internal_faces
    own = mesh.owner[:n_int].astype(np.int32)
    nbr = mesh.neighbour.astype(np.int32)
    senders = np.concatenate([own, nbr])
    receivers = np.concatenate([nbr, own])
    if boundary_self_loops:
        bcells = mesh.owner[n_int:].astype(np.int32)
        senders = np.concatenate([senders, bcells])
        receivers = np.concatenate([receivers, bcells])
    return senders, receivers


def compute_edge_features(
    cell_centers: np.ndarray, senders: np.ndarray, receivers: np.ndarray
) -> np.ndarray:
    """Per-edge ``[unit dx, dy, dz, distance]``; zeros on self-loops.

    Same geometry semantics as ``graph_constructor.py:58-90`` but vectorized.
    """
    src = cell_centers[senders]
    dst = cell_centers[receivers]
    direction = dst - src
    dist = np.linalg.norm(direction, axis=1)
    safe = np.where(dist > 0, dist, 1.0)
    unit = direction / safe[:, None]
    unit = np.where(dist[:, None] > 0, unit, 0.0)
    return np.concatenate([unit, dist[:, None]], axis=1).astype(np.float32)


def build_graph(
    mesh: FoamMesh,
    boundary_self_loops: bool = False,
    node_align: int = 128,
    edge_align: int = 128,
    reorder: str = "rcm",
    with_band: bool = False,
    band_components: tuple[str, ...] | None = None,
) -> Graph:
    """Build the canonical padded :class:`Graph` for a mesh.

    Node features are the cell-center coordinates (the model's only geometric
    input, as in the reference: ``train.py:104-108``).  With ``reorder='rcm'``
    nodes are relabeled to minimize index bandwidth (results are identical —
    message passing is permutation-equivariant — and the permutation is
    carried in ``graph.perm`` for target loading / writeback).  When the
    reordered graph is band-limited, ``graph.band`` holds the block-banded
    adjacency that the banded kernels consume.
    """
    import dataclasses as _dc

    senders, receivers = build_edges(mesh, boundary_self_loops)
    node_feat = mesh.cell_centers.astype(np.float32)
    n_nodes = node_feat.shape[0]

    perm = None
    if reorder == "rcm":
        from .reorder import apply_permutation, rcm_permutation

        perm = rcm_permutation(senders, receivers, n_nodes)
        _, senders, receivers = apply_permutation(perm, senders, receivers)
        node_feat = node_feat[perm]
    elif reorder not in (None, "none"):
        raise ValueError(f"unknown reorder {reorder!r}")

    edge_feat = compute_edge_features(node_feat.astype(np.float64), senders, receivers)
    graph = build_padded_graph(
        senders,
        receivers,
        edge_feat,
        node_feat,
        node_align=node_align,
        edge_align=edge_align,
    )
    validate_graph(graph, senders, receivers)

    if perm is not None:
        perm_pad = np.arange(graph.n_pad, dtype=np.int32)
        perm_pad[:n_nodes] = perm
        graph = _dc.replace(graph, perm=torch.from_numpy(perm_pad))

    if with_band:
        graph = attach_band(graph, band_components, tile=node_align)
    return graph


def attach_band(graph: Graph, components: tuple[str, ...] | None = None,
                tile: int = 128) -> Graph:
    """``graph`` with the band planes ``components`` (default: all) built
    from its edges, when it is band-limited (``graph/band.py``)."""
    import dataclasses as _dc

    from .band import ALL_COMPONENTS, build_band

    comps = components or ALL_COMPONENTS
    ne = graph.n_edges
    band = build_band(
        graph.senders.numpy()[:ne],
        graph.receivers.numpy()[:ne],
        graph.n_pad,
        graph.node_mask.numpy(),
        graph.in_degree.numpy(),
        tile=tile,
        components=comps,
        edge_feat=(graph.edge_feat.numpy()[:ne]
                   if ("edge" in comps or "geo" in comps) else None),
        node_pos=graph.node_feat.numpy(),
    )
    return graph if band is None else _dc.replace(graph, band=band)


def validate_graph(graph: Graph, senders: np.ndarray, receivers: np.ndarray) -> None:
    """Structural invariants the reference patched at runtime, asserted once.

    - all indices in range (cf. repair at ``graph_constructor.py:167-173``)
    - bidirectionality of non-loop edges
    - no isolated nodes among real nodes (cf. ``graph_constructor.py:175-187``)
    """
    n = graph.n_nodes
    if senders.size == 0:
        return
    if senders.min() < 0 or senders.max() >= n or receivers.min() < 0 or receivers.max() >= n:
        raise ValueError("edge indices out of range")
    non_loop = senders != receivers
    s = senders[non_loop].astype(np.int64)
    r = receivers[non_loop].astype(np.int64)
    # full bidirectionality: the multiset of (s,r) keys must equal the
    # multiset of (r,s) keys — one sort each, covers every edge
    fwd_keys = np.sort(s * n + r)
    rev_keys = np.sort(r * n + s)
    if not np.array_equal(fwd_keys, rev_keys):
        missing = np.setdiff1d(fwd_keys, rev_keys)
        e = missing[0] if missing.size else fwd_keys[0]
        raise ValueError(
            f"graph is not bidirectional: edge ({e // n},{e % n}) has no "
            f"reverse edge ({missing.size} asymmetric pairs)"
        )
    touched = np.zeros(n, dtype=bool)
    touched[senders] = True
    touched[receivers] = True
    if not touched.all():
        missing = int((~touched).sum())
        raise ValueError(f"{missing} isolated nodes in graph")


def boundary_cell_mask(mesh: FoamMesh, patch_name: str) -> np.ndarray:
    """Boolean mask of cells owning faces of a boundary patch.

    Parity with ``graph_constructor.py:271-295`` (``get_boundary_mask``).
    """
    if patch_name not in mesh.boundaries:
        raise ValueError(f"boundary {patch_name!r} not found")
    patch = mesh.boundaries[patch_name]
    mask = np.zeros(mesh.n_cells, dtype=bool)
    faces = np.arange(patch.start_face, patch.start_face + patch.n_faces)
    faces = faces[faces < mesh.n_faces]
    mask[mesh.owner[faces]] = True
    return mask
