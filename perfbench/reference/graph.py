"""The reference's own graph of a mesh.

Worked out again from the mesh the benchmark makes, with nothing taken
from the program: the directed edges (both directions of each internal
face), their ``[unit (receiver − sender), dist]`` features, and the row
order the configuration's dropout streams are keyed by.

The training dropout of the configurations is the port's documented
counter-based stream (``hash(seed + block, element)``, see
:mod:`.stream`), keyed by a row's place in the mesh's bandwidth-reduced
order and an edge's column in its receiver tile's attention window.  So
the reference orders the cells as that order is defined: a mesh read as
faces by reverse Cuthill-McKee (scipy's, symmetric mode, on the
receiver × sender adjacency), a grid built as a graph in its given
order; rows are padded to a multiple of the 128-row tile, and an edge's
window column is ``sender − tile·T + k0s·T/2`` with ``k0s`` the fewest
half tiles that cover every edge's offset (at least one).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

TILE = 128


def rcm_order(senders: np.ndarray, receivers: np.ndarray,
              n: int) -> np.ndarray:
    """new row → cell id."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    adj = coo_matrix((np.ones(len(senders), np.int8), (receivers, senders)),
                     shape=(n, n)).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True),
                      dtype=np.int64)


@dataclasses.dataclass
class RefGraph:
    """Rows in the reference's order (``order``: row → cell id).

    ``senders`` / ``receivers`` (int64, rows), ``edge_feat`` [E, 4] f32
    (the mesh's own for a grid, else from the centres), ``coords`` [n, 3]
    f32, ``n_pad``, and each edge's window column ``col`` (``self_col`` a
    row's own column)."""

    order: np.ndarray
    senders: torch.Tensor
    receivers: torch.Tensor
    edge_feat: torch.Tensor
    coords: torch.Tensor
    n: int
    n_pad: int
    col: torch.Tensor
    self_col: torch.Tensor
    width: int

    def to(self, device) -> "RefGraph":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def edge_features(coords, senders, receivers):
    """``[unit (receiver − sender), dist]`` per edge in f32 (numpy arrays
    or tensors; zero for a zero-length edge)."""
    if isinstance(coords, torch.Tensor):
        d = coords[receivers] - coords[senders]
        dist = torch.linalg.vector_norm(d, dim=1, keepdim=True)
        unit = torch.where(dist > 0, d / torch.where(dist > 0, dist, 1.0),
                           0.0)
        return torch.cat([unit, dist], dim=1).float()
    d = coords[receivers] - coords[senders]
    dist = np.linalg.norm(d, axis=1)
    unit = np.where(dist[:, None] > 0,
                    d / np.where(dist > 0, dist, 1.0)[:, None], 0.0)
    return np.concatenate([unit, dist[:, None]], axis=1).astype(np.float32)


def build(mesh, coords: np.ndarray | None = None) -> RefGraph:
    """The reference graph of ``mesh`` (a ``yardstick.meshes.Mesh``), with
    cell centres ``coords`` (cell order; default the mesh's own)."""
    n = mesh.n_cells
    coords = mesh.centers if coords is None else coords
    if mesh.reorder:
        order = rcm_order(mesh.senders, mesh.receivers, n)
    else:
        order = np.arange(n)
    row_of = np.empty(n, np.int64)
    row_of[order] = np.arange(n)
    s = row_of[mesh.senders]
    r = row_of[mesh.receivers]
    rows_xyz = np.asarray(coords, np.float64)[order]
    if mesh.edge_feat is not None and coords is mesh.centers:
        ef = mesh.edge_feat
    else:
        ef = edge_features(rows_xyz, s, r)
    n_pad = -(-n // TILE) * TILE
    col_off = s - (r // TILE) * TILE
    sub = TILE // 2
    pad_needed = max(int(-col_off.min()), int(col_off.max()) - TILE + 1, 1)
    k0s = -(-pad_needed // sub)
    width = TILE + 2 * k0s * sub
    if abs((s // TILE) - (r // TILE)).max() > 2 or width > 5 * TILE:
        raise ValueError("the mesh is not band-limited: the configuration's "
                         "kernel path does not apply")
    t = torch.from_numpy
    rows = np.arange(n)
    return RefGraph(order=order, senders=t(s), receivers=t(r),
                    edge_feat=t(np.ascontiguousarray(ef, np.float32)),
                    coords=t(rows_xyz.astype(np.float32)), n=n, n_pad=n_pad,
                    col=t(col_off + k0s * sub),
                    self_col=t(rows % TILE + k0s * sub), width=width)
