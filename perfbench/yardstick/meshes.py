"""The benchmark's inputs: meshes and field snapshots.

Frozen copies of the port's traffic generators, so that a change to the
program cannot move what the benchmark feeds it:

* :func:`box_mesh` — the topology and cell centres of
  ``gnn_bfs_rans_tpu_torch/foam/casegen.py::generate_box_case`` (internal
  faces in its order: per cell its +x, +y, +z face, owner < neighbour),
  made in memory: no case files are written or parsed;
* :func:`grid_mesh` — the 4-neighbour quad grid of
  ``gnn_bfs_rans_tpu_torch/utils/synthetic.py::build_grid_graph``
  (row-major cells, both directions of each edge, ``[unit dir, dist]``
  edge features in f32);
* :func:`box_fields` / :func:`drifting_fields` — ``casegen.py``'s analytic
  snapshots drifting with time;
* :func:`normalized_targets` — the per-field z-score of
  ``train/normalization.py::FieldNormalizer`` (velocity per component, a
  std under 1e-10 taken as 1) over all snapshots, packed as
  ``[U(3), p, k, epsilon, nut]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One mesh as both sides receive it.

    ``senders`` / ``receivers``: every directed edge (both directions of
    each internal face), in cell ids; ``owner`` / ``neighbour``: the
    internal faces (box meshes; None for a grid); ``centers`` [n, 3] f64;
    ``edge_feat``: the grid's own f32 ``[unit dir, dist]`` (None for a box,
    whose features each side computes from ``centers``); ``reorder``: the
    program relabels the cells by RCM (a mesh read as faces) or keeps the
    given order (a grid built as a graph)."""

    kind: str
    centers: np.ndarray
    senders: np.ndarray
    receivers: np.ndarray
    owner: np.ndarray | None = None
    neighbour: np.ndarray | None = None
    edge_feat: np.ndarray | None = None

    @property
    def n_cells(self) -> int:
        return self.centers.shape[0]

    @property
    def n_edges(self) -> int:
        return self.senders.shape[0]

    @property
    def reorder(self) -> bool:
        return self.kind == "box"


def box_mesh(nx: int, ny: int, nz: int,
             lengths: tuple[float, float, float] = (1.0, 1.0, 1.0)) -> Mesh:
    """The ``nx × ny × nz`` hexahedral box of ``generate_box_case``."""
    lx, ly, lz = lengths
    k, j, i = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                          indexing="ij")
    cid = (i + nx * (j + ny * k)).ravel()
    i, j, k = i.ravel(), j.ravel(), k.ravel()
    # per cell, in cell order: its +x, +y and +z neighbours where they exist
    cand = np.stack([cid + 1, cid + nx, cid + nx * ny], axis=1)
    ok = np.stack([i + 1 < nx, j + 1 < ny, k + 1 < nz], axis=1)
    owner = np.repeat(cid, 3).reshape(-1, 3)[ok].astype(np.int32)
    neighbour = cand[ok].astype(np.int32)
    cx = (np.arange(nx) + 0.5) * (lx / nx)
    cy = (np.arange(ny) + 0.5) * (ly / ny)
    cz = (np.arange(nz) + 0.5) * (lz / nz)
    kk, jj, ii = np.meshgrid(cz, cy, cx, indexing="ij")
    centers = np.stack([ii.ravel(), jj.ravel(), kk.ravel()], axis=1)
    return Mesh(kind="box", centers=centers,
                senders=np.concatenate([owner, neighbour]),
                receivers=np.concatenate([neighbour, owner]),
                owner=owner, neighbour=neighbour)


def grid_mesh(nx: int, ny: int) -> Mesh:
    """The ``nx × ny`` quad grid of ``build_grid_graph``."""
    n = nx * ny
    idx = np.arange(n).reshape(ny, nx)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    up = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    und = np.concatenate([right, up], axis=1)
    senders = np.concatenate([und[0], und[1]]).astype(np.int32)
    receivers = np.concatenate([und[1], und[0]]).astype(np.int32)
    xs = (np.arange(nx) + 0.5) / nx
    ys = (np.arange(ny) + 0.5) / ny
    coords = np.stack([np.tile(xs, ny), np.repeat(ys, nx), np.zeros(n)],
                      axis=1).astype(np.float32)
    direction = coords[receivers] - coords[senders]
    dist = np.linalg.norm(direction, axis=1, keepdims=True)
    unit = direction / np.maximum(dist, 1e-12)
    edge_feat = np.concatenate([unit, dist], axis=1).astype(np.float32)
    return Mesh(kind="grid", centers=coords.astype(np.float64),
                senders=senders, receivers=receivers, edge_feat=edge_feat)


def make_mesh(spec: dict) -> Mesh:
    """The mesh a traffic file's ``mesh`` entry names."""
    if spec["kind"] == "box":
        return box_mesh(spec["nx"], spec["ny"], spec["nz"])
    if spec["kind"] == "grid":
        return grid_mesh(spec["nx"], spec["ny"])
    raise ValueError(f"unknown mesh kind {spec['kind']!r}")


def box_fields(centers: np.ndarray) -> dict[str, np.ndarray]:
    """Smooth analytic flow-like fields at the cell centres."""
    x, y, z = centers[:, 0], centers[:, 1], centers[:, 2]
    two_pi = 2 * np.pi
    u = np.stack([np.sin(two_pi * x) * np.cos(two_pi * y),
                  -np.cos(two_pi * x) * np.sin(two_pi * y),
                  0.1 * np.sin(two_pi * z)], axis=1)
    return {
        "U": u.astype(np.float64),
        "p": (np.cos(two_pi * x) * np.cos(two_pi * z)).astype(np.float64),
        "k": (0.5 + 0.4 * np.sin(two_pi * x) * np.sin(two_pi * y)),
        "epsilon": (0.5 + 0.4 * np.cos(two_pi * (x + y + z))),
        "nut": (0.3 + 0.2 * np.sin(two_pi * (x - z))),
    }


def drifting_fields(centers: np.ndarray, time: float) -> dict[str, np.ndarray]:
    """:func:`box_fields` shifted along x with the snapshot time, velocity
    and pressure growing with it."""
    fields = box_fields(centers + np.array([1e-3 * time, 0.0, 0.0]))
    fields["U"] = fields["U"] * (1.0 + 1e-3 * time)
    fields["p"] = fields["p"] * (1.0 + 2e-3 * time)
    return fields


FIELDS = ("U", "p", "k", "epsilon", "nut")


def normalized_targets(snapshots: list[dict[str, np.ndarray]]) -> np.ndarray:
    """[S, n, 7] f32 z-scored targets, statistics over all snapshots."""
    packed = []
    stats = {}
    for name in FIELDS:
        data = np.concatenate([s[name] for s in snapshots], axis=0)
        if name == "U":
            mean, std = data.mean(axis=0), data.std(axis=0)
            std = np.where(std > 1e-10, std, 1.0)
        else:
            mean, std = float(data.mean()), float(data.std())
            std = std if std > 1e-10 else 1.0
        stats[name] = (mean, std)
    for s in snapshots:
        cols = [((s["U"] - stats["U"][0]) / stats["U"][1]).reshape(-1, 3)]
        for name in FIELDS[1:]:
            mean, std = stats[name]
            cols.append(((s[name] - mean) / std).reshape(-1, 1))
        packed.append(np.concatenate(cols, axis=1))
    return np.stack(packed).astype(np.float32)

