"""What the benchmark hands the program, through the program's own API.

The port (``gnn_bfs_rans_tpu_torch``) is the system under test: these
helpers build its graph of a benchmark mesh with its own builders, its
``ModelConfig`` and ``TrainConfig`` from a configuration file, and lay
row-wise inputs out in its row order (``graph.perm``), as its loaders do.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gnn_bfs_rans_tpu_torch.foam.reader import FoamMesh
from gnn_bfs_rans_tpu_torch.graph.band import LAYER_COMPONENTS
from gnn_bfs_rans_tpu_torch.graph.build import attach_band, build_graph
from gnn_bfs_rans_tpu_torch.graph.structs import Graph, build_padded_graph
from gnn_bfs_rans_tpu_torch.models.flow_gnn import ModelConfig
from gnn_bfs_rans_tpu_torch.train.loop import TrainConfig


def foam_mesh(mesh) -> FoamMesh:
    """The program's mesh object of a box: its internal faces and cell
    centres (no points or boundary faces: the graph reads neither)."""
    n = mesh.n_cells
    return FoamMesh(points=np.zeros((0, 3)),
                    face_offsets=np.zeros(1, np.int32),
                    face_points=np.zeros(0, np.int32),
                    owner=mesh.owner, neighbour=mesh.neighbour,
                    boundaries={}, cell_centers=mesh.centers,
                    internal_mask=np.ones(n, bool))


def program_graph(mesh, layer_type: str) -> Graph:
    """The program's graph (CPU tensors): a box read as a mesh
    (RCM-reordered), a grid built as a graph; with the band planes the
    program's ``LAYER_COMPONENTS`` names for the layer, where it names
    any."""
    comps = LAYER_COMPONENTS.get(layer_type)
    if mesh.kind == "box":
        graph = build_graph(foam_mesh(mesh), with_band=comps is not None,
                            band_components=comps)
    else:
        graph = build_padded_graph(mesh.senders, mesh.receivers,
                                   mesh.edge_feat,
                                   mesh.centers.astype(np.float32))
        if comps is not None:
            graph = attach_band(graph, comps)
    if comps is not None and graph.band is None:
        raise RuntimeError("the mesh has no band: the kernels do not run")
    return graph


def rows(graph: Graph) -> np.ndarray:
    """The program's row → cell id (its ``perm``; identity without)."""
    n = graph.n_nodes
    if graph.perm is None:
        return np.arange(n)
    return graph.perm.numpy()[:n].astype(np.int64)


def to_rows(cells: np.ndarray, graph: Graph) -> np.ndarray:
    """[..., n, F] in cell order → [..., N_pad, F] in the program's rows,
    padding rows zero."""
    out = np.zeros(cells.shape[:-2] + (graph.n_pad, cells.shape[-1]),
                   cells.dtype)
    out[..., :graph.n_nodes, :] = cells[..., rows(graph), :]
    return out


def model_config(cfg: dict) -> ModelConfig:
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in known})


def train_config(cfg: dict, traffic: dict, seed: int) -> TrainConfig:
    return TrainConfig(**cfg["train"], batch_size=traffic["batch_size"],
                       epoch_block=traffic["epoch_block"],
                       save_every=traffic["save_every"],
                       epochs=traffic["epoch_block"], seed=seed)
