"""Static padded graph, RCM reordering and the banded adjacency."""

from .band import LAYER_COMPONENTS, Band, build_band
from .build import (
    boundary_cell_mask,
    build_edges,
    build_graph,
    compute_edge_features,
)
from .structs import Graph, build_padded_graph

__all__ = [
    "LAYER_COMPONENTS",
    "Band",
    "build_band",
    "boundary_cell_mask",
    "build_edges",
    "build_graph",
    "compute_edge_features",
    "Graph",
    "build_padded_graph",
]
