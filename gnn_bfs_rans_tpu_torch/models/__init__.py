"""Model zoo: FlowGNN, conv layers, encoder-decoder surrogate (the public
names of ``gnn_bfs_rans_tpu/models/__init__.py``), MeshGraphNets, and
:func:`build_model`, which builds either from a ``ModelConfig``."""

from .convs import CONV_REGISTRY, GATConv, GCNConv, GINConv, TransformerConv
from .flow_gnn import (
    FIELD_NAMES,
    FIELD_SLICES,
    FlowGNN,
    FlowGNNSurrogate,
    ModelConfig,
    split_fields,
)
from .factory import build_model
from .meshgraphnets import MeshGraphNet
from .norm import MaskedBatchNorm

__all__ = [
    "CONV_REGISTRY",
    "GCNConv",
    "GATConv",
    "GINConv",
    "TransformerConv",
    "FlowGNN",
    "FlowGNNSurrogate",
    "ModelConfig",
    "split_fields",
    "FIELD_NAMES",
    "FIELD_SLICES",
    "MaskedBatchNorm",
    "MeshGraphNet",
    "build_model",
]
