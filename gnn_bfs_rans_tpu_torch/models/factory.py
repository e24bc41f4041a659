"""The one place a model is built from its ``ModelConfig``: the
``Trainer``, the ``Predictor`` (checkpoints and the reference's ``.pt``)
and the CLI build through :func:`build_model`."""

from __future__ import annotations

import torch

from .flow_gnn import FlowGNN, ModelConfig
from .meshgraphnets import LAYER_TYPE, MeshGraphNet


def build_model(config: ModelConfig,
                generator: torch.Generator | None = None) -> torch.nn.Module:
    """``MeshGraphNet`` for ``layer_type='MeshGraphNets'``, else
    ``FlowGNN`` (which raises for a layer type it does not know)."""
    if config.layer_type == LAYER_TYPE:
        return MeshGraphNet(config, generator)
    return FlowGNN(config, generator)
