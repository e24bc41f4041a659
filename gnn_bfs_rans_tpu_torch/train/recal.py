"""Exact BatchNorm statistics re-estimation (the "BN recalibration" pass).

Counterpart of ``gnn_bfs_rans_tpu/train/recal.py``.  The model input is
geometry only (one static graph), so ONE deterministic train-mode forward
gives the exact batch statistics of the current parameters.  The JAX
package recovers them by inverting the running-statistics update
(``recal.py:37-61``); here each BatchNorm keeps the batch mean and
unbiased var it used, which are read directly, and the model's own
running statistics are restored.  Used by the trainer's ``bn_recal`` mode
(checkpoints saved with exact statistics, best-model selection on the
exact-statistics loss) and by ``infer --recalibrate_bn``.
"""

from __future__ import annotations

import torch

from ..graph.structs import Graph
from ..models.flow_gnn import FlowGNN, ModelConfig


@torch.no_grad()
def exact_stats(model: FlowGNN, graph: Graph) -> dict[str, torch.Tensor]:
    """The exact running statistics (state-dict keys → tensors) for the
    model's current parameters on ``graph``."""
    if not model.bn:
        return {}
    buffers = dict(model.named_buffers())
    old = {k: v.clone() for k, v in buffers.items()}
    model(graph, train=True)           # deterministic: no generator
    for k, v in old.items():
        buffers[k].copy_(v)
    new = {}
    for i, norm in enumerate(model.norms):
        new[f"norms.{i}.running_mean"], new[f"norms.{i}.running_var"] = \
            norm.batch_stats
    return new


def resolve_bn_recal(mode: str, model_config: ModelConfig) -> bool:
    """``TrainConfig.bn_recal`` ('auto' | 'on' | 'off') against the model:
    'auto' is on for batch-norm models trained in bfloat16 or mixed."""
    has_bn = (model_config.use_batch_norm
              and model_config.norm_type == "batch")
    if not has_bn:
        return False
    if mode == "on":
        return True
    if mode == "off":
        return False
    if mode == "auto":
        return model_config.compute_dtype in ("bfloat16", "mixed")
    raise ValueError(f"bn_recal must be 'auto'|'on'|'off', got {mode!r}")
