"""Training subsystem: normalization, loss, data, steps, checkpoints.

The public names of ``gnn_bfs_rans_tpu/train/__init__.py`` that the port
has; the JAX package's jitted-step factories (``make_train_step``,
``make_eval_step``, ``make_forward``, ``init_state``, ``TrainState``) are
the port's ``train_step``, ``eval_step`` and ``FlowGNN`` itself.  The
multi-topology trainer (``train/multitopo.py``) is exported here too.
"""

from .checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_meta,
    save_checkpoint,
)
from .data import FlowDataset, load_dataset
from .loop import ReduceLROnPlateau, TrainConfig, eval_step, train_step
from .multitopo import (
    MultiTopoDataset,
    MultiTopoTrainer,
    TopoCase,
    load_multitopo_dataset,
)
from .metrics import (
    compare_with_reference,
    compute_field_errors,
    mean_normalized_error,
)
from .normalization import (
    DEFAULT_FIELD_WEIGHTS,
    FieldNormalizer,
    pack_targets,
    unpack_fields,
    weighted_elementwise_mse,
    weighted_fieldwise_mse,
)
from .streaming import Prefetcher, foam_case_source, perturbed_case_source
from .trainer import Trainer

__all__ = [
    "FlowDataset",
    "load_dataset",
    "TrainConfig",
    "Trainer",
    "ReduceLROnPlateau",
    "train_step",
    "eval_step",
    "FieldNormalizer",
    "pack_targets",
    "unpack_fields",
    "weighted_fieldwise_mse",
    "weighted_elementwise_mse",
    "DEFAULT_FIELD_WEIGHTS",
    "compute_field_errors",
    "compare_with_reference",
    "mean_normalized_error",
    "save_checkpoint",
    "load_checkpoint",
    "load_meta",
    "latest_checkpoint",
    "Prefetcher",
    "perturbed_case_source",
    "foam_case_source",
    "TopoCase",
    "MultiTopoDataset",
    "MultiTopoTrainer",
    "load_multitopo_dataset",
]
