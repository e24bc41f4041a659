"""The port's checkpoint format: a state dict plus the JAX package's meta.

``<dir>/<name>.pt`` holds the model's ``state_dict`` (``torch.save``);
``<dir>/<name>.meta.json`` uses the same schema as the JAX package's
sidecar (``gnn_bfs_rans_tpu/train/checkpoint.py:63-73``): epoch, val_loss,
model_config, train_config, normalizer, plus any extra keys such as
``bn_recalibrated`` and the trainer's resume fields (``best_val``, ``lr``,
``sched_best``).  A training checkpoint adds ``<dir>/<name>.train.pt``:
the optimizer's state dict (Adam's moments and step), which ``--resume``
needs.  A save's parts are spans of ``utils/trace.py``
(``checkpoint.model``, ``checkpoint.optimizer``, ``checkpoint.meta``) and
the files' sizes on disk a count (``checkpoint.bytes``).
Orbax checkpoints need JAX to read and are not read here: carry JAX
weights over with :mod:`..compat.from_jax`.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any

import torch

from ..models.flow_gnn import ModelConfig
from ..utils import trace
from .normalization import FieldNormalizer


def save_checkpoint(
    directory: str | Path,
    name: str,
    state_dict: dict[str, torch.Tensor],
    *,
    model_config: ModelConfig,
    normalizer: FieldNormalizer | None,
    epoch: int = 0,
    val_loss: float = float("nan"),
    train_config: dict | None = None,
    extra: dict | None = None,
    train_state: dict | None = None,
) -> Path:
    """``train_state``: ``{"optimizer": state_dict}`` for resume."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / f"{name}.pt"
    with trace.span("checkpoint.model"):
        torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
                   path)
        trace.count("checkpoint.bytes", os.path.getsize(path))
    if train_state is not None:
        with trace.span("checkpoint.optimizer"):
            train_path = directory / f"{name}.train.pt"
            torch.save(train_state, train_path)
            trace.count("checkpoint.bytes", os.path.getsize(train_path))
    meta = {
        "epoch": epoch,
        "val_loss": float(val_loss),
        "model_config": model_config.to_dict(),
        "train_config": dict(train_config or {}),
        "normalizer": normalizer.to_dict() if normalizer is not None else None,
        **(extra or {}),
    }
    with trace.span("checkpoint.meta"):
        meta_path = directory / f"{name}.meta.json"
        meta_path.write_text(json.dumps(meta, indent=2))
        trace.count("checkpoint.bytes", os.path.getsize(meta_path))
    return path


def load_meta(directory: str | Path, name: str) -> dict[str, Any]:
    return json.loads((Path(directory) / f"{name}.meta.json").read_text())


def load_checkpoint(
    directory: str | Path, name: str
) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """(state_dict on the CPU, meta)."""
    state = torch.load(Path(directory) / f"{name}.pt", map_location="cpu",
                       weights_only=True)
    return state, load_meta(directory, name)


def load_train_state(directory: str | Path, name: str) -> dict:
    """The optimizer state saved beside a training checkpoint."""
    return torch.load(Path(directory) / f"{name}.train.pt",
                      map_location="cpu", weights_only=True)


def latest_checkpoint(directory: str | Path) -> str | None:
    """Name of the newest ``epoch_N`` checkpoint (for resume), else
    ``best``, else None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    epochs = []
    for p in directory.glob("epoch_*.meta.json"):
        try:
            epochs.append((int(p.name[len("epoch_"):-len(".meta.json")]),
                           p.name[:-len(".meta.json")]))
        except ValueError:
            continue
    if epochs:
        return max(epochs)[1]
    if (directory / "best.meta.json").exists():
        return "best"
    return None
