"""Field normalization (numpy) and the training loss (torch).

Counterpart of ``gnn_bfs_rans_tpu/train/normalization.py``:
``FieldNormalizer`` — per-field z-score, velocity per component, std
floored at 1e-10 → 1.0 — with its dict (JSON) form, the packed
``[U(3), p, k, epsilon, nut]`` layout (``pack_targets``, ``unpack_fields``,
``packed_mean_std``), ``weighted_fieldwise_mse``, the field-weighted MSE
with the pressure-mean anchor, and ``weighted_elementwise_mse``, the
reference's legacy element-wise weighting (``normalization.py:237-250``).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

DEFAULT_FIELD_WEIGHTS = {"U": 1.0, "p": 3.0, "k": 0.5, "epsilon": 0.5,
                         "nut": 0.5}

_STD_FLOOR = 1e-10


class FieldNormalizer:
    """Per-field z-score normalizer with per-component velocity stats."""

    def __init__(self):
        self.scalers: dict[str, dict] = {}
        self.field_stats: dict[str, dict] = {}

    def fit(self, fields: dict[str, np.ndarray]) -> "FieldNormalizer":
        for name, data in fields.items():
            if name == "U" and data.ndim == 2 and data.shape[1] == 3:
                mean = np.mean(data, axis=0)
                std = np.std(data, axis=0)
                flat = data.reshape(-1)
                self.field_stats[name] = {
                    "mean": float(flat.mean()),
                    "std": float(flat.std()),
                    "min": float(flat.min()),
                    "max": float(flat.max()),
                    "per_component_mean": mean.tolist(),
                    "per_component_std": std.tolist(),
                }
                std = np.where(std > _STD_FLOOR, std, 1.0)
                self.scalers[name] = {
                    "mean": mean, "std": std, "per_component": True
                }
            else:
                flat = np.asarray(data).reshape(-1)
                mean = float(flat.mean())
                std = float(flat.std())
                self.field_stats[name] = {
                    "mean": mean, "std": std,
                    "min": float(flat.min()), "max": float(flat.max()),
                }
                self.scalers[name] = {
                    "mean": mean,
                    "std": std if std > _STD_FLOOR else 1.0,
                    "per_component": False,
                }
        return self

    def transform(self, fields: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        out = {}
        for name, data in fields.items():
            if name not in self.scalers:
                out[name] = data
                continue
            s = self.scalers[name]
            out[name] = (data - s["mean"]) / s["std"]
        return out

    def inverse_transform(self, fields: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        out = {}
        for name, data in fields.items():
            if name not in self.scalers:
                out[name] = data
                continue
            s = self.scalers[name]
            out[name] = data * s["std"] + s["mean"]
        return out

    # ---------------------------------------------------------- packed stats
    def packed_mean_std(self) -> tuple[np.ndarray, np.ndarray]:
        """Stats aligned with the packed [U(3), p, k, epsilon, nut] layout."""
        mean = np.zeros(7)
        std = np.ones(7)
        if "U" in self.scalers:
            # broadcasting takes per-component ([3]) and shared U stats alike
            s = self.scalers["U"]
            mean[0:3] = s["mean"]
            std[0:3] = s["std"]
        for i, name in enumerate(("p", "k", "epsilon", "nut"), start=3):
            if name in self.scalers:
                mean[i] = self.scalers[name]["mean"]
                std[i] = self.scalers[name]["std"]
        return mean, std

    # ---------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        scalers = {}
        for name, s in self.scalers.items():
            scalers[name] = {
                "mean": np.asarray(s["mean"]).tolist(),
                "std": np.asarray(s["std"]).tolist(),
                "per_component": bool(s.get("per_component", False)),
            }
        return {"scalers": scalers, "field_stats": self.field_stats}

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2))

    @classmethod
    def from_dict(cls, d: dict) -> "FieldNormalizer":
        norm = cls()
        norm.field_stats = d.get("field_stats", {})
        for name, s in d.get("scalers", {}).items():
            mean = np.asarray(s["mean"])
            std = np.asarray(s["std"])
            if not s.get("per_component", False):
                mean = float(mean)
                std = float(std)
            norm.scalers[name] = {
                "mean": mean, "std": std,
                "per_component": bool(s.get("per_component", False)),
            }
        return norm

    @classmethod
    def load(cls, path: str | Path) -> "FieldNormalizer":
        return cls.from_dict(json.loads(Path(path).read_text()))


def pack_targets(fields: dict[str, np.ndarray]) -> np.ndarray:
    """Stack normalized fields into the canonical [N, 7] target layout."""
    cols = [np.asarray(fields["U"]).reshape(-1, 3)]
    for name in ("p", "k", "epsilon", "nut"):
        cols.append(np.asarray(fields[name]).reshape(-1, 1))
    return np.concatenate(cols, axis=1)


def unpack_fields(packed):
    """Inverse of :func:`pack_targets` (numpy or tensor), [N, 1] scalars."""
    return {"U": packed[:, 0:3], "p": packed[:, 3:4], "k": packed[:, 4:5],
            "epsilon": packed[:, 5:6], "nut": packed[:, 6:7]}


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over real nodes (and trailing dims), padding excluded."""
    m = mask.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    denom = m.sum() * (x.numel() / x.shape[0])
    return (x * m).sum() / torch.clamp_min(denom, 1.0)


def weighted_fieldwise_mse(
    pred: torch.Tensor,
    target: torch.Tensor,
    node_mask: torch.Tensor,
    field_weights: dict[str, float] | None = None,
    pressure_ref_weight: float = 0.1,
) -> torch.Tensor:
    """Field-wise weighted MSE with the pressure-mean anchor.

    ``pred``/``target``: [N_pad, 7]; ``node_mask``: [N_pad] bool.
    """
    w = {**DEFAULT_FIELD_WEIGHTS, **(field_weights or {})}
    sq = (pred - target) ** 2
    u_loss = _masked_mean(sq[:, 0:3], node_mask)
    p_loss = _masked_mean(sq[:, 3:4], node_mask)
    p_mean_pred = _masked_mean(pred[:, 3:4], node_mask)
    p_mean_tgt = _masked_mean(target[:, 3:4], node_mask)
    p_loss = p_loss + pressure_ref_weight * (p_mean_pred - p_mean_tgt) ** 2
    k_loss = _masked_mean(sq[:, 4:5], node_mask)
    eps_loss = _masked_mean(sq[:, 5:6], node_mask)
    nut_loss = _masked_mean(sq[:, 6:7], node_mask)
    return (w["U"] * u_loss + w["p"] * p_loss + w["k"] * k_loss
            + w["epsilon"] * eps_loss + w["nut"] * nut_loss)


def weighted_elementwise_mse(
    pred: torch.Tensor,
    target: torch.Tensor,
    node_mask: torch.Tensor,
    field_weights: dict[str, float] | None = None,
) -> torch.Tensor:
    """Legacy element-wise weighting (``normalization.py:237-250``): each
    channel's squared error times its field's weight, averaged over the
    real nodes' channels."""
    w = {**DEFAULT_FIELD_WEIGHTS, **(field_weights or {})}
    channel_w = torch.tensor(
        [w["U"]] * 3 + [w["p"], w["k"], w["epsilon"], w["nut"]],
        dtype=pred.dtype, device=pred.device)
    return _masked_mean((pred - target) ** 2 * channel_w, node_mask)
