"""Per-field error metrics, as in the reference's training and inference
scripts.

Counterpart of ``gnn_bfs_rans_tpu/train/metrics.py`` (which imports JAX,
so the port keeps its own copy): ``compute_field_errors`` (torch, the
training loop's per-field errors: U as the mean L2 norm of the per-cell
velocity error, scalars as MAE), the numpy ``comparison_stats`` /
``compare_with_reference`` of inference and ``mean_normalized_error``,
the visualization metric.
"""

from __future__ import annotations

import numpy as np
import torch

FIELD_NAMES = ("U", "p", "k", "epsilon", "nut")


def compute_field_errors(pred: torch.Tensor, target: torch.Tensor,
                         node_mask: torch.Tensor) -> dict[str, torch.Tensor]:
    """Per-field errors on packed [N_pad, 7] tensors, over real nodes."""
    m = node_mask.to(pred.dtype)
    count = torch.clamp_min(m.sum(), 1.0)
    errors = {"U": (torch.linalg.vector_norm(pred[:, 0:3] - target[:, 0:3],
                                             dim=1) * m).sum() / count}
    for i, name in enumerate(("p", "k", "epsilon", "nut"), start=3):
        errors[name] = ((pred[:, i] - target[:, i]).abs() * m).sum() / count
    return errors


def comparison_stats(pred: np.ndarray, ref: np.ndarray, vector: bool) -> dict:
    """MAE/RMSE/max (+relative for scalars), as in ``inference.py:181-221``."""
    if vector:
        err = np.linalg.norm(pred - ref, axis=1)
        return {
            "mae": float(err.mean()),
            "rmse": float(np.sqrt((err**2).mean())),
            "max": float(err.max()),
        }
    pred = pred.reshape(-1)
    ref = ref.reshape(-1)
    err = np.abs(pred - ref)
    return {
        "mae": float(err.mean()),
        "rmse": float(np.sqrt((err**2).mean())),
        "max": float(err.max()),
        "rel": float(err.mean() / (np.abs(ref).mean() + 1e-10)),
    }


def compare_with_reference(
    predicted: dict[str, np.ndarray], reference: dict[str, np.ndarray]
) -> dict[str, dict]:
    """Field-by-field comparison dict (printed by the CLI like the reference)."""
    out = {}
    for name in FIELD_NAMES:
        if name not in predicted or name not in reference:
            continue
        pred = np.asarray(predicted[name])
        ref = np.asarray(reference[name])
        if name == "U":
            out[name] = comparison_stats(
                pred.reshape(-1, 3), ref.reshape(-1, 3), vector=True
            )
        else:
            out[name] = comparison_stats(pred, ref, vector=False)
    return out


def mean_normalized_error(pred: np.ndarray, ref: np.ndarray) -> float:
    """|pred−ref| / range(ref) × 100%, averaged — the visualization metric
    (``visualize.py:236-273``)."""
    pred = np.asarray(pred, dtype=np.float64).reshape(-1)
    ref = np.asarray(ref, dtype=np.float64).reshape(-1)
    ref_range = np.nanmax(ref) - np.nanmin(ref)
    if ref_range < 1e-10:
        ref_range = max(abs(np.nanmax(ref)), abs(np.nanmin(ref)))
    eps = max(ref_range * 1e-6, 1e-10)
    err = np.abs(pred - ref) / (ref_range + eps) * 100.0
    return float(err.mean())
