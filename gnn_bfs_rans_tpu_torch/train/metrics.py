"""Field comparison metrics (numpy), as in the reference's inference script.

Counterpart of ``comparison_stats`` / ``compare_with_reference`` in
``gnn_bfs_rans_tpu/train/metrics.py`` (which imports JAX for its training
metrics, so the port keeps its own copy).
"""

from __future__ import annotations

import numpy as np

FIELD_NAMES = ("U", "p", "k", "epsilon", "nut")


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
