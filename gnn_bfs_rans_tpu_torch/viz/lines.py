"""Line-extraction plots: |U| and p along X=c / Y=c lines.

A copy of ``gnn_bfs_rans_tpu/viz/lines.py``.  Behavioral parity with the
reference's ``plot_lines.py:80-228`` (``extract_line_data`` tolerance mask
with nearest-fallback + sort; ``plot_line_comparison`` paired pred-vs-ref
panels with MAE stats).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .fields import field_magnitude


def extract_line_data(
    cell_centers: np.ndarray,
    field_values: np.ndarray,
    x_line: float | None = None,
    y_line: float | None = None,
    tol: float = 1e-4,
) -> tuple[np.ndarray, np.ndarray]:
    """Values along a vertical (X=x_line) or horizontal (Y=y_line) line."""
    cc = np.asarray(cell_centers)
    x, y = cc[:, 0], cc[:, 1]
    vals = np.asarray(field_values)

    if x_line is not None:
        coord, target, positions = x, x_line, y
    elif y_line is not None:
        coord, target, positions = y, y_line, x
    else:
        raise ValueError("either x_line or y_line must be specified")

    mask = np.abs(coord - target) < tol
    if not mask.any():
        d = np.abs(coord - target)
        mask = d < (d.min() + tol)
    pos = positions[mask]
    v = vals[mask]
    order = np.argsort(pos)
    return pos[order], v[order]


def plot_line_comparison(
    predicted_fields: dict[str, np.ndarray],
    reference_fields: dict[str, np.ndarray],
    cell_centers: np.ndarray,
    x_line: float | None = None,
    y_line: float | None = None,
    output_path: str | Path | None = None,
    tol: float = 1e-4,
    log_fn=print,
) -> dict:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred_U = field_magnitude(predicted_fields["U"])
    ref_U = field_magnitude(reference_fields["U"])
    pred_p = np.asarray(predicted_fields["p"]).reshape(-1)
    ref_p = np.asarray(reference_fields["p"]).reshape(-1)

    if x_line is not None:
        line_label, pos_label = f"X = {x_line:.3f}", "Y [m]"
    else:
        line_label, pos_label = f"Y = {y_line:.3f}", "X [m]"

    pu, vu = extract_line_data(cell_centers, pred_U, x_line, y_line, tol)
    ru, wu = extract_line_data(cell_centers, ref_U, x_line, y_line, tol)
    pp, vp = extract_line_data(cell_centers, pred_p, x_line, y_line, tol)
    rp, wp = extract_line_data(cell_centers, ref_p, x_line, y_line, tol)

    fig, axes = plt.subplots(1, 2, figsize=(18, 7))
    axes[0].plot(pu, vu, "b-", label="Predicted", linewidth=2.5, marker="o", markersize=5)
    axes[0].plot(ru, wu, "r--", label="Reference", linewidth=2.5, marker="s", markersize=5)
    axes[0].set_xlabel(pos_label)
    axes[0].set_ylabel("Velocity Magnitude [m/s]")
    axes[0].set_title(f"Velocity along {line_label}", fontweight="bold")
    axes[0].legend(loc="best")
    axes[0].grid(True, alpha=0.3)

    axes[1].plot(pp, vp, "b-", label="Predicted", linewidth=2.5, marker="o", markersize=5)
    axes[1].plot(rp, wp, "r--", label="Reference", linewidth=2.5, marker="s", markersize=5)
    axes[1].set_xlabel(pos_label)
    axes[1].set_ylabel("Pressure [m²/s²]")
    axes[1].set_title(f"Pressure along {line_label}", fontweight="bold")
    axes[1].legend(loc="best")
    axes[1].grid(True, alpha=0.3)

    plt.tight_layout()
    if output_path is not None:
        plt.savefig(output_path, dpi=200, bbox_inches="tight")
        log_fn(f"Saved line plot to {output_path}")
    plt.close(fig)

    stats = {
        "velocity_mae": float(np.mean(np.abs(vu - wu))) if len(vu) == len(wu) else None,
        "pressure_mae": float(np.mean(np.abs(vp - wp))) if len(vp) == len(wp) else None,
        "velocity_pred_range": [float(vu.min()), float(vu.max())],
        "velocity_ref_range": [float(wu.min()), float(wu.max())],
        "pressure_pred_range": [float(vp.min()), float(vp.max())],
        "pressure_ref_range": [float(wp.min()), float(wp.max())],
    }
    log_fn(f"{line_label} Statistics:")
    if stats["velocity_mae"] is not None:
        log_fn(f"  Velocity MAE: {stats['velocity_mae']:.6e}")
    else:
        log_fn("  Velocity MAE: n/a (pred/ref length mismatch)")
    if stats["pressure_mae"] is not None:
        log_fn(f"  Pressure MAE: {stats['pressure_mae']:.6e}")
    return stats
