"""Training-curve plots from training_history.json.

Behavioral parity with the reference's ``plot_training.py``: 2×2 panel (log
train/val loss, LR schedule, per-field errors at their computed epochs,
val−train overfit indicator) and the optional 2×3 detailed per-field panel.
The history schema is identical to the reference's, so either tool can read
either framework's file: the port's ``Trainer`` writes the same
``training_history.json`` (``epoch``, ``train_loss``, ``val_loss``,
``learning_rate``, ``field_errors``), and its ``metrics.jsonl`` beside it is
not read here.  A copy of ``gnn_bfs_rans_tpu/viz/training.py``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

FIELD_COLORS = {
    "U": "blue", "p": "red", "k": "green", "epsilon": "orange", "nut": "purple"
}


def plot_training_curves(
    history_path: str | Path, output_path: str | Path | None = None, log_fn=print
) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    history = json.loads(Path(history_path).read_text())
    epochs = history["epoch"]
    train_loss = history["train_loss"]
    val_loss = history["val_loss"]
    lr = history["learning_rate"]
    field_errors = history["field_errors"]

    fig = plt.figure(figsize=(15, 10))

    ax1 = plt.subplot(2, 2, 1)
    ax1.plot(epochs, train_loss, "b-", label="Train Loss", linewidth=2)
    ax1.plot(epochs, val_loss, "r-", label="Validation Loss", linewidth=2)
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Loss")
    ax1.set_title("Training and Validation Loss", fontweight="bold")
    ax1.legend()
    ax1.grid(True, alpha=0.3)
    ax1.set_yscale("log")

    ax2 = plt.subplot(2, 2, 2)
    ax2.plot(epochs, lr, "g-", linewidth=2)
    ax2.set_xlabel("Epoch")
    ax2.set_ylabel("Learning Rate")
    ax2.set_title("Learning Rate Schedule", fontweight="bold")
    ax2.grid(True, alpha=0.3)
    ax2.set_yscale("log")

    ax3 = plt.subplot(2, 2, 3)
    for field, errors in field_errors.items():
        pts = [(epochs[i], e) for i, e in enumerate(errors) if e is not None]
        if pts:
            xs, ys = zip(*pts)
            ax3.plot(xs, ys, "o-", label=field,
                     color=FIELD_COLORS.get(field, "black"), linewidth=2, markersize=4)
    ax3.set_xlabel("Epoch")
    ax3.set_ylabel("Field Error")
    ax3.set_title("Per-Field Errors (computed every 10 epochs)", fontweight="bold")
    if ax3.get_legend_handles_labels()[0]:
        ax3.legend()
    ax3.grid(True, alpha=0.3)
    ax3.set_yscale("log")

    ax4 = plt.subplot(2, 2, 4)
    diff = np.array(val_loss) - np.array(train_loss)
    ax4.plot(epochs, diff, "m-", linewidth=2)
    ax4.axhline(y=0, color="k", linestyle="--", alpha=0.5)
    ax4.set_xlabel("Epoch")
    ax4.set_ylabel("Val Loss - Train Loss")
    ax4.set_title("Overfitting Indicator", fontweight="bold")
    ax4.grid(True, alpha=0.3)
    ax4.fill_between(epochs, 0, diff, where=diff > 0, alpha=0.3, color="red",
                     label="Overfitting")
    ax4.fill_between(epochs, 0, diff, where=diff <= 0, alpha=0.3, color="green",
                     label="Underfitting")
    ax4.legend()

    plt.tight_layout()
    if output_path is None:
        output_path = Path(history_path).parent / "training_curves.png"
    plt.savefig(output_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    log_fn(f"Training curves saved to {output_path}")
    return Path(output_path)


def plot_field_errors_detailed(
    history_path: str | Path, output_path: str | Path | None = None, log_fn=print
) -> Path:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    history = json.loads(Path(history_path).read_text())
    epochs = history["epoch"]
    field_errors = history["field_errors"]

    fig, axes = plt.subplots(2, 3, figsize=(18, 10))
    axes = axes.flatten()
    names = ["U", "p", "k", "epsilon", "nut"]
    for idx, field in enumerate(names):
        ax = axes[idx]
        pts = [(epochs[i], e) for i, e in enumerate(field_errors[field]) if e is not None]
        if pts:
            xs, ys = zip(*pts)
            ax.plot(xs, ys, "o-", color=FIELD_COLORS.get(field, "black"),
                    linewidth=2, markersize=5)
            ax.set_yscale("log")
        else:
            ax.text(0.5, 0.5, f"No data for {field}", ha="center", va="center",
                    transform=ax.transAxes)
        ax.set_xlabel("Epoch")
        ax.set_ylabel("Error")
        ax.set_title(f"{field} Error", fontweight="bold")
        ax.grid(True, alpha=0.3)
    axes[-1].remove()

    plt.tight_layout()
    if output_path is None:
        output_path = Path(history_path).parent / "field_errors_detailed.png"
    plt.savefig(output_path, dpi=200, bbox_inches="tight")
    plt.close(fig)
    log_fn(f"Field errors plot saved to {output_path}")
    return Path(output_path)
