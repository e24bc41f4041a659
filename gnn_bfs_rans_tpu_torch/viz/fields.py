"""Field-comparison visualization: pred / reference / normalized-error panels.

A copy of ``gnn_bfs_rans_tpu/viz/fields.py``.  Behavioral parity with the
reference's ``visualize.py:164-326``: collapse extruded-3D cell data to 2D
by (x, y) binning, Delaunay triangulation, and a 3-panel ``tricontourf`` figure per field (predicted,
reference, normalized error ``|Δ|/range(ref)×100%`` capped at 10%), with the
same per-field error stats reported.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

FIELD_CONFIGS = {
    "U": {"name": "Velocity Magnitude", "cmap": "RdBu_r", "unit": "m/s"},
    "p": {"name": "Pressure", "cmap": "RdBu_r", "unit": "m²/s²"},
    "k": {"name": "Turbulent Kinetic Energy", "cmap": "RdBu_r", "unit": "m²/s²"},
    "epsilon": {"name": "Dissipation Rate", "cmap": "RdBu_r", "unit": "m²/s³"},
    "nut": {"name": "Turbulent Viscosity", "cmap": "RdBu_r", "unit": "m²/s"},
}


def collapse_to_2d(
    cell_centers: np.ndarray, field: np.ndarray, tol: float = 1e-6
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Average values of cells sharing an (x, y) location (vectorized binning).

    Same semantics as ``visualize.py:164-183`` (keys are coordinates rounded
    to ``tol``) without the Python-dict loop.
    """
    cc = np.asarray(cell_centers)
    kx = np.round(cc[:, 0] / tol).astype(np.int64)
    ky = np.round(cc[:, 1] / tol).astype(np.int64)
    keys = np.stack([kx, ky], axis=1)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    counts = np.bincount(inverse).astype(np.float64)
    x2d = np.bincount(inverse, weights=cc[:, 0]) / counts
    y2d = np.bincount(inverse, weights=cc[:, 1]) / counts
    v2d = np.bincount(inverse, weights=np.asarray(field, np.float64)) / counts
    return x2d, y2d, v2d


def field_magnitude(values: np.ndarray) -> np.ndarray:
    v = np.asarray(values)
    if v.ndim > 1 and v.shape[1] == 3:
        return np.linalg.norm(v, axis=1)
    return v.reshape(-1)


def normalized_error(
    pred2d: np.ndarray, ref2d: np.ndarray, cap: float = 10.0
) -> tuple[np.ndarray, dict]:
    """``|pred−ref| / range(ref) × 100%`` clipped to [0, cap], plus stats.

    Matches ``visualize.py:236-273`` including the tiny-range fallback.
    """
    ref_max, ref_min = np.nanmax(ref2d), np.nanmin(ref2d)
    ref_range = ref_max - ref_min
    ref_scale = ref_range if ref_range >= 1e-10 else max(abs(ref_max), abs(ref_min))
    eps = max(ref_scale * 1e-6, 1e-10)
    if ref_scale > eps:
        err = np.abs(pred2d - ref2d) / (ref_scale + eps) * 100.0
    else:
        err = np.abs(pred2d - ref2d) * 100.0
    err = np.clip(err, 0.0, cap)
    abs_err = np.abs(pred2d - ref2d)
    stats = {
        "mean_abs_error": float(abs_err.mean()),
        "max_abs_error": float(abs_err.max()),
        "ref_scale": float(ref_scale),
        "mean_error_pct": float(err.mean()),
        "max_error_pct": float(err.max()),
    }
    return err, stats


def plot_field_2d_legacy(
    cell_centers: np.ndarray,
    field_values: np.ndarray,
    field_name: str,
    title: str,
    levels: int = 20,
    cmap: str = "viridis",
    output_path: str | Path | None = None,
    grid_res: int = 200,
):
    """Legacy grid-interpolated contour plot.

    Port of the reference's pre-triangulation variant ``visualize.py:84-161``
    (``create_2d_contour_plot``): vector fields collapse to magnitude, values
    are linearly ``griddata``-interpolated onto a ``grid_res × grid_res``
    regular grid, pressure gets a symmetric two-slope colormap normalization,
    and cell centers are overlaid as a faint scatter.  The tricontourf
    pipeline (:func:`compare_fields`) superseded this in the reference too —
    kept for full API parity.  Returns ``(fig, ax)``.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import TwoSlopeNorm
    from scipy.interpolate import griddata

    cc = np.asarray(cell_centers)
    x, y = cc[:, 0], cc[:, 1]
    vals = field_magnitude(field_values)

    xi = np.linspace(x.min(), x.max(), grid_res)
    yi = np.linspace(y.min(), y.max(), grid_res)
    grid_x, grid_y = np.meshgrid(xi, yi)
    grid_v = griddata((x, y), vals, (grid_x, grid_y), method="linear",
                      fill_value=np.nan)

    fig, ax = plt.subplots(figsize=(12, 8))
    if field_name == "p":
        vmin, vmax = float(vals.min()), float(vals.max())
        vcenter = (vmin + vmax) / 2
        if vmin < vcenter < vmax:
            norm = TwoSlopeNorm(vmin=vmin, vcenter=vcenter, vmax=vmax)
            contour = ax.contourf(grid_x, grid_y, grid_v, levels=levels,
                                  cmap=cmap, norm=norm)
        else:  # degenerate (constant field): plain normalization
            contour = ax.contourf(grid_x, grid_y, grid_v, levels=levels,
                                  cmap=cmap)
    else:
        contour = ax.contourf(grid_x, grid_y, grid_v, levels=levels, cmap=cmap)
    cbar = fig.colorbar(contour, ax=ax)
    cbar.set_label(field_name, fontsize=12)
    ax.scatter(x, y, c="k", s=0.1, alpha=0.3)
    ax.set_xlabel("X [m]", fontsize=12)
    ax.set_ylabel("Y [m]", fontsize=12)
    ax.set_title(title, fontsize=14, fontweight="bold")
    ax.set_aspect("equal")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    if output_path is not None:
        fig.savefig(output_path, dpi=300, bbox_inches="tight")
    return fig, ax


def compare_fields(
    predicted_fields: dict[str, np.ndarray],
    reference_fields: dict[str, np.ndarray],
    cell_centers: np.ndarray,
    output_dir: str | Path,
    log_fn=print,
) -> dict[str, dict]:
    """Write per-field 3-panel comparison PNGs; returns per-field stats."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.tri import Triangulation

    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    all_stats: dict[str, dict] = {}

    for name in ("U", "p", "k", "epsilon", "nut"):
        if name not in predicted_fields or name not in reference_fields:
            continue
        cfg = FIELD_CONFIGS[name]
        pred_mag = field_magnitude(predicted_fields[name])
        ref_mag = field_magnitude(reference_fields[name])

        x, y, pred2d = collapse_to_2d(cell_centers, pred_mag)
        _, _, ref2d = collapse_to_2d(cell_centers, ref_mag)

        try:
            tri = Triangulation(x, y)
        except Exception:
            from scipy.spatial import Delaunay

            tri = Triangulation(x, y, Delaunay(np.column_stack([x, y])).simplices)

        err, stats = normalized_error(pred2d, ref2d)
        all_stats[name] = stats
        log_fn(f"  {name} Error Stats:")
        log_fn(f"    Mean absolute error: {stats['mean_abs_error']:.6e}")
        log_fn(f"    Max absolute error: {stats['max_abs_error']:.6e}")
        log_fn(f"    Mean normalized error: {stats['mean_error_pct']:.2f}%")
        log_fn(f"    Max normalized error: {stats['max_error_pct']:.2f}%")

        vmin = min(np.nanmin(pred2d), np.nanmin(ref2d))
        vmax = max(np.nanmax(pred2d), np.nanmax(ref2d))
        levels = np.linspace(vmin, vmax, 50)
        if vmax - vmin < 1e-12:
            levels = np.linspace(vmin - 1e-6, vmax + 1e-6, 50)

        fig, axes = plt.subplots(3, 1, figsize=(12, 20))
        for ax, data, title in (
            (axes[0], pred2d, f"Predicted {cfg['name']}"),
            (axes[1], ref2d, f"Reference {cfg['name']}"),
        ):
            im = ax.tricontourf(
                tri, data, levels=levels, cmap=cfg["cmap"], extend="neither"
            )
            ax.set_title(title, fontsize=14, fontweight="bold")
            ax.set_xlabel("X [m]")
            ax.set_ylabel("Y [m]")
            ax.set_aspect("equal")
            ax.grid(True, alpha=0.3)
            plt.colorbar(im, ax=ax, label=cfg["unit"], fraction=0.035, pad=0.02)

        err_levels = np.linspace(0, 10.0, 50)
        im3 = axes[2].tricontourf(
            tri, err, levels=err_levels, vmin=0, vmax=10.0,
            cmap="RdBu_r", extend="neither",
        )
        axes[2].set_title(
            "Normalized Error: |Predicted - Reference| / Range(Reference) × 100% "
            "(capped at 10%)",
            fontsize=14, fontweight="bold",
        )
        axes[2].set_xlabel("X [m]")
        axes[2].set_ylabel("Y [m]")
        axes[2].set_aspect("equal")
        axes[2].grid(True, alpha=0.3)
        cbar = plt.colorbar(im3, ax=axes[2], label="Error [%]", fraction=0.035, pad=0.02)
        cbar.set_ticks(np.linspace(0, 10, 11))

        plt.tight_layout()
        out = output_dir / f"{name}_comparison.png"
        plt.savefig(out, dpi=200, bbox_inches="tight")
        plt.close(fig)
        log_fn(f"Saved comparison plot: {out}")

    return all_stats
