"""Visualization: field comparisons, line plots, training curves.

Numpy and matplotlib copies of ``gnn_bfs_rans_tpu/viz/``.  matplotlib is
imported inside the plotting functions only, so the package imports on a
machine without it (the card's); the plots need it.
"""

from .fields import collapse_to_2d, compare_fields, field_magnitude, normalized_error
from .lines import extract_line_data, plot_line_comparison
from .training import plot_field_errors_detailed, plot_training_curves

__all__ = [
    "collapse_to_2d",
    "compare_fields",
    "field_magnitude",
    "normalized_error",
    "extract_line_data",
    "plot_line_comparison",
    "plot_training_curves",
    "plot_field_errors_detailed",
]
