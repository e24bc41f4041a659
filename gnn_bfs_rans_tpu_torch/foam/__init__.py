"""OpenFOAM I/O: FoamFile-aware parsing, geometry, and writeback (numpy)."""

from .casegen import (
    box_fields,
    drifting_box_fields,
    generate_box_case,
    generate_mixed_prism_case,
)
from .reader import (
    DEFAULT_FIELDS,
    BoundaryPatch,
    FoamCase,
    FoamMesh,
    compute_cell_centers,
    compute_internal_mask,
)
from .writer import FIELD_DIMENSIONS, save_fields_openfoam_format

__all__ = [
    "generate_box_case",
    "generate_mixed_prism_case",
    "box_fields",
    "drifting_box_fields",
    "DEFAULT_FIELDS",
    "BoundaryPatch",
    "FoamCase",
    "FoamMesh",
    "compute_cell_centers",
    "compute_internal_mask",
    "FIELD_DIMENSIONS",
    "save_fields_openfoam_format",
]
