"""OpenFOAM-format field writeback.

Behavioral parity with the reference's ``inference.py:90-178``
(``save_fields_openfoam_format``): FoamFile-header ASCII ``volVectorField`` /
``volScalarField`` files with the same ``dimensions`` entries
(``inference.py:139-144``) and an empty ``boundaryField`` placeholder, written
via vectorized numpy formatting instead of a per-cell Python loop.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_BANNER = (
    "/*--------------------------------*- C++ -*----------------------------------*\\\n"
    "| =========                 |                                                 |\n"
    "| \\\\      /  F ield         | OpenFOAM: The Open Source CFD Toolbox           |\n"
    "|  \\\\    /   O peration     | Version:  v2406                                 |\n"
    "|   \\\\  /    A nd           | Website:  www.openfoam.com                      |\n"
    "|    \\\\/     M anipulation  |                                                 |\n"
    "\\*---------------------------------------------------------------------------*/\n"
)

# Physical dimensions per predicted field, matching inference.py:123,139-144.
FIELD_DIMENSIONS = {
    "U": "[0 1 -1 0 0 0 0]",
    "p": "[0 2 -2 0 0 0 0]",
    "k": "[0 2 -2 0 0 0 0]",
    "epsilon": "[0 2 -3 0 0 0 0]",
    "nut": "[0 2 -1 0 0 0 0]",
}


def _header(cls: str, location: str, obj: str) -> str:
    return (
        _BANNER
        + "FoamFile\n{\n"
        + "    version     2.0;\n"
        + "    format      ascii;\n"
        + f"    class       {cls};\n"
        + f'    location    "{location}";\n'
        + f"    object      {obj};\n"
        + "}\n"
        + "// * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * * //\n\n"
    )


def _footer() -> str:
    return (
        ";\n\n"
        "boundaryField\n{\n"
        "    // Placeholder - boundary conditions not predicted\n"
        "}\n\n"
        "// ************************************************************************* //\n"
    )


def write_vector_field(
    path: Path, values: np.ndarray, name: str, time_dir: str, dimensions: str
) -> None:
    values = np.asarray(values, dtype=np.float64).reshape(-1, 3)
    rows = [f"({v[0]:.6e} {v[1]:.6e} {v[2]:.6e})" for v in values]
    body = (
        _header("volVectorField", time_dir, name)
        + f"dimensions      {dimensions};\n\n"
        + "internalField   nonuniform List<vector>\n"
        + f"{len(values)}\n(\n"
        + "\n".join(rows)
        + "\n)\n"
        + _footer()
    )
    path.write_text(body)


def write_scalar_field(
    path: Path, values: np.ndarray, name: str, time_dir: str, dimensions: str
) -> None:
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    rows = np.char.mod("%.6e", values)
    body = (
        _header("volScalarField", time_dir, name)
        + f"dimensions      {dimensions};\n\n"
        + "internalField   nonuniform List<scalar>\n"
        + f"{len(values)}\n(\n"
        + "\n".join(rows.tolist())
        + "\n)\n"
        + _footer()
    )
    path.write_text(body)


def save_fields_openfoam_format(
    fields: dict[str, np.ndarray], output_dir: str | Path, time_dir: str = "predicted"
) -> Path:
    """Write a predicted-field snapshot in OpenFOAM ASCII format.

    Mirrors the reference contract: ``output_dir/time_dir/{U,p,k,epsilon,nut}``
    with per-field dimensions from :data:`FIELD_DIMENSIONS`.
    """
    out = Path(output_dir) / time_dir
    out.mkdir(parents=True, exist_ok=True)
    for name, values in fields.items():
        if name not in FIELD_DIMENSIONS:
            continue
        if name == "U":
            write_vector_field(out / name, values, name, time_dir, FIELD_DIMENSIONS[name])
        else:
            write_scalar_field(out / name, values, name, time_dir, FIELD_DIMENSIONS[name])
    return out
