"""Synthetic OpenFOAM case generator: structured 3-D hex-box polyMesh.

A numpy copy of ``gnn_bfs_rans_tpu/foam/casegen.py::generate_box_case``
(the mixed hex/prism fixture is not carried over).  Emits a complete ASCII
OpenFOAM case (``constant/polyMesh/{points,faces,owner,neighbour,boundary}``
plus analytic nonuniform field snapshots) for an ``nx × ny × nz``
hexahedral box, so tests and the GPU smoke run have a real parsed mesh
without shipping mesh data in-repo.  At ``nx=400, ny=30, nz=1`` it gives
12,000 cells (Wcols 256), the BFS mesh's shape class; ``nx=163, ny=75``
gives Wcols 384.

The face layout follows OpenFOAM conventions: internal faces first, ordered
by owner cell (each cell emits its +x, +y, +z faces), owner < neighbour;
boundary faces grouped into six patches (xmin/xmax/ymin/ymax/zmin/zmax).
Face vertex windings are outward/owner→neighbour oriented, matching
``blockMesh`` output for a single hex block.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .writer import _footer, _header, save_fields_openfoam_format


def _poly_header(cls: str, obj: str, note: str = "") -> str:
    # reuse the field-file banner/FoamFile block but under constant/polyMesh
    h = _header(cls, "constant/polyMesh", obj)
    if note:
        h = h.replace("FoamFile\n{\n", f"FoamFile\n{{\n    note        \"{note}\";\n")
    return h


def _write(path: Path, text: str) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)


def box_fields(centers: np.ndarray) -> dict[str, np.ndarray]:
    """Smooth analytic 3-D flow-like fields evaluated at cell centers."""
    x, y, z = centers[:, 0], centers[:, 1], centers[:, 2]
    two_pi = 2 * np.pi
    U = np.stack(
        [
            np.sin(two_pi * x) * np.cos(two_pi * y),
            -np.cos(two_pi * x) * np.sin(two_pi * y),
            0.1 * np.sin(two_pi * z),
        ],
        axis=1,
    )
    return {
        "U": U.astype(np.float64),
        "p": (np.cos(two_pi * x) * np.cos(two_pi * z)).astype(np.float64),
        "k": (0.5 + 0.4 * np.sin(two_pi * x) * np.sin(two_pi * y)).astype(np.float64),
        "epsilon": (0.5 + 0.4 * np.cos(two_pi * (x + y + z))).astype(np.float64),
        "nut": (0.3 + 0.2 * np.sin(two_pi * (x - z))).astype(np.float64),
    }


def drifting_box_fields(centers: np.ndarray, time: float
                        ) -> dict[str, np.ndarray]:
    """:func:`box_fields` drifting with the snapshot time: the pattern
    shifts along x and its velocity and pressure grow, so snapshots of one
    mesh differ as solver snapshots at several times do."""
    shifted = centers + np.array([1e-3 * time, 0.0, 0.0])
    fields = box_fields(shifted)
    fields["U"] = fields["U"] * (1.0 + 1e-3 * time)
    fields["p"] = fields["p"] * (1.0 + 2e-3 * time)
    return fields


def generate_box_case(
    path: str | Path,
    nx: int,
    ny: int,
    nz: int,
    lengths: tuple[float, float, float] = (1.0, 1.0, 1.0),
    time_dirs: tuple[str, ...] = ("100",),
    field_fn=box_fields,
    time_field_fn=None,
) -> dict:
    """Write a hex-box OpenFOAM case; returns golden counts for tests.

    Each time directory gets ``field_fn(centers)``, or, when
    ``time_field_fn`` is given, ``time_field_fn(centers, float(time_dir))``
    (snapshots that differ by time, e.g. :func:`drifting_box_fields`).

    Returns dict with n_points / n_cells / n_faces / n_internal_faces /
    cell_centers (analytic, cell order) / patch face counts.
    """
    path = Path(path)
    lx, ly, lz = lengths
    npx, npy, npz = nx + 1, ny + 1, nz + 1

    def vid(i, j, k):
        return i + npx * (j + npy * k)

    def cid(i, j, k):
        return i + nx * (j + ny * k)

    # ---- points
    xs = np.linspace(0.0, lx, npx)
    ys = np.linspace(0.0, ly, npy)
    zs = np.linspace(0.0, lz, npz)
    K, J, I = np.meshgrid(zs, ys, xs, indexing="ij")
    pts = np.stack([I.ravel(), J.ravel(), K.ravel()], axis=1)  # vid order

    # ---- faces: internal first (per cell: +x, +y, +z), then boundaries
    faces: list[tuple[int, int, int, int]] = []
    owner: list[int] = []
    neighbour: list[int] = []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                c = cid(i, j, k)
                if i + 1 < nx:  # +x face, normal +x (owner → neighbour)
                    faces.append((vid(i + 1, j, k), vid(i + 1, j + 1, k),
                                  vid(i + 1, j + 1, k + 1), vid(i + 1, j, k + 1)))
                    owner.append(c)
                    neighbour.append(cid(i + 1, j, k))
                if j + 1 < ny:  # +y face
                    faces.append((vid(i, j + 1, k), vid(i, j + 1, k + 1),
                                  vid(i + 1, j + 1, k + 1), vid(i + 1, j + 1, k)))
                    owner.append(c)
                    neighbour.append(cid(i, j + 1, k))
                if k + 1 < nz:  # +z face
                    faces.append((vid(i, j, k + 1), vid(i + 1, j, k + 1),
                                  vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1)))
                    owner.append(c)
                    neighbour.append(cid(i, j, k + 1))
    n_internal = len(faces)

    patches: list[tuple[str, int, int]] = []  # (name, startFace, nFaces)

    def add_patch(name, face_list, owners):
        start = len(faces)
        faces.extend(face_list)
        owner.extend(owners)
        patches.append((name, start, len(face_list)))

    fl, ow = [], []
    for k in range(nz):
        for j in range(ny):
            fl.append((vid(0, j, k), vid(0, j, k + 1),
                       vid(0, j + 1, k + 1), vid(0, j + 1, k)))
            ow.append(cid(0, j, k))
    add_patch("xmin", fl, ow)
    fl, ow = [], []
    for k in range(nz):
        for j in range(ny):
            fl.append((vid(nx, j, k), vid(nx, j + 1, k),
                       vid(nx, j + 1, k + 1), vid(nx, j, k + 1)))
            ow.append(cid(nx - 1, j, k))
    add_patch("xmax", fl, ow)
    fl, ow = [], []
    for k in range(nz):
        for i in range(nx):
            fl.append((vid(i, 0, k), vid(i + 1, 0, k),
                       vid(i + 1, 0, k + 1), vid(i, 0, k + 1)))
            ow.append(cid(i, 0, k))
    add_patch("ymin", fl, ow)
    fl, ow = [], []
    for k in range(nz):
        for i in range(nx):
            fl.append((vid(i, ny, k), vid(i, ny, k + 1),
                       vid(i + 1, ny, k + 1), vid(i + 1, ny, k)))
            ow.append(cid(i, ny - 1, k))
    add_patch("ymax", fl, ow)
    fl, ow = [], []
    for j in range(ny):
        for i in range(nx):
            fl.append((vid(i, j, 0), vid(i, j + 1, 0),
                       vid(i + 1, j + 1, 0), vid(i + 1, j, 0)))
            ow.append(cid(i, j, 0))
    add_patch("zmin", fl, ow)
    fl, ow = [], []
    for j in range(ny):
        for i in range(nx):
            fl.append((vid(i, j, nz), vid(i + 1, j, nz),
                       vid(i + 1, j + 1, nz), vid(i, j + 1, nz)))
            ow.append(cid(i, j, nz - 1))
    add_patch("zmax", fl, ow)

    n_faces = len(faces)
    n_cells = nx * ny * nz
    pm = path / "constant" / "polyMesh"

    _write(pm / "points",
           _poly_header("vectorField", "points")
           + f"\n{len(pts)}\n(\n"
           + "\n".join(f"({p[0]:.9g} {p[1]:.9g} {p[2]:.9g})" for p in pts)
           + "\n)\n" + _footer())
    _write(pm / "faces",
           _poly_header("faceList", "faces")
           + f"\n{n_faces}\n(\n"
           + "\n".join(f"4({f[0]} {f[1]} {f[2]} {f[3]})" for f in faces)
           + "\n)\n" + _footer())
    note = (f"nPoints:{len(pts)}  nCells:{n_cells}  nFaces:{n_faces}  "
            f"nInternalFaces:{n_internal}")
    _write(pm / "owner",
           _poly_header("labelList", "owner", note)
           + f"\n{n_faces}\n(\n" + "\n".join(str(o) for o in owner)
           + "\n)\n" + _footer())
    _write(pm / "neighbour",
           _poly_header("labelList", "neighbour", note)
           + f"\n{n_internal}\n(\n" + "\n".join(str(n) for n in neighbour)
           + "\n)\n" + _footer())
    btxt = _poly_header("polyBoundaryMesh", "boundary") + f"\n{len(patches)}\n(\n"
    for name, start, cnt in patches:
        btxt += (f"    {name}\n    {{\n        type            wall;\n"
                 f"        nFaces          {cnt};\n"
                 f"        startFace       {start};\n    }}\n")
    btxt += ")\n" + _footer()
    _write(pm / "boundary", btxt)

    # ---- analytic cell centers and field snapshots
    cx = (np.arange(nx) + 0.5) * (lx / nx)
    cy = (np.arange(ny) + 0.5) * (ly / ny)
    cz = (np.arange(nz) + 0.5) * (lz / nz)
    KK, JJ, II = np.meshgrid(cz, cy, cx, indexing="ij")
    centers = np.stack([II.ravel(), JJ.ravel(), KK.ravel()], axis=1)  # cid order

    for td in time_dirs:
        fields = (field_fn(centers) if time_field_fn is None
                  else time_field_fn(centers, float(td)))
        save_fields_openfoam_format(fields, path, td)

    return {
        "n_points": len(pts),
        "n_cells": n_cells,
        "n_faces": n_faces,
        "n_internal_faces": n_internal,
        "cell_centers": centers,
        "patches": {name: cnt for name, _, cnt in patches},
    }

