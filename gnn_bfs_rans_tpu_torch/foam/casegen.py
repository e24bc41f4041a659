"""Synthetic OpenFOAM case generators: structured 3-D polyMeshes.

A numpy copy of ``gnn_bfs_rans_tpu/foam/casegen.py``.  ``generate_box_case``
emits a complete ASCII OpenFOAM case (``constant/polyMesh/{points,faces,
owner,neighbour,boundary}`` plus analytic nonuniform field snapshots) for
an ``nx × ny × nz`` hexahedral box, so tests and the GPU smoke run have a
real parsed mesh without shipping mesh data in-repo.  At ``nx=400, ny=30,
nz=1`` it gives 12,000 cells (Wcols 256), the BFS mesh's shape class;
``nx=163, ny=75`` gives Wcols 384.  ``generate_mixed_prism_case`` splits
every odd z-layer's hexes into triangular prisms (triangle and quad faces
mixed, degree 8; at 16×16×7 a 5-tile band window).

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


def generate_mixed_prism_case(
    path: str | Path,
    nx: int,
    ny: int,
    nz: int,
    lengths: tuple[float, float, float] = (1.0, 1.0, 1.0),
    time_dirs: tuple[str, ...] = ("100",),
    field_fn=box_fields,
) -> dict:
    """A mixed hex/prism polyMesh: every odd z-layer's hexes are split into
    two triangular prisms along the (i,j)→(i+1,j+1) diagonal.

    It exercises

    * the faces parser under VARIABLE-size faces — triangles (3 vertices)
      and quads (4) mixed in one ``faces`` file (the bundled BFS case and
      the hex box are all-quads; cf. the reference's general face parser,
      ``openfoam_loader.py:72-92``);
    * cell degree > 6 — an interior hex sandwiched between split layers has
      4 lateral + 2×2 triangle-face neighbors = degree 8, driving the padded
      neighbor layout past the hex D_max and (at suitable nx·ny) the
      5-tile-window banded kernels on a genuinely polyhedral parsed mesh;
    * non-hex cell-center geometry: prism centers are the mean of their 6
      unique vertices (the reader's definition — identical here).

    Requires odd ``nz`` ≥ 3 so the bottom/top boundary layers stay unsplit.
    Returns golden counts exactly like :func:`generate_box_case`.
    """
    path = Path(path)
    if nz < 3 or nz % 2 == 0:
        raise ValueError("mixed case needs odd nz >= 3")
    lx, ly, lz = lengths
    npx, npy, npz = nx + 1, ny + 1, nz + 1

    def vid(i, j, k):
        return i + npx * (j + npy * k)

    xs = np.linspace(0.0, lx, npx)
    ys = np.linspace(0.0, ly, npy)
    zs = np.linspace(0.0, lz, npz)
    K, J, I = np.meshgrid(zs, ys, xs, indexing="ij")
    pts = np.stack([I.ravel(), J.ravel(), K.ravel()], axis=1)

    # ---- cell ids: hex layers (even k) one id; split layers (odd k) A, B.
    # A = triangle (P00, P10, P11) of the x-y square, B = (P00, P11, P01).
    ids: dict[tuple, int] = {}
    nid = 0
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                if k % 2 == 1:
                    ids[(i, j, k, "A")] = nid; nid += 1
                    ids[(i, j, k, "B")] = nid; nid += 1
                else:
                    ids[(i, j, k, "H")] = nid; nid += 1
    n_cells = nid

    def split(k):
        return k % 2 == 1

    int_faces: list[tuple[tuple, int, int]] = []  # (verts, owner, nbr)

    def add_int(verts, a, b):
        if a > b:
            a, b = b, a
        int_faces.append((verts, a, b))

    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                # +x neighbor
                if i + 1 < nx:
                    verts = (vid(i + 1, j, k), vid(i + 1, j + 1, k),
                             vid(i + 1, j + 1, k + 1), vid(i + 1, j, k + 1))
                    if split(k):
                        add_int(verts, ids[(i, j, k, "A")],
                                ids[(i + 1, j, k, "B")])
                    else:
                        add_int(verts, ids[(i, j, k, "H")],
                                ids[(i + 1, j, k, "H")])
                # +y neighbor
                if j + 1 < ny:
                    verts = (vid(i, j + 1, k), vid(i + 1, j + 1, k),
                             vid(i + 1, j + 1, k + 1), vid(i, j + 1, k + 1))
                    if split(k):
                        add_int(verts, ids[(i, j, k, "B")],
                                ids[(i, j + 1, k, "A")])
                    else:
                        add_int(verts, ids[(i, j, k, "H")],
                                ids[(i, j + 1, k, "H")])
                # diagonal face between the two prisms of a split cell
                if split(k):
                    add_int((vid(i, j, k), vid(i + 1, j + 1, k),
                             vid(i + 1, j + 1, k + 1), vid(i, j, k + 1)),
                            ids[(i, j, k, "A")], ids[(i, j, k, "B")])
                # +z neighbor: parity alternates, so one side is always the
                # split layer → two triangle faces across the interface
                if k + 1 < nz:
                    tri_a = (vid(i, j, k + 1), vid(i + 1, j, k + 1),
                             vid(i + 1, j + 1, k + 1))
                    tri_b = (vid(i, j, k + 1), vid(i + 1, j + 1, k + 1),
                             vid(i, j + 1, k + 1))
                    lo = (ids[(i, j, k, "A")], ids[(i, j, k, "B")]) \
                        if split(k) else (ids[(i, j, k, "H")],) * 2
                    hi = (ids[(i, j, k + 1, "A")], ids[(i, j, k + 1, "B")]) \
                        if split(k + 1) else (ids[(i, j, k + 1, "H")],) * 2
                    add_int(tri_a, lo[0], hi[0])
                    add_int(tri_b, lo[1], hi[1])

    # OpenFOAM orders internal faces by owner (upper-triangular)
    int_faces.sort(key=lambda f: (f[1], f[2]))
    faces: list[tuple] = [f[0] for f in int_faces]
    owner: list[int] = [f[1] for f in int_faces]
    neighbour: list[int] = [f[2] for f in int_faces]
    n_internal = len(faces)

    patches: list[tuple[str, int, int]] = []

    def add_patch(name, face_list, owners):
        start = len(faces)
        faces.extend(face_list)
        owner.extend(owners)
        patches.append((name, start, len(face_list)))

    def side_cell(i, j, k, side):
        """Owning cell of a lateral boundary quad."""
        if not split(k):
            return ids[(i, j, k, "H")]
        return ids[(i, j, k, {"xmin": "B", "xmax": "A",
                              "ymin": "A", "ymax": "B"}[side])]

    fl, ow = [], []
    for k in range(nz):
        for j in range(ny):
            fl.append((vid(0, j, k), vid(0, j, k + 1),
                       vid(0, j + 1, k + 1), vid(0, j + 1, k)))
            ow.append(side_cell(0, j, k, "xmin"))
    add_patch("xmin", fl, ow)
    fl, ow = [], []
    for k in range(nz):
        for j in range(ny):
            fl.append((vid(nx, j, k), vid(nx, j + 1, k),
                       vid(nx, j + 1, k + 1), vid(nx, j, k + 1)))
            ow.append(side_cell(nx - 1, j, k, "xmax"))
    add_patch("xmax", fl, ow)
    fl, ow = [], []
    for k in range(nz):
        for i in range(nx):
            fl.append((vid(i, 0, k), vid(i + 1, 0, k),
                       vid(i + 1, 0, k + 1), vid(i, 0, k + 1)))
            ow.append(side_cell(i, 0, k, "ymin"))
    add_patch("ymin", fl, ow)
    fl, ow = [], []
    for k in range(nz):
        for i in range(nx):
            fl.append((vid(i, ny, k), vid(i, ny, k + 1),
                       vid(i + 1, ny, k + 1), vid(i + 1, ny, k)))
            ow.append(side_cell(i, ny - 1, k, "ymax"))
    add_patch("ymax", fl, ow)
    # bottom/top layers are unsplit (odd nz) → plain hex quads
    fl, ow = [], []
    for j in range(ny):
        for i in range(nx):
            fl.append((vid(i, j, 0), vid(i, j + 1, 0),
                       vid(i + 1, j + 1, 0), vid(i + 1, j, 0)))
            ow.append(ids[(i, j, 0, "H")])
    add_patch("zmin", fl, ow)
    fl, ow = [], []
    for j in range(ny):
        for i in range(nx):
            fl.append((vid(i, j, nz), vid(i + 1, j, nz),
                       vid(i + 1, j + 1, nz), vid(i, j + 1, nz)))
            ow.append(ids[(i, j, nz - 1, "H")])
    add_patch("zmax", fl, ow)

    n_faces = len(faces)
    pm = path / "constant" / "polyMesh"
    _write(pm / "points",
           _poly_header("vectorField", "points")
           + f"\n{len(pts)}\n(\n"
           + "\n".join(f"({p[0]:.9g} {p[1]:.9g} {p[2]:.9g})" for p in pts)
           + "\n)\n" + _footer())
    _write(pm / "faces",
           _poly_header("faceList", "faces")
           + f"\n{n_faces}\n(\n"
           + "\n".join(
               f"{len(f)}(" + " ".join(str(v) for v in f) + ")"
               for f in faces)
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

    # cell centers by the READER's definition: mean of the cell's unique
    # vertices (= centroid for hexes; the 6 corners' mean for prisms)
    centers = np.zeros((n_cells, 3))
    for k in range(nz):
        z0, z1 = zs[k], zs[k + 1]
        for j in range(ny):
            y0, y1 = ys[j], ys[j + 1]
            for i in range(nx):
                x0, x1 = xs[i], xs[i + 1]
                if split(k):
                    # A: P00, P10, P11 extruded; B: P00, P11, P01
                    pa = np.array([[x0, y0], [x1, y0], [x1, y1]])
                    pb = np.array([[x0, y0], [x1, y1], [x0, y1]])
                    for key, tri in (("A", pa), ("B", pb)):
                        c = ids[(i, j, k, key)]
                        centers[c, :2] = tri.mean(0)
                        centers[c, 2] = 0.5 * (z0 + z1)
                else:
                    c = ids[(i, j, k, "H")]
                    centers[c] = (0.5 * (x0 + x1), 0.5 * (y0 + y1),
                                  0.5 * (z0 + z1))

    for td in time_dirs:
        save_fields_openfoam_format(field_fn(centers), path, td)

    return {
        "n_points": len(pts),
        "n_cells": n_cells,
        "n_faces": n_faces,
        "n_internal_faces": n_internal,
        "cell_centers": centers,
        "patches": {name: cnt for name, _, cnt in patches},
    }
