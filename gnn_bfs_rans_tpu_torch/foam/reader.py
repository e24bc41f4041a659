"""OpenFOAM case reader: polyMesh connectivity and volume fields.

Capability parity with the reference's ``openfoam_loader.py`` (classes
``OpenFOAMLoader.read_points/read_owner_neighbour/read_faces/read_boundary/
read_scalar_field/read_vector_field/load_fields``) with two deliberate fixes
required by SURVEY.md §2:

* quirk 1 — the FoamFile header is stripped before tokenizing, so
  owner/neighbour parse to their true values (24,170 internal faces,
  12,225 cells on the bundled BFS case) instead of header-shifted garbage;
* quirk 2 — ``internalField uniform <v>`` is supported and expanded to
  ``n_cells`` entries instead of being warn-skipped, so time dir ``0`` is a
  usable snapshot.

Host-side numpy only; no JAX imports here.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from .tokenizer import (
    parse_face_list_fast,
    parse_label_list,
    parse_scalar_list,
    parse_vector_list,
    strip_header,
)

DEFAULT_FIELDS = ("U", "p", "k", "epsilon", "nut")

_DICT_OPEN = re.compile(r'("[^"]+"|[A-Za-z_][\w.\-]*)\s*\{')
_KEYVAL = re.compile(r"(\w+)\s+([^;{}]+);")


def iter_foam_dicts(body: str):
    """Yield ``(name, inner)`` for each top-level ``name { ... }`` entry.

    Brace-balance-aware: an entry may contain nested ``{}`` sub-dictionaries
    (real-world polyMesh ``boundary`` files — e.g. coupled/processor patches
    — do), which the reference's flat regex (``openfoam_loader.py:94-112``,
    ``[^{}]*``) cannot parse.  ``inner`` spans to the *matching* close brace.
    """
    for name, inner, _, _ in _iter_dict_spans(body):
        yield name, inner


def _iter_dict_spans(body: str):
    """Like :func:`iter_foam_dicts` but also yields (start, end) char spans."""
    i = 0
    n = len(body)
    while True:
        m = _DICT_OPEN.search(body, i)
        if m is None:
            return
        depth, j = 1, m.end()
        while j < n and depth:
            c = body[j]
            if c == "{":
                depth += 1
            elif c == "}":
                depth -= 1
            j += 1
        if depth:  # unbalanced trailing entry: ignore, like a truncated file
            return
        yield m.group(1).strip('"'), body[m.end(): j - 1], m.start(), j
        i = j


def parse_foam_dict(text: str) -> tuple[dict[str, str], dict[str, dict]]:
    """Split a dictionary body into flat ``key value;`` entries + sub-dicts.

    Returns ``(keyvals, subdicts)``: ``keyvals`` holds the body's own
    ``key value;`` entries (nested blocks excluded), ``subdicts`` maps each
    nested dictionary name to its recursively parsed keyvals, with deeper
    levels flattened as ``outer.inner`` keys.
    """
    subdicts: dict[str, dict] = {}
    flat_parts: list[str] = []
    pos = 0
    for name, inner, start, end in _iter_dict_spans(text):
        flat_parts.append(text[pos:start])
        kv, sub = parse_foam_dict(inner)
        kv.update({f"{k}.{k2}": v for k, s in sub.items()
                   for k2, v in s.items()})
        subdicts[name] = kv
        pos = end
    flat_parts.append(text[pos:])
    kv = dict(_KEYVAL.findall("".join(flat_parts)))
    return kv, subdicts


@dataclass
class BoundaryPatch:
    name: str
    type: str
    n_faces: int
    start_face: int
    in_groups: str | None = None


@dataclass
class FoamMesh:
    """Parsed polyMesh with derived geometry.

    ``n_cells`` here is the *true* cell count (``max(owner, neighbour) + 1``
    after correct parsing), matching the note line in the ``owner`` header.
    """

    points: np.ndarray          # [n_points, 3] float64
    face_offsets: np.ndarray    # [n_faces + 1] int32 CSR offsets into face_points
    face_points: np.ndarray     # [sum face sizes] int32
    owner: np.ndarray           # [n_faces] int32
    neighbour: np.ndarray       # [n_internal_faces] int32
    boundaries: dict[str, BoundaryPatch]
    cell_centers: np.ndarray = field(default=None)  # [n_cells, 3]
    internal_mask: np.ndarray = field(default=None)  # [n_cells] bool

    @property
    def n_points(self) -> int:
        return len(self.points)

    @property
    def n_faces(self) -> int:
        return len(self.owner)

    @property
    def n_internal_faces(self) -> int:
        return len(self.neighbour)

    @property
    def n_cells(self) -> int:
        return len(self.cell_centers)

    @property
    def n_internal_cells(self) -> int:
        return int(self.internal_mask.sum())


class FoamCase:
    """Reader for one OpenFOAM case directory (``constant/polyMesh`` + time dirs)."""

    def __init__(self, case_path: str | Path):
        self.case_path = Path(case_path)
        self.mesh_path = self.case_path / "constant" / "polyMesh"

    # ------------------------------------------------------------------ mesh
    def _read_body(self, path: Path) -> str:
        return strip_header(path.read_text())

    def read_points(self) -> np.ndarray:
        return parse_vector_list(self._read_body(self.mesh_path / "points"))

    def read_owner_neighbour(self) -> tuple[np.ndarray, np.ndarray]:
        owner = parse_label_list(self._read_body(self.mesh_path / "owner"))
        neighbour = parse_label_list(self._read_body(self.mesh_path / "neighbour"))
        return owner, neighbour

    def read_faces(self) -> tuple[np.ndarray, np.ndarray]:
        return parse_face_list_fast(self._read_body(self.mesh_path / "faces"))

    def read_boundary(self) -> dict[str, BoundaryPatch]:
        body = self._read_body(self.mesh_path / "boundary")
        patches: dict[str, BoundaryPatch] = {}
        # brace-balance-aware walk: a patch entry may contain nested {}
        # sub-dictionaries (processor/cyclic transforms); the flat keyvals
        # of the patch itself are what BoundaryPatch needs
        _, entries = parse_foam_dict(body)
        for name, kv in entries.items():
            if "nFaces" not in kv or "startFace" not in kv:
                continue
            patches[name] = BoundaryPatch(
                name=name,
                type=kv.get("type", "patch").strip(),
                n_faces=int(kv["nFaces"]),
                start_face=int(kv["startFace"]),
                in_groups=kv.get("inGroups"),
            )
        return patches

    def load_mesh(self) -> FoamMesh:
        points = self.read_points()
        owner, neighbour = self.read_owner_neighbour()
        face_offsets, face_points = self.read_faces()
        boundaries = self.read_boundary()
        mesh = FoamMesh(
            points=points,
            face_offsets=face_offsets,
            face_points=face_points,
            owner=owner,
            neighbour=neighbour,
            boundaries=boundaries,
        )
        mesh.cell_centers = compute_cell_centers(mesh)
        mesh.internal_mask = compute_internal_mask(mesh)
        return mesh

    # ---------------------------------------------------------------- fields
    def _field_body(self, time_dir: str, name: str) -> str:
        path = self.case_path / str(time_dir) / name
        if not path.exists():
            raise FileNotFoundError(f"field file not found: {path}")
        return strip_header(path.read_text())

    def read_scalar_field(
        self, time_dir: str, name: str, n_cells: int | None = None
    ) -> np.ndarray:
        """Read a volScalarField internalField; uniform fields expand to n_cells."""
        body = self._field_body(time_dir, name)
        m = re.search(r"internalField\s+nonuniform\s+List<scalar>", body)
        if m:
            return parse_scalar_list(body[m.end():])
        m = re.search(r"internalField\s+uniform\s+([-\d.eE+]+)\s*;", body)
        if m:
            if n_cells is None:
                raise ValueError(
                    f"uniform field {name}@{time_dir} needs n_cells to expand"
                )
            return np.full(n_cells, float(m.group(1)), dtype=np.float64)
        raise ValueError(f"could not find internalField in {name}@{time_dir}")

    def read_vector_field(
        self, time_dir: str, name: str, n_cells: int | None = None
    ) -> np.ndarray:
        body = self._field_body(time_dir, name)
        m = re.search(r"internalField\s+nonuniform\s+List<vector>", body)
        if m:
            return parse_vector_list(body[m.end():])
        m = re.search(
            r"internalField\s+uniform\s+\(([-\d.eE+\s]+)\)\s*;", body
        )
        if m:
            if n_cells is None:
                raise ValueError(
                    f"uniform field {name}@{time_dir} needs n_cells to expand"
                )
            vec = np.array([float(x) for x in m.group(1).split()], dtype=np.float64)
            return np.tile(vec, (n_cells, 1))
        raise ValueError(f"could not find internalField in {name}@{time_dir}")

    def load_fields(
        self,
        time_dir: str,
        fields: tuple[str, ...] = DEFAULT_FIELDS,
        n_cells: int | None = None,
        strict: bool = False,
    ) -> dict[str, np.ndarray]:
        """Load a snapshot's fields; mirrors ``openfoam_loader.py:271-296``.

        ``strict=False`` preserves the reference's warn-and-skip contract for
        missing/broken files; ``strict=True`` raises instead.
        """
        out: dict[str, np.ndarray] = {}
        for name in fields:
            try:
                if name == "U":
                    out[name] = self.read_vector_field(time_dir, name, n_cells)
                else:
                    out[name] = self.read_scalar_field(time_dir, name, n_cells)
            except (FileNotFoundError, ValueError):
                if strict:
                    raise
                print(f"Warning: could not load field {name}@{time_dir}; skipping")
        return out

    def available_time_dirs(self) -> list[str]:
        """Numeric time directories of the case, sorted by value."""
        dirs = []
        for p in self.case_path.iterdir():
            if p.is_dir():
                try:
                    float(p.name)
                except ValueError:
                    continue
                dirs.append(p.name)
        return sorted(dirs, key=float)


def compute_cell_centers(mesh: FoamMesh) -> np.ndarray:
    """Cell centers as centroid of each cell's unique vertices (vectorized).

    Semantics match ``openfoam_loader.py:191-227`` (centroid over the set of
    unique points of the cell's faces) but run as segment means over deduped
    (cell, point) incidence pairs instead of a Python loop over 49k faces.
    """
    n_cells = int(max(mesh.owner.max(), mesh.neighbour.max())) + 1
    sizes = np.diff(mesh.face_offsets).astype(np.int64)
    n_internal = len(mesh.neighbour)

    owner_cells = np.repeat(mesh.owner.astype(np.int64), sizes)
    nbr_cells = np.repeat(mesh.neighbour.astype(np.int64), sizes[:n_internal])
    nbr_points = mesh.face_points[: mesh.face_offsets[n_internal]]

    cells = np.concatenate([owner_cells, nbr_cells])
    pts = np.concatenate([mesh.face_points.astype(np.int64), nbr_points.astype(np.int64)])

    # Deduplicate (cell, point) incidences so each unique vertex counts once.
    keys = cells * mesh.n_points + pts
    uniq = np.unique(keys)
    ucells = uniq // mesh.n_points
    upts = uniq % mesh.n_points

    centers = np.zeros((n_cells, 3), dtype=np.float64)
    np.add.at(centers, ucells, mesh.points[upts])
    counts = np.bincount(ucells, minlength=n_cells).astype(np.float64)
    counts = np.maximum(counts, 1.0)
    return centers / counts[:, None]


def compute_internal_mask(mesh: FoamMesh) -> np.ndarray:
    """Cells touching at least one internal face (``openfoam_loader.py:229-248``)."""
    n_cells = int(max(mesh.owner.max(), mesh.neighbour.max())) + 1
    mask = np.zeros(n_cells, dtype=bool)
    n_internal = len(mesh.neighbour)
    mask[mesh.neighbour] = True
    mask[mesh.owner[:n_internal]] = True
    return mask
