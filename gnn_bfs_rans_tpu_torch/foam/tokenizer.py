"""FoamFile-aware tokenization for OpenFOAM ASCII dictionaries and lists.

The reference parser (its ``openfoam_loader.py:48-70``) tokenizes the
*whole* file with a regex and therefore ingests integers from the FoamFile
header block (version numbers, the ``nPoints:...`` note), shifting the
owner/neighbour arrays by 9 entries (SURVEY.md §2, quirk 1).  This module does
it correctly: the banner comment, ``//`` line comments and the
``FoamFile { ... }`` dictionary are stripped *before* any numeric
tokenization, so list data always starts at the real ``<count> ( ... )`` body.

Everything here is host-side numpy, but for faceLists of mixed face sizes,
which go through the native C++ walk (``native/``) when it builds; it runs
once per case and the result is moved to the device a single time (the graph
is static across training steps).
"""

from __future__ import annotations

import re

import numpy as np

_BLOCK_COMMENT = re.compile(r"/\*.*?\*/", re.DOTALL)
_LINE_COMMENT = re.compile(r"//[^\n]*")
_FOAMFILE_DICT = re.compile(r"FoamFile\s*\{[^}]*\}", re.DOTALL)


def strip_header(content: str) -> str:
    """Remove banner comments, ``//`` comments and the FoamFile dictionary.

    Returns the body that contains only the payload (counts, parenthesised
    lists, and any remaining sub-dictionaries such as ``boundaryField``).
    """
    content = _BLOCK_COMMENT.sub(" ", content)
    content = _FOAMFILE_DICT.sub(" ", content)
    content = _LINE_COMMENT.sub(" ", content)
    return content


def _to_numeric_text(body: str) -> str:
    """Replace list punctuation with spaces so numpy can bulk-parse tokens.

    Truncates at the first ``;`` (the list terminator) so trailing
    dictionaries like ``boundaryField`` never reach the numeric parser.
    """
    end = body.find(";")
    if end != -1:
        body = body[:end]
    return body.translate(str.maketrans("()", "  "))


def parse_scalar_list(body: str, dtype=np.float64) -> np.ndarray:
    """Parse ``N ( v0 v1 ... vN-1 )`` after the header has been stripped.

    The first numeric token is the declared count; exactly that many values
    are returned (trailing garbage such as a following ``boundaryField`` is
    ignored because parsing stops at the closing paren of the list).
    """
    m = re.search(r"(\d+)\s*\(", body)
    if m is None:
        raise ValueError("could not locate list count before '('")
    n = int(m.group(1))
    start = m.end()
    values = np.fromstring(_to_numeric_text(body[start:]), dtype=np.float64, sep=" ")
    if values.size < n:
        raise ValueError(f"list declared {n} entries but only {values.size} parsed")
    return values[:n].astype(dtype)


def parse_vector_list(body: str, width: int = 3, dtype=np.float64) -> np.ndarray:
    """Parse ``N ( (x y z) (x y z) ... )`` into an ``[N, width]`` array."""
    m = re.search(r"(\d+)\s*\(", body)
    if m is None:
        raise ValueError("could not locate vector list count before '('")
    n = int(m.group(1))
    start = m.end()
    values = np.fromstring(_to_numeric_text(body[start:]), dtype=np.float64, sep=" ")
    if values.size < n * width:
        raise ValueError(
            f"vector list declared {n}x{width} entries but only {values.size} parsed"
        )
    return values[: n * width].reshape(n, width).astype(dtype)


def parse_label_list(body: str) -> np.ndarray:
    """Parse an integer labelList body (owner / neighbour files)."""
    return parse_scalar_list(body, dtype=np.int32)


def parse_face_list(body: str) -> tuple[np.ndarray, np.ndarray]:
    """Parse a faceList ``N ( k(p0 .. pk-1) ... )`` into CSR form.

    Returns ``(face_offsets [N+1], face_points [sum k])`` — a compressed
    representation that keeps everything vectorizable (the reference keeps a
    ragged object array, ``openfoam_loader.py:72-92``).
    """
    m = re.search(r"(\d+)\s*\(", body)
    if m is None:
        raise ValueError("could not locate face list count before '('")
    n_faces = int(m.group(1))
    start = m.end()
    flat = np.fromstring(_to_numeric_text(body[start:]), dtype=np.int64, sep=" ")
    # Walk the [count, p0..pk-1]* layout with a cursor; counts for quad-dominant
    # meshes are tiny so group by count value to stay vectorized.
    offsets = np.zeros(n_faces + 1, dtype=np.int64)
    points: list[np.ndarray] = []
    cursor = 0
    for i in range(n_faces):
        k = int(flat[cursor])
        offsets[i + 1] = offsets[i] + k
        points.append(flat[cursor + 1 : cursor + 1 + k])
        cursor += 1 + k
    face_points = (
        np.concatenate(points) if points else np.zeros(0, dtype=np.int64)
    )
    return offsets.astype(np.int32), face_points.astype(np.int32)


def parse_face_list_fast(body: str) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized faceList parser for uniform-ish meshes.

    Works for any mix of face sizes by solving the cursor positions with a
    fixed-point iteration over the flat token stream: position of face ``i+1``
    is ``pos[i] + flat[pos[i]] + 1``.  For meshes where all faces have the
    same vertex count (the common blockMesh case) a single reshape suffices.
    """
    m = re.search(r"(\d+)\s*\(", body)
    if m is None:
        raise ValueError("could not locate face list count before '('")
    n_faces = int(m.group(1))
    start = m.end()
    flat = np.fromstring(_to_numeric_text(body[start:]), dtype=np.int64, sep=" ")
    if n_faces == 0:
        return np.zeros(1, dtype=np.int32), np.zeros(0, dtype=np.int32)
    k0 = int(flat[0])
    # Uniform fast path: counts appear every (k0+1) tokens and all equal k0.
    if flat.size >= n_faces * (k0 + 1):
        block = flat[: n_faces * (k0 + 1)].reshape(n_faces, k0 + 1)
        if np.all(block[:, 0] == k0):
            offsets = np.arange(n_faces + 1, dtype=np.int32) * k0
            return offsets, block[:, 1:].reshape(-1).astype(np.int32)
    # Mixed-size faces: the native C++ walk, else the numpy cursor walk
    from .. import native

    max_points = int(flat.size)  # tokens bound the point count
    result = native.parse_faces(body[start:], n_faces, max_points)
    if result is not None:
        return result
    return parse_face_list(body)
