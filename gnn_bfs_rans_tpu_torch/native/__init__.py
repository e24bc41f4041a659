"""Native (C++) host code, loaded with ``ctypes``: the OpenFOAM ASCII
tokenizers of ``foam_parse.cpp``.

The port's own copy of ``gnn_bfs_rans_tpu/native/``, with the same
functions: :func:`parse_faces`, :func:`parse_doubles` and
:func:`parse_labels`.  The library is built with the system ``g++``
(``-O3 -shared -fPIC``) at first use into
``gnn_bfs_rans_tpu_torch/build/libfoamparse.so`` (listed in
``.gitignore``, never next to the source) and rebuilt when the source is
newer, as ``kernels/_build.py`` builds the CUDA sources.  Where it cannot
be built or loaded each function returns None and ``foam/tokenizer.py``
keeps its numpy walk, as the JAX package does; the failure is logged once
at WARNING on the ``gnn_bfs_rans_tpu_torch.native`` logger.  This is host
code: no device or kernel lies behind that fallback.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "foam_parse.cpp"
BUILD_DIR = SRC.parent.parent / "build"
LIB = BUILD_DIR / "libfoamparse.so"
LOG = logging.getLogger("gnn_bfs_rans_tpu_torch.native")

_lock = threading.Lock()
_state: dict = {}


def _build() -> None:
    """Compile the library to a private name, then rename it into place:
    a concurrent build never loads a half-written file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp,
                        str(SRC)], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, LIB)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> ctypes.CDLL:
    if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
        _build()
    lib = ctypes.CDLL(str(LIB))
    lib.foam_parse_doubles.restype = ctypes.c_int64
    lib.foam_parse_doubles.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    lib.foam_parse_labels.restype = ctypes.c_int64
    lib.foam_parse_labels.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64]
    lib.foam_parse_faces.restype = ctypes.c_int64
    lib.foam_parse_faces.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64]
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built on first use; None (logged once) if it
    cannot be built or loaded."""
    with _lock:
        if "lib" not in _state:
            try:
                _state["lib"] = _load()
            except (OSError, subprocess.SubprocessError) as e:
                detail = getattr(e, "stderr", b"") or b""
                LOG.warning("native tokenizer unavailable (%s%s): the "
                            "numpy walk parses mixed-size faces", e,
                            f"; {detail.decode(errors='replace')[-500:]}"
                            if detail else "")
                _state["lib"] = None
        return _state["lib"]


def available() -> bool:
    return get_lib() is not None


def parse_doubles(text: str, max_out: int) -> np.ndarray | None:
    """Up to ``max_out`` numbers of ``text`` (parentheses separate them)."""
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode()
    out = np.empty(max_out, dtype=np.float64)
    n = lib.foam_parse_doubles(
        raw, len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), max_out)
    return out[:n]


def parse_labels(text: str, max_out: int) -> np.ndarray | None:
    """Up to ``max_out`` int32 labels of ``text``."""
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode()
    out = np.empty(max_out, dtype=np.int32)
    n = lib.foam_parse_labels(
        raw, len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_out)
    return out[:n]


def parse_faces(text: str, n_faces: int, max_points: int
                ) -> tuple[np.ndarray, np.ndarray] | None:
    """A faceList body ``k(p0 .. pk-1) ...`` as CSR ``(offsets [n_faces +
    1], points)`` int32; None when the library is unavailable, the points
    overflow ``max_points`` or fewer than ``n_faces`` faces are found (the
    caller then walks the list in numpy)."""
    lib = get_lib()
    if lib is None:
        return None
    raw = text.encode()
    offsets = np.zeros(n_faces + 1, dtype=np.int32)
    points = np.empty(max_points, dtype=np.int32)
    n = lib.foam_parse_faces(
        raw, len(raw), n_faces,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_points)
    if n < n_faces:        # -1: the points buffer overflowed
        return None
    return offsets, points[: offsets[n_faces]]
