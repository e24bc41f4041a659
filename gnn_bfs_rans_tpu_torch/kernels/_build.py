"""Build and load the hand-written CUDA kernels; count kernel launches.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into
``gnn_bfs_rans_tpu_torch/build/lib<name>.so`` (listed in ``.gitignore``)
at first use, and loads with ``ctypes``: the sources expose a plain C
interface, so no PyTorch header is compiled.  A library is rebuilt when
its source is newer.  A failed build raises.

``LAUNCHES`` counts launches per kernel wrapper, added only where the
wrapper launches on the card (never for the plain CPU version): one count
per ``pallas_call`` site of the TPU kernel it replaces (so two per call of
``fused_epilogue_bwd``, whose one launch replaces two), or per call for
``transformer_project`` (XLA products in the JAX package).

Each build's ``nvcc`` seconds are logged at INFO on the
``gnn_bfs_rans_tpu_torch.kernels.build`` logger
(``utils/profiling.py::log_compile_times`` shows them).
"""

from __future__ import annotations

import collections
import ctypes
import logging
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: collections.Counter = collections.Counter()
LOG = logging.getLogger("gnn_bfs_rans_tpu_torch.kernels.build")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): cannot build "
                       "the CUDA kernels")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless an up-to-date library exists.

    The compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside the library as ``lib<name>.log``.
    """
    src = SRC_DIR / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}.so"
    deps = [src, *SRC_DIR.glob("*.cuh")]
    if out.exists() and out.stat().st_mtime >= max(p.stat().st_mtime
                                                   for p in deps):
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name, then rename: a concurrent build never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    LOG.info("nvcc %s: %.1f s", src.name, time.perf_counter() - t0)
    (BUILD_DIR / f"lib{name}.log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, Path]:
    """Compile every ``csrc/*.cu`` in parallel (one nvcc per source)."""
    names = sorted(p.stem for p in SRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        paths = list(pool.map(build, names))
    return dict(zip(names, paths))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            # every source exports this beside its launchers
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def bind(name: str, fn_name: str, argtypes: list) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with launcher ``fn_name``'s C
    signature set (it returns a CUDA error code)."""
    lib = load(name)
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
