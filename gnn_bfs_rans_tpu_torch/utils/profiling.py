"""Profiling and debugging aids.

Counterpart of ``gnn_bfs_rans_tpu/utils/profiling.py``:

* ``trace`` — context manager around ``torch.profiler`` writing a
  TensorBoard trace directory;
* ``enable_nan_checks`` — autograd anomaly detection with NaN checks;
* ``log_compile_times`` — logs each ``nvcc`` build's seconds;
* ``device_memory_stats`` — the caching allocator's statistics per card.
"""

from __future__ import annotations

import contextlib
import logging
import tempfile
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile a block: ``with trace('dir'): step()`` → a TensorBoard trace
    (CPU and, with a card, CUDA activities) in ``log_dir`` (default: a
    ``torch-trace`` directory in the temporary directory)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if log_dir is None:
        log_dir = Path(tempfile.gettempdir()) / "torch-trace"
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))):
        yield


def enable_nan_checks(enable: bool = True) -> None:
    """Autograd anomaly detection with ``check_nan``: a backward function
    that returns a NaN raises, naming the forward op that made it.  This
    checks the backward only, where the JAX package's ``jax_debug_nans``
    checks every op."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


def log_compile_times(enable: bool = True) -> None:
    """Log each ``nvcc`` build's seconds (``kernels/_build.py``) to stderr."""
    from ..kernels import _build

    _build.LOG.setLevel(logging.INFO if enable else logging.WARNING)
    if enable and not _build.LOG.handlers:
        _build.LOG.addHandler(logging.StreamHandler())


def device_memory_stats() -> dict:
    """``torch.cuda.memory_stats`` (bytes and counts) per visible card, or
    ``{"cpu": None}`` without one."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
