"""Profiling and debugging aids.

Counterpart of ``gnn_bfs_rans_tpu/utils/profiling.py`` but for its
TensorBoard ``trace``: the program's spans and counters and the per-op
device trace are ``utils/trace.py``'s.

* ``enable_nan_checks`` — autograd anomaly detection with NaN checks;
* ``log_compile_times`` — logs each ``nvcc`` build's seconds;
* ``device_memory_stats`` — the caching allocator's statistics per card.
"""

from __future__ import annotations

import logging

import torch


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
