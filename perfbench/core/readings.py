"""Arithmetic shared by the metric readers (``perfbench/metrics/``).

A reader gets ``rec``: ``setup_s``; ``window`` (the driver's records:
a training window's ``blocks``, ``cells``, ``seconds`` (host clock),
``epochs`` and ``steps``); ``trace`` (``busy_s``, ``window_s``, ``ops``,
``idle``; None without ``--trace 1``); ``memory_peak_bytes`` (the
run's device peak);
``config``, ``traffic``, ``graph`` (``n_nodes``, ``n_edges``);
``device_name`` and ``peaks`` (FLOP/s in the configuration's compute
dtype, bytes/s; None off the H100).
"""

from __future__ import annotations

from ..yardstick import flops


def traced(rec: dict, kind: str) -> dict | None:
    t = rec["trace"]
    if t is None or rec["window"].get("kind") != kind or t["busy_s"] <= 0:
        return None
    return t


def idle_share(rec: dict, kind: str) -> float | None:
    t = traced(rec, kind)
    return None if t is None else 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def work(rec: dict) -> list[tuple[int, list, float]]:
    """The traced window's work as (count, operations, model FLOPs) of
    each unit: a training window's steps and its epochs' eval steps."""
    cfg, g, w = rec["config"], rec["graph"], rec["window"]
    n, e = g["n_nodes"], g["n_edges"]
    return [(w["steps"], flops.step_ops(cfg, n, e, True),
             flops.model_flops(cfg, n, e, True)),
            (w["epochs"], flops.step_ops(cfg, n, e, False),
             flops.model_flops(cfg, n, e, False))]


def mfu(rec: dict, kind: str) -> float | None:
    t = traced(rec, kind)
    if t is None or rec["peaks"] is None:
        return None
    fl = sum(k * f for k, _, f in work(rec))
    return 100.0 * fl / t["window_s"] / rec["peaks"][0]


def kernel_roofline(rec: dict, kind: str) -> float | None:
    t = traced(rec, kind)
    if t is None or rec["peaks"] is None:
        return None
    least = sum(k * flops.least_seconds(ops, *rec["peaks"])
                for k, ops, _ in work(rec))
    return 100.0 * least / t["busy_s"]
