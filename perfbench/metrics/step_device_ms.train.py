"""Device-busy milliseconds a training step in the traced window (the
union of the profiler's device events, over the window's steps; the
epochs' eval steps, block ends and saves included)."""

from perfbench.core.readings import traced


def read(rec):
    t = traced(rec, "train")
    if t is None or not rec["window"]["steps"]:
        return None
    return 1e3 * t["busy_s"] / rec["window"]["steps"]
