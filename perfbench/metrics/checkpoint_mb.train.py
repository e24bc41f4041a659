"""Megabytes (1e6 bytes) a checkpoint writes in the window: the program's
``checkpoint.bytes`` count over the window's ``trainer.run`` (the files'
sizes on disk) over its saves."""

from perfbench.core import spans


def read(rec):
    w = spans.window()
    saves = [] if w is None else w.named("trainer.save")
    if not saves or not w.run.counters:
        return None
    written = w.run.counters.get("checkpoint.bytes")
    return None if written is None else written / len(saves) / 1e6
