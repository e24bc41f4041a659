"""Host milliseconds a block in the window that the trainer waits for its
checkpoint writer: the program's ``checkpoint.wait`` spans under the
window's ``trainer.run`` (a free set of host buffers at a save, and the
writes still queued when the run ends), over the window's blocks.  None
where the program writes its checkpoints on the trainer's thread (no such
span)."""

from perfbench.core import spans


def read(rec):
    w = spans.window()
    if w is None:
        return None
    blocks, waits = w.named("trainer.block"), w.named("checkpoint.wait")
    if not blocks or not waits:
        return None
    return sum(s.ms for s in waits) / len(blocks)
