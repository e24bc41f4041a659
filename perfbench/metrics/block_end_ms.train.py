"""Host milliseconds of a block's end in the window, a mean over its
blocks: from the end of the program's ``trainer.sync`` (the host's wait
for the card) to the end of its ``trainer.block``: the history rows, the
``best`` and ``epoch_N`` checkpoints and the log line.  The card has no
work of the trainer's then but the saves' own."""

from perfbench.core import spans


def read(rec):
    w = spans.window()
    if w is None:
        return None
    ends = []
    for block in w.named("trainer.block"):
        sync = w.child(block, "trainer.sync")
        if sync is None:
            return None
        ends.append((block.end_ns - sync.end_ns) * 1e-6)
    return sum(ends) / len(ends) if ends else None
