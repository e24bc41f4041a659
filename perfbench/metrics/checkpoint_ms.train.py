"""Host milliseconds of a checkpoint in the window, a mean over its saves
(the program's ``trainer.save`` spans: exact statistics, the state dict's
copy-out and write, Adam's state, the meta file)."""

from perfbench.core import spans


def read(rec):
    w = spans.window()
    saves = [] if w is None else w.named("trainer.save")
    if not saves:
        return None
    return sum(s.ms for s in saves) / len(saves)
