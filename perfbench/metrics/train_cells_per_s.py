"""Training cells a second: the cells trained in the window (its blocks'
epochs × snapshots × mesh cells), over the window's time (host clock,
from the start of its call of the trainer's loop to the end of its last
block, which ends in the trainer's synchronization)."""


def read(rec):
    w = rec["window"]
    if w.get("kind") != "train" or not w["blocks"]:
        return None
    return w["cells"] / w["seconds"]
