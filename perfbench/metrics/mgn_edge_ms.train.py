"""Device milliseconds a training step spent in the kernels whose names
contain ``mgn_edge`` (MeshGraphNets' edge block, forward and backward;
the epochs' eval forwards included), over the traced window's steps."""

from perfbench.core.readings import traced


def read(rec):
    t = traced(rec, "train")
    if t is None or not rec["window"]["steps"]:
        return None
    busy = sum(s for name, s in t["ops"].items() if "mgn_edge" in name)
    return 1e3 * busy / rec["window"]["steps"] if busy > 0 else None
