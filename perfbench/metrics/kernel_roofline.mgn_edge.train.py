"""The least time of the traced window's ``mgn_edge`` and
``mgn_edge_bwd`` operations (``yardstick/flops.py::step_ops``: each
operation's FLOPs at the compute dtype's peak or its bytes at the HBM
bandwidth, the larger; the steps' and the epochs' eval forwards), over
the device time of the kernels whose names contain ``mgn_edge``, %."""

from perfbench.core.readings import traced, work
from perfbench.yardstick import flops

OPS = ("mgn_edge", "mgn_edge_bwd")


def read(rec):
    t = traced(rec, "train")
    if t is None or rec["peaks"] is None:
        return None
    busy = sum(s for name, s in t["ops"].items() if "mgn_edge" in name)
    if busy <= 0:
        return None
    least = sum(k * flops.least_seconds([o for o in ops if o[0] in OPS],
                                        *rec["peaks"])
                for k, ops, _ in work(rec))
    return 100.0 * least / busy
