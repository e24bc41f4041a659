"""The least time the traced training window's operations could take
on the card (each operation's FLOPs at the compute dtype's peak or its
bytes at the HBM bandwidth, the larger; ``yardstick/flops.py::step_ops``),
over the device's busy time, %."""

from perfbench.core.readings import kernel_roofline


def read(rec):
    return kernel_roofline(rec, "train")
