"""The traced training window's model FLOPs (each step's
``train_matmul_flops``, each epoch's eval forward) over the traced
window's length (the profiler's, its overhead included) and the card's
dense bf16 peak, %."""

from perfbench.core.readings import mfu


def read(rec):
    return mfu(rec, "train")
