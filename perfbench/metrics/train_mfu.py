"""The traced training window's model FLOPs (each step's
``model_flops``, each epoch's eval forward) over the traced
window's length (the profiler's, its overhead included) and the card's
dense peak in the configuration's compute dtype (bf16, or f32 without
the tensor cores), %."""

from perfbench.core.readings import mfu


def read(rec):
    return mfu(rec, "train")
