"""The share of the traced training window in which no device event
ran, %."""

from perfbench.core.readings import idle_share


def read(rec):
    return idle_share(rec, "train")
