"""Host seconds of the run's ``Trainer`` construction (the program's last
``trainer.init`` span: the model built on the host, moved to the card
with the graph and targets, the optimizer), a part of ``setup_s``."""

from perfbench.core import spans


def read(rec):
    init = spans.last("trainer.init")
    return None if init is None else init.ms * 1e-3
