"""Device milliseconds an epoch in the window: the card's time over each
block's replays (the program's ``trainer.enqueue`` spans, timed by CUDA
events) over the window's epochs.  Less three steps' device-busy time
(``step_device_ms.train``), the gaps between kernels inside the replayed
epoch graph.  None off the card."""

from perfbench.core import spans


def read(rec):
    w = spans.window()
    if w is None:
        return None
    blocks, queued = w.named("trainer.block"), w.named("trainer.enqueue")
    if not blocks or not queued or any(s.device_ms is None for s in queued):
        return None
    epochs = sum(b.attrs["last"] - b.attrs["first"] + 1 for b in blocks)
    return sum(s.device_ms for s in queued) / epochs
