"""The run's device memory peak, GiB: ``torch.cuda.max_memory_allocated``
over set-up and window.  The eager first epoch and the captures hold the
step's whole working set; the replays in the window reuse the graphs'
pooled memory, which the allocator counts when the capture takes it."""


def read(rec):
    if rec["window"].get("kind") != "train" or not rec["memory_peak_bytes"]:
        return None
    return rec["memory_peak_bytes"] / 2 ** 30
