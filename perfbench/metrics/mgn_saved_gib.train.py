"""GiB that MeshGraphNets' processor keeps for the backward: the
program's ``mgn.saved_bytes`` count over its last training ``mgn.forward``
span (the epoch graph's capture: each storage once, counted as autograd
saves it)."""

import importlib


def read(rec):
    try:
        trace = importlib.import_module("gnn_bfs_rans_tpu_torch.utils.trace")
    except ImportError:
        return None
    if not hasattr(trace, "records"):
        return None
    last = max((s for s in trace.records()
                if s.name == "mgn.forward" and s.attrs.get("train")),
               key=lambda s: s.id, default=None)
    if last is None or not last.counters:
        return None
    saved = last.counters.get("mgn.saved_bytes")
    return None if saved is None else saved / 2 ** 30
