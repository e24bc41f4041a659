"""The architectures the benchmark knows: one module each, found by name.

A configuration's ``layer_type`` names its module, lower-cased, in this
package (``GAT`` → ``gat.py``); adding an architecture is adding its
file.  A module gives:

* ``param_shapes(cfg)`` → ``[yardstick.weights.Leaf]``: every parameter
  and buffer under the names of the port's ``state_dict``, in the order
  of the weights' one draw;
* ``Forward(cfg, graph, quant)``, called as ``(p, stats, x, mode, gen)``
  → [n, 7]: the plain forward in float32 (``quant``: the precision of
  :func:`..model.quantizer` and :func:`..model.products`; ``mode``:
  ``train``, ``exact`` or ``eval``; ``gen`` the training generator);
* ``model_flops(cfg, n_nodes, n_edges, train)``: the model's matmul
  FLOPs of a forward, or of a training step;
* ``step_ops(cfg, n_nodes, n_edges, train)``: ``(operation, FLOPs,
  bytes)`` of one eval or training step (``yardstick/flops.py``).

Modules whose name starts with ``_`` are shared helpers, not
architectures.
"""

from __future__ import annotations

import importlib
from pathlib import Path


def load(cfg: dict):
    """The module of ``cfg['layer_type']``."""
    layer_type = cfg["layer_type"]
    name = str(layer_type).lower()
    full = f"{__name__}.{name}"
    if name.isidentifier() and not name.startswith("_"):
        try:
            return importlib.import_module(full)
        except ModuleNotFoundError as e:
            if e.name != full:
                raise
    raise ValueError(f"no architecture {layer_type!r}: looked for "
                     f"{Path(__path__[0]) / (name + '.py')}")
