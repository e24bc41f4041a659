"""GCN (PyG ``GCNConv``, Kipf & Welling) in the FlowGNN skeleton.

``D^-½ (A + I) D^-½ · x·Wᵀ + b``: the product has no bias; each receiver
sums its senders' rows with the weight ``1/√(deĝ_r · deĝ_s)`` and its own
with ``1/deĝ_r``, deĝ being the in-degree plus the self-loop; the bias
follows the sum.  The conv has no dropout and draws no seed.
"""

from __future__ import annotations

import torch

from . import _flowgnn
from ..model import Aggregate
from ...yardstick.weights import Leaf


def _conv_leaves(cfg, p):
    h = cfg["hidden_dim"]
    return [*_flowgnn.lin(f"{p}.lin", h, h, bias=False),
            Leaf(f"{p}.bias", (h,), "uniform", h)]


def param_shapes(cfg: dict) -> list[Leaf]:
    return _flowgnn.param_shapes(cfg, _conv_leaves)


class Forward(_flowgnn.Forward):
    def __init__(self, cfg: dict, graph, quant: str = "f32"):
        super().__init__(cfg, graph, quant)
        s, r = graph.senders, graph.receivers
        deg = 1.0 + torch.bincount(r, minlength=graph.n).float()
        inv = deg.rsqrt()
        # each receiver's senders and itself
        ar = torch.arange(graph.n, device=s.device)
        self.s = torch.cat([s, ar])
        self.r = torch.cat([r, ar])
        self.coef = torch.cat([inv[r] * inv[s], inv * inv])[:, None]

    def conv(self, p, name, x, rate, gen):
        h = self.linear(p, f"{name}.lin", x, bias=False)
        out = Aggregate.apply(self.coef, self.q(h)[:, None, :], self.s,
                              self.r, self.g.n)
        return out[:, 0] + p[f"{name}.bias"]


model_flops = _flowgnn.model_flops


def _conv_ops(cfg, n, e):
    h = cfg["hidden_dim"]
    # the projection, then the aggregation over the edges and self-loops
    fl = _flowgnn.mm(n, h, h) + 2.0 * (e + n) * h
    return h * h + h, fl, 4.0 * e


def step_ops(cfg: dict, n_nodes: int, n_edges: int, train: bool):
    return _flowgnn.step_ops(cfg, n_nodes, n_edges, train, _conv_ops)
