"""GAT (PyG ``GATConv``, heads averaged, ``concat=False``) in the FlowGNN
skeleton.

``z = x·Wᵀ``; logits ``LeakyReLU_0.2(a_dst·z_i + a_src·z_j)`` over each
receiver's senders and itself; softmax; attention dropout (the conv's
stream, a seed drawn before the conv); ``mean_h Σ_j α z_j`` + bias.
"""

from __future__ import annotations

import torch

from . import _flowgnn
from .. import stream
from ..model import Aggregate, softmax
from ...yardstick.weights import Leaf


def _conv_leaves(cfg, p):
    h, heads = cfg["hidden_dim"], cfg["heads"]
    return [*_flowgnn.lin(f"{p}.lin", h, heads * h, bias=False),
            Leaf(f"{p}.att_src", (1, heads, h), "uniform", heads),
            Leaf(f"{p}.att_dst", (1, heads, h), "uniform", heads),
            Leaf(f"{p}.bias", (h,), "uniform", h)]


def param_shapes(cfg: dict) -> list[Leaf]:
    return _flowgnn.param_shapes(cfg, _conv_leaves)


class Forward(_flowgnn.Forward):
    def __init__(self, cfg: dict, graph, quant: str = "f32"):
        super().__init__(cfg, graph, quant)
        # each receiver's senders and itself
        ar = torch.arange(graph.n, device=graph.senders.device)
        self.s = torch.cat([graph.senders, ar])
        self.r = torch.cat([graph.receivers, ar])
        self.cols = torch.cat([graph.col, graph.self_col])

    def conv(self, p, name, x, rate, gen):
        g, q = self.g, self.q
        seed = stream.draw_seed(gen, x.device) if rate > 0 else None
        heads, c = self.cfg["heads"], self.cfg["hidden_dim"]
        z = self.linear(p, f"{name}.lin", x, bias=False).view(-1, heads, c)
        a_src = (z * p[f"{name}.att_src"]).sum(-1)
        a_dst = (z * p[f"{name}.att_dst"]).sum(-1)
        logit = torch.nn.functional.leaky_relu(a_dst[self.r] + a_src[self.s],
                                               0.2)
        alpha = softmax(logit, self.r, g.n)
        if rate > 0:
            k = stream.gat_attention_keep(seed, self.r, self.cols, heads,
                                          g.width, rate, 128)
            alpha = torch.where(k, alpha / (1.0 - rate), 0.0)
        out = Aggregate.apply(alpha, q(z), self.s, self.r, g.n)
        return out.mean(1) + p[f"{name}.bias"]


model_flops = _flowgnn.model_flops


def _conv_ops(cfg, n, e):
    h, hd, c = cfg["hidden_dim"], cfg["heads"], cfg["hidden_dim"]
    hc = hd * c
    mm = _flowgnn.mm
    w_count = h * hc + 2 * hc + h
    fl = mm(n, h, hc) + mm(n, hc, 2 * hd) + 2.0 * (e + n) * hc
    return w_count, fl, 4.0 * e


def step_ops(cfg: dict, n_nodes: int, n_edges: int, train: bool):
    return _flowgnn.step_ops(cfg, n_nodes, n_edges, train, _conv_ops)
