"""TransformerConv (PyG, ``concat=False``, ``edge_dim`` 4, root weight)
in the FlowGNN skeleton.

``q, k, v = x·Wᵀ + b``, ``e_ij = W_e·edge_ij``; logits
``q_i·(k_j + e_ij)/√C`` over the senders; softmax; attention dropout
(the conv's stream, a seed drawn before the conv); ``mean_h Σ_j α (v_j +
e_ij)`` + ``lin_skip(x)``.
"""

from __future__ import annotations

import torch

from . import _flowgnn
from .. import stream
from ..model import Aggregate, EdgeDot, softmax
from ...yardstick.weights import Leaf


def _conv_leaves(cfg, p):
    h, hc = cfg["hidden_dim"], cfg["heads"] * cfg["hidden_dim"]
    lin = _flowgnn.lin
    return [*(leaf for m in ("lin_query", "lin_key", "lin_value")
              for leaf in lin(f"{p}.{m}", h, hc)),
            *lin(f"{p}.lin_edge", cfg["edge_dim"], hc, bias=False),
            *lin(f"{p}.lin_skip", h, h)]


def param_shapes(cfg: dict) -> list[Leaf]:
    return _flowgnn.param_shapes(cfg, _conv_leaves)


class Forward(_flowgnn.Forward):
    def __init__(self, cfg: dict, graph, quant: str = "f32"):
        super().__init__(cfg, graph, quant)
        self.s, self.r, self.cols = graph.senders, graph.receivers, \
            graph.col

    def conv(self, p, name, x, rate, gen):
        g, q = self.g, self.q
        seed = stream.draw_seed(gen, x.device) if rate > 0 else None
        heads, c = self.cfg["heads"], self.cfg["hidden_dim"]
        s, r = self.s, self.r
        qq, kk, vv = (self.linear(p, f"{name}.{m}", x).view(-1, heads, c)
                      for m in ("lin_query", "lin_key", "lin_value"))
        # W_e [H, C, D]: e_ij = W_e·edge_ij per head
        w_e = p[f"{name}.lin_edge.weight"].view(heads, c, -1)
        ef = g.edge_feat
        qw = torch.einsum("nhc,hcd->nhd", q(qq), q(w_e))
        logit = (EdgeDot.apply(q(qq), q(kk), s, r)
                 + (qw[r] * ef[:, None, :]).sum(-1)) / c ** 0.5
        alpha = softmax(logit, r, g.n)
        if rate > 0:
            k = stream.transformer_attention_keep(seed, r, self.cols, heads,
                                                  g.width, rate, 128)
            alpha = torch.where(k, alpha / (1.0 - rate), 0.0)
        out = Aggregate.apply(alpha, q(vv), s, r, g.n)
        sums = torch.zeros((g.n, heads, ef.shape[1]), device=x.device)
        sums = sums.index_add(0, r, alpha[:, :, None] * ef[:, None, :])
        out = out + torch.einsum("nhd,hcd->nhc", q(sums), q(w_e))
        return out.mean(1) + self.linear(p, f"{name}.lin_skip", x)


model_flops = _flowgnn.model_flops


def _conv_ops(cfg, n, e):
    h, hd, c = cfg["hidden_dim"], cfg["heads"], cfg["hidden_dim"]
    hc = hd * c
    de = cfg["edge_dim"]
    mm = _flowgnn.mm
    w_count = 3 * (h * hc + hc) + de * hc + h * h + h
    fl = (3.0 * mm(n, h, hc) + mm(n, h, c) + 4.0 * e * hc
          + mm(n, hc, hd * de) + 2.0 * e * de * hc
          + mm(n, hd * de, c))
    # the edges' geometry: dist and 1/dist an edge, xyz a row
    return w_count, fl, 4.0 * e + 8.0 * e + 16.0 * n


def step_ops(cfg: dict, n_nodes: int, n_edges: int, train: bool):
    return _flowgnn.step_ops(cfg, n_nodes, n_edges, train, _conv_ops)
