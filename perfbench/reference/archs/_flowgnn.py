"""The FlowGNN skeleton that the conv architectures share.

``Linear(3→H)``; per layer a conv, the residual add, BatchNorm
(``mode='train'``: the batch statistics of the real rows, momentum 0.1
and the unbiased variance into the running statistics; ``'exact'``: the
batch statistics, the running ones untouched, no dropout — the eval of a
bfloat16 model trained with BatchNorm recalibration; ``'eval'``: the
running statistics), ReLU and dropout (the epilogue's stream); then the
MLP ``H→H→H→H/2→7`` with dropout after its first two ReLUs.  An
architecture module subclasses :class:`Forward` with its conv and passes
its conv's leaves and counts to :func:`param_shapes` and :func:`step_ops`;
the names are the reference's PyTorch Geometric layout, which the port's
``state_dict`` keeps (``input_proj``, ``convs.<i>``, ``norms.<i>``,
``out_0`` .. ``out_3``).

:func:`forward_matmul_flops` / :func:`train_matmul_flops` are frozen
copies of ``gnn_bfs_rans_tpu_torch/utils/roofline.py``'s model-FLOP
formulas (matmul work only, the banded kernels' padded windows not
counted; a training step is three forwards).
"""

from __future__ import annotations

import torch

from .. import stream
from ..model import linear, products, quantizer
from ...yardstick.weights import Leaf


def lin(name: str, n_in: int, n_out: int, bias: bool = True
        ) -> list[Leaf]:
    """A linear layer's leaves: weight and bias uniform in ±1/√fan_in."""
    out = [Leaf(f"{name}.weight", (n_out, n_in), "uniform", n_in)]
    if bias:
        out.append(Leaf(f"{name}.bias", (n_out,), "uniform", n_in))
    return out


def param_shapes(cfg: dict, conv) -> list[Leaf]:
    """The skeleton's leaves around ``conv(cfg, prefix)``, a conv's."""
    h = cfg["hidden_dim"]
    out = lin("input_proj", cfg["input_dim"], h)
    for i in range(cfg["num_layers"]):
        out += conv(cfg, f"convs.{i}")
    for i in range(cfg["num_layers"]):
        out += [Leaf(f"norms.{i}.weight", (h,), "ones"),
                Leaf(f"norms.{i}.bias", (h,), "zeros"),
                Leaf(f"norms.{i}.running_mean", (h,), "zeros", buffer=True),
                Leaf(f"norms.{i}.running_var", (h,), "ones", buffer=True)]
    return (out + lin("out_0", h, h) + lin("out_1", h, h)
            + lin("out_2", h, h // 2)
            + lin("out_3", h // 2, cfg["output_dim"]))


def dtype_bytes(cfg: dict) -> int:
    return 2 if cfg["compute_dtype"] in ("bfloat16", "mixed") else 4


class Forward:
    """The skeleton; a subclass gives ``conv(p, name, x, rate, gen)`` → [n,
    H], which draws its own dropout seeds from ``gen`` where it has
    any."""

    def __init__(self, cfg: dict, graph, quant: str = "f32"):
        self.cfg = cfg
        self.g = graph
        self.q = quantizer(quant)
        self.mm = products(quant)
        self.rate = cfg["dropout"]
        self.itemsize = dtype_bytes(cfg)

    def linear(self, p, name, x, bias=True):
        return linear(p, name, x, self.q, bias, self.mm)

    def conv(self, p, name, x, rate, gen):
        raise NotImplementedError

    def __call__(self, p, stats, x, mode: str, gen=None) -> torch.Tensor:
        cfg, g, q = self.cfg, self.g, self.q
        dev = x.device
        rate = self.rate if mode == "train" else 0.0
        x = self.linear(p, "input_proj", x)
        for i in range(cfg["num_layers"]):
            x_res = q(x + q(self.conv(p, f"convs.{i}", x, rate, gen)))
            ep_seed = stream.draw_seed(gen, dev) if rate > 0 else None
            x = torch.relu(q(self._norm(p, stats, f"norms.{i}", x_res, mode)))
            if rate > 0:
                block = stream.epilogue_block(g.n_pad, x.shape[1],
                                              self.itemsize)
                k = stream.epilogue_keep(ep_seed, g.n_pad, x.shape[1], block,
                                         rate, dev)[:g.n]
                x = q(torch.where(k, x / (1.0 - rate), 0.0))
        h = x
        for j, name in enumerate(("out_0", "out_1", "out_2")):
            h = torch.relu(self.linear(p, name, h))
            if rate > 0 and j < 2:
                keep = torch.rand((g.n_pad, h.shape[1]), generator=gen,
                                  device=dev) < 1.0 - rate
                h = q(torch.where(keep[:g.n], h / (1.0 - rate), 0.0))
        return self.linear(p, "out_3", h)

    def _norm(self, p, stats, name, x, mode):
        w, b = p[f"{name}.weight"], p[f"{name}.bias"]
        eps = 1e-5
        if mode in ("train", "exact"):
            mean = x.mean(0)
            var = ((x - mean) ** 2).mean(0)
        if mode == "train":
            with torch.no_grad():
                n = x.shape[0]
                rm, rv = stats[f"{name}.running_mean"], \
                    stats[f"{name}.running_var"]
                rm.mul_(0.9).add_(0.1 * mean)
                rv.mul_(0.9).add_(0.1 * var * n / max(n - 1, 1))
        elif mode == "eval":
            mean = stats[f"{name}.running_mean"]
            var = stats[f"{name}.running_var"]
        return (x - mean) * torch.rsqrt(var + eps) * w + b


def mm(m: float, k: float, n: float) -> float:
    return 2.0 * m * k * n


def forward_matmul_flops(layer_type: str, num_layers: int, hidden_dim: int,
                         n_nodes: int, n_edges: int, heads: int = 4,
                         input_dim: int = 3, output_dim: int = 7,
                         edge_dim: int = 4, use_edge_attr: bool = True
                         ) -> float:
    """Model matmul FLOPs of one FlowGNN forward."""
    n, e, h, hd = float(n_nodes), float(n_edges), float(hidden_dim), \
        float(heads)
    c = h
    total = mm(n, input_dim, h)
    if layer_type == "GCN":
        per_layer = mm(n, h, h) + 2.0 * (e + n) * h
    elif layer_type == "GAT":
        per_layer = (mm(n, h, hd * c) + mm(n, hd * c, 2 * hd)
                     + 2.0 * (e + n) * hd * c)
    elif layer_type == "GIN":
        per_layer = 2.0 * e * h + mm(n, h, h) + mm(n, h, h)
    elif layer_type == "Transformer":
        per_layer = (3.0 * mm(n, h, hd * c) + mm(n, h, c)
                     + 2.0 * e * hd * c + 2.0 * e * hd * c)
        if use_edge_attr:
            per_layer += (mm(n, hd * c, hd * edge_dim)
                          + 2.0 * e * edge_dim * hd * c
                          + mm(n, hd * edge_dim, c))
    else:
        raise ValueError(f"unknown layer_type {layer_type!r}")
    total += num_layers * per_layer
    total += (mm(n, h, h) + mm(n, h, h) + mm(n, h, h / 2)
              + mm(n, h / 2, output_dim))
    return total


def train_matmul_flops(*args, **kwargs) -> float:
    return 3.0 * forward_matmul_flops(*args, **kwargs)


def model_flops(cfg: dict, n_nodes: int, n_edges: int, train: bool) -> float:
    kw = dict(layer_type=cfg["layer_type"], num_layers=cfg["num_layers"],
              hidden_dim=cfg["hidden_dim"], n_nodes=n_nodes, n_edges=n_edges,
              heads=cfg["heads"], input_dim=cfg["input_dim"],
              output_dim=cfg["output_dim"], edge_dim=cfg["edge_dim"],
              use_edge_attr=cfg["use_edge_attr"])
    return train_matmul_flops(**kw) if train else forward_matmul_flops(**kw)


def step_ops(cfg: dict, n_nodes: int, n_edges: int, train: bool, conv
             ) -> list[tuple[str, float, float]]:
    """The skeleton's operations around ``conv(cfg, n, e)`` → (weights
    a conv holds, its FLOPs, the graph's bytes it reads: 4 an edge for the
    adjacency, more where it reads the edges' geometry)."""
    n, e = float(n_nodes), float(n_edges)
    h = cfg["hidden_dim"]
    b = dtype_bytes(cfg)
    ops: list[tuple[str, float, float]] = []
    n_params = 0

    def dense(name, n_in, n_out, in_bytes=b, out_bytes=b, bias=True):
        nonlocal n_params
        n_params += n_in * n_out + (n_out if bias else 0)
        fl = mm(n, n_in, n_out)
        by = n * n_in * in_bytes + n_in * n_out * b + n * n_out * out_bytes
        ops.append((name, fl, by))
        if train:
            # grad-input and grad-weight: read dY, X, W; write dX, dW
            ops.append((name + ".bwd", 2.0 * fl,
                        n * n_out * out_bytes + n * n_in * in_bytes
                        + n_in * n_out * b + n * n_in * in_bytes
                        + n_in * n_out * 4))

    dense("input_proj", cfg["input_dim"], h, in_bytes=4)
    for i in range(cfg["num_layers"]):
        w_count, fl, graph_bytes = conv(cfg, n, e)
        n_params += w_count
        x_bytes = n * h * b
        # x, the weights, the adjacency in; the conv's output out
        ops.append((f"conv{i}", fl,
                    x_bytes + w_count * b + graph_bytes + x_bytes))
        if train:
            # dY, x, the weights, the adjacency in; dx and dW (f32) out
            ops.append((f"conv{i}.bwd", 2.0 * fl,
                        2 * x_bytes + w_count * b + graph_bytes + x_bytes
                        + w_count * 4))
        # residual add, BatchNorm, ReLU, dropout: x and x_new in, y out
        ops.append((f"norm{i}", 10.0 * n * h, 3.0 * n * h * b))
        n_params += 2 * h
        if train:
            ops.append((f"norm{i}.bwd", 12.0 * n * h, 3.0 * n * h * b))
    dense("out_0", h, h)
    dense("out_1", h, h)
    dense("out_2", h, h // 2)
    dense("out_3", h // 2, cfg["output_dim"], in_bytes=4, out_bytes=4)
    # the loss reads the prediction and the target
    ops.append(("loss", 4.0 * n * cfg["output_dim"],
                2.0 * n * cfg["output_dim"] * 4))
    if train:
        # global-norm clip reads the gradients; Adam reads p, g, m, v and
        # writes p, m, v (f32)
        ops.append(("clip", 2.0 * n_params, 4.0 * n_params))
        ops.append(("adam", 12.0 * n_params, 28.0 * n_params))
    return ops
