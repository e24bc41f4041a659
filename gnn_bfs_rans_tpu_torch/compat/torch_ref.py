"""``RefFlowGNN``: the reference FlowGNN with PyG semantics, in plain torch.

The port's own copy of ``gnn_bfs_rans_tpu/compat/torch_ref.py`` (the port
imports nothing of the JAX package).  torch_geometric is not needed: the
four conv variants the reference instantiates and the architecture around
them are written from PyG's documented operator semantics, and the
parameter and buffer names are PyG's byte for byte (``lin.weight``,
``att_src``, ``nn.0.weight``, ``lin_query.weight``,
``batch_norms.{i}.module.running_mean``, ``output_proj.{0,3,6,8}.weight``
…), so a ``state_dict()`` of this model is what the reference's training
script saves, and a reference checkpoint loads into it with
``strict=True``.  It is the oracle the port's serving of reference
checkpoints (:mod:`.torch_port`) is held against, on the CPU and on the
card: every tensor it makes (self-loop indices, scatter buffers) takes its
input's device.

Conv semantics (PyG defaults, as the reference constructs them):

* ``GCNConv(H, H)``: self-loops added, ``D̂^-1/2 (A+I) D̂^-1/2 X W + b``;
  ``lin`` has no bias, ``bias`` is separate.
* ``GATConv(H, H, heads=4, concat=False, dropout)``: shared ``lin`` (no
  bias), ``LeakyReLU(α_src[j] + α_dst[i])`` with slope 0.2, self-loops
  added, softmax over incoming edges per (receiver, head), mean over heads,
  ``bias [C]``; dropout acts in training only.
* ``GINConv(Sequential(Linear, ReLU, Linear))``: ``nn((1+eps)·x_i + Σ_j
  x_j)``, no self-loops, ``eps`` a buffer fixed at 0.
* ``TransformerConv(H, H, heads=4, concat=False, dropout)``: per-head
  scaled dot-product attention over incoming edges (no self-loops), q/k/v
  Linears with bias, optional ``lin_edge`` (no bias) added to keys and
  values when ``edge_dim`` is set, mean over heads, root weight
  ``lin_skip`` (with bias).  The reference builds it without ``edge_dim``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F


def scatter_softmax(logits: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    """Numerically-stable softmax of ``logits [E, H]`` grouped by ``dst``."""
    m = torch.full((n, logits.shape[1]), float("-inf"), dtype=logits.dtype,
                   device=logits.device)
    m = m.index_reduce(0, dst, logits, "amax", include_self=True)
    ex = torch.exp(logits - m[dst])
    den = torch.zeros((n, logits.shape[1]), dtype=logits.dtype,
                      device=logits.device).index_add(0, dst, ex)
    return ex / den.clamp_min(1e-16)[dst]


def _add_self_loops(src: torch.Tensor, dst: torch.Tensor, n: int):
    loop = torch.arange(n, dtype=src.dtype, device=src.device)
    return torch.cat([src, loop]), torch.cat([dst, loop])


class RefGCNConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.bias = nn.Parameter(torch.zeros(out_channels))

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        src, dst = _add_self_loops(edge_index[0], edge_index[1], n)
        deg = x.new_zeros(n).index_add(0, dst, x.new_ones(dst.shape[0]))
        dinv = deg.pow(-0.5)
        dinv = torch.where(torch.isfinite(dinv), dinv, dinv.new_zeros(()))
        w = dinv[src] * dinv[dst]
        h = self.lin(x)
        out = torch.zeros_like(h).index_add(0, dst, h[src] * w[:, None])
        return out + self.bias


class RefGATConv(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        heads: int = 4,
        concat: bool = False,
        dropout: float = 0.0,
        negative_slope: float = 0.2,
    ):
        super().__init__()
        self.heads, self.out_channels, self.concat = heads, out_channels, concat
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.lin = nn.Linear(in_channels, heads * out_channels, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, out_channels))
        self.att_dst = nn.Parameter(torch.empty(1, heads, out_channels))
        nn.init.xavier_uniform_(self.att_src)
        nn.init.xavier_uniform_(self.att_dst)
        self.bias = nn.Parameter(
            torch.zeros(heads * out_channels if concat else out_channels)
        )

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
        n, (H, C) = x.shape[0], (self.heads, self.out_channels)
        z = self.lin(x).view(n, H, C)
        a_s = (z * self.att_src).sum(-1)  # [N, H]
        a_d = (z * self.att_dst).sum(-1)
        src, dst = _add_self_loops(edge_index[0], edge_index[1], n)
        logits = F.leaky_relu(a_s[src] + a_d[dst], self.negative_slope)
        attn = scatter_softmax(logits, dst, n)  # [E+N, H]
        if self.training and self.dropout > 0:
            attn = F.dropout(attn, p=self.dropout, training=True)
        out = x.new_zeros(n, H, C).index_add(0, dst, z[src] * attn[..., None])
        out = out.reshape(n, H * C) if self.concat else out.mean(1)
        return out + self.bias


class RefGINConv(nn.Module):
    def __init__(self, mlp: nn.Module, eps: float = 0.0):
        super().__init__()
        self.nn = mlp
        self.register_buffer("eps", torch.tensor([eps]))

    def forward(self, x: torch.Tensor, edge_index: torch.Tensor) -> torch.Tensor:
        src, dst = edge_index
        agg = torch.zeros_like(x).index_add(0, dst, x[src])
        return self.nn((1.0 + self.eps) * x + agg)


class RefTransformerConv(nn.Module):
    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        heads: int = 4,
        concat: bool = False,
        dropout: float = 0.0,
        edge_dim: int | None = None,
        root_weight: bool = True,
    ):
        super().__init__()
        self.heads, self.out_channels, self.concat = heads, out_channels, concat
        self.dropout = dropout
        self.lin_query = nn.Linear(in_channels, heads * out_channels)
        self.lin_key = nn.Linear(in_channels, heads * out_channels)
        self.lin_value = nn.Linear(in_channels, heads * out_channels)
        self.lin_edge = (
            nn.Linear(edge_dim, heads * out_channels, bias=False)
            if edge_dim is not None
            else None
        )
        self.lin_skip = (
            nn.Linear(
                in_channels, heads * out_channels if concat else out_channels
            )
            if root_weight
            else None
        )

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor,
        edge_attr: torch.Tensor | None = None,
    ) -> torch.Tensor:
        n, (H, C) = x.shape[0], (self.heads, self.out_channels)
        q = self.lin_query(x).view(n, H, C)
        k = self.lin_key(x).view(n, H, C)
        v = self.lin_value(x).view(n, H, C)
        src, dst = edge_index
        k_e, v_e = k[src], v[src]
        if self.lin_edge is not None and edge_attr is not None:
            e = self.lin_edge(edge_attr).view(-1, H, C)
            k_e = k_e + e
            v_e = v_e + e
        logits = (q[dst] * k_e).sum(-1) / math.sqrt(C)  # [E, H]
        attn = scatter_softmax(logits, dst, n)
        if self.training and self.dropout > 0:
            attn = F.dropout(attn, p=self.dropout, training=True)
        out = x.new_zeros(n, H, C).index_add(0, dst, v_e * attn[..., None])
        out = out.reshape(n, H * C) if self.concat else out.mean(1)
        if self.lin_skip is not None:
            out = out + self.lin_skip(x)
        return out


class _BatchNormWrapper(nn.Module):
    """PyG ``BatchNorm`` stores the torch BatchNorm1d as ``self.module``."""

    def __init__(self, channels: int):
        super().__init__()
        self.module = nn.BatchNorm1d(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.module(x)


class RefFlowGNN(nn.Module):
    """Architecture mirror of the reference ``FlowGNN`` (``gnn_model.py:14-197``)."""

    def __init__(
        self,
        input_dim: int = 3,
        hidden_dim: int = 128,
        output_dim: int = 7,
        num_layers: int = 4,
        layer_type: str = "GCN",
        dropout: float = 0.1,
        use_batch_norm: bool = True,
        edge_dim: int | None = None,
        heads: int = 4,
    ):
        super().__init__()
        self.layer_type = layer_type
        self.use_batch_norm = use_batch_norm
        self.input_proj = nn.Linear(input_dim, hidden_dim)
        self.gnn_layers = nn.ModuleList()
        self.batch_norms = nn.ModuleList() if use_batch_norm else None
        for _ in range(num_layers):
            if layer_type == "GCN":
                layer = RefGCNConv(hidden_dim, hidden_dim)
            elif layer_type == "GAT":
                layer = RefGATConv(
                    hidden_dim, hidden_dim, heads=heads, concat=False,
                    dropout=dropout,
                )
            elif layer_type == "GIN":
                mlp = nn.Sequential(
                    nn.Linear(hidden_dim, hidden_dim),
                    nn.ReLU(),
                    nn.Linear(hidden_dim, hidden_dim),
                )
                layer = RefGINConv(mlp)
            elif layer_type == "Transformer":
                layer = RefTransformerConv(
                    hidden_dim, hidden_dim, heads=heads, concat=False,
                    dropout=dropout, edge_dim=edge_dim,
                )
            else:
                raise ValueError(f"unknown layer type {layer_type}")
            self.gnn_layers.append(layer)
            if use_batch_norm:
                self.batch_norms.append(_BatchNormWrapper(hidden_dim))
        self.output_proj = nn.Sequential(
            nn.Linear(hidden_dim, hidden_dim),
            nn.ReLU(),
            nn.Dropout(dropout),
            nn.Linear(hidden_dim, hidden_dim),
            nn.ReLU(),
            nn.Dropout(dropout),
            nn.Linear(hidden_dim, hidden_dim // 2),
            nn.ReLU(),
            nn.Linear(hidden_dim // 2, output_dim),
        )
        self.dropout = nn.Dropout(dropout)

    def forward(
        self,
        x: torch.Tensor,
        edge_index: torch.Tensor,
        edge_attr: torch.Tensor | None = None,
    ) -> torch.Tensor:
        x = self.input_proj(x)
        for i, layer in enumerate(self.gnn_layers):
            if self.layer_type == "Transformer":
                x_new = layer(x, edge_index, edge_attr=edge_attr)
            else:
                x_new = layer(x, edge_index)
            x = x + x_new  # residual (gnn_model.py:184)
            if self.use_batch_norm:
                x = self.batch_norms[i](x)
            x = F.relu(x)
            x = self.dropout(x)
        return self.output_proj(x)
