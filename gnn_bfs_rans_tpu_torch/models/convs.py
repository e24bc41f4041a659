"""GAT convolution on the banded kernel path.

Counterpart of ``gnn_bfs_rans_tpu/models/convs.py::GATConv``, fused-
projection path only (``convs.py:137-190``): additive attention
LeakyReLU(α_dst[i] + α_src[j]) with self-loops, softmax over each receiver's
senders, head mean (``concat=False``), plus the conv bias.  The projection
z = x·W happens inside the kernel; the packed attention logits factor
through W as α = x·(W·amat), one [N, 2H] f32 product.  Training runs the
differentiable op ``banded_gat_mean_fused_wa`` (α inside the op, attention
dropout in the kernel, the JAX package's ``fuse_train`` path).  The
unfused, segment and dense paths, and the GCN, GIN and Transformer convs,
are not ported yet.

Parameters keep PyG's ``GATConv`` names and layouts (``lin.weight``
[H·C, F], ``att_src``/``att_dst`` [1, H, C], ``bias`` [C]); they stay
float32 and are cast to the compute dtype where the JAX module casts them.
"""

from __future__ import annotations

import torch
from torch import nn

from ..graph.structs import Graph
from ..kernels.banded import banded_gat_mean_fused, banded_gat_mean_fused_wa


class GATConv(nn.Module):
    def __init__(self, features: int, heads: int = 4,
                 negative_slope: float = 0.2, dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.features = features
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.lin = nn.utils.skip_init(nn.Linear, features, heads * features,
                                      bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, features))
        self.att_dst = nn.Parameter(torch.empty(1, heads, features))
        self.bias = nn.Parameter(torch.empty(features))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX module's init: variance_scaling(1/3, fan_in, uniform)
        for ``lin`` (fan_in F) and the attention vectors (fan_in H), zero
        bias."""
        f = self.lin.weight.shape[1]
        self.lin.weight.uniform_(-f ** -0.5, f ** -0.5, generator=generator)
        for att in (self.att_src, self.att_dst):
            att.uniform_(-self.heads ** -0.5, self.heads ** -0.5,
                         generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, graph: Graph, train: bool = False,
                seed: torch.Tensor | None = None) -> torch.Tensor:
        """``train``: the differentiable op with attention dropout at
        ``self.dropout``, masked from ``seed`` ([1] int32 on x's device)."""
        band = graph.band
        if band is None or band.bias_self is None:
            raise NotImplementedError(
                "GATConv needs the banded adjacency (graph.band.bias_self); "
                "this graph has none — the dense and segment paths are not "
                "ported yet")
        H, C = self.heads, self.features
        dt = x.dtype
        w = self.lin.weight.t().to(dt).contiguous()            # [F, H·C]
        # packed α factor wa = (W·amat) in f32, rounded to x's dtype:
        # wa[:, h] = Σ_c W[:, h·C + c]·att_src[h, c], then the dst half
        w3 = w.float().view(-1, H, C)
        wa = torch.cat([torch.einsum("fhc,hc->fh", w3, self.att_src[0]),
                        torch.einsum("fhc,hc->fh", w3, self.att_dst[0])],
                       dim=1).to(dt)
        if train:
            rate = self.dropout if seed is not None else 0.0
            out = banded_gat_mean_fused_wa(band.bias_self, w, wa, x, H,
                                           self.negative_slope, rate, seed)
        else:
            alphas = x.float() @ wa.float()                    # [N, 2H] f32
            out = banded_gat_mean_fused(band.bias_self, w, alphas.contiguous(),
                                        x.contiguous(), H, self.negative_slope)
        return out + self.bias.to(dt)
