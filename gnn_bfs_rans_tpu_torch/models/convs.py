"""GCN, GAT, GIN and Transformer convolutions on the banded kernel path.

Counterparts of ``gnn_bfs_rans_tpu/models/convs.py``'s ``GCNConv``,
``GATConv`` and ``GINConv`` with ``backend='pallas'`` on a banded graph:

* ``GCNConv`` (``convs.py:67-108``): ``h = x·W`` (no bias), then the
  normalized aggregation ``D̂^-1/2 (A+I) D̂^-1/2 h`` as ``banded_spmm`` on
  the band's ``gcn`` plane, plus the bias in h's dtype;
* ``GINConv`` (``convs.py:334-363``, ``train_eps=False``):
  ``MLP(x + Σ_nbr x)`` with the sum as ``banded_spmm`` on the ``adj``
  plane and the reference's 2-layer MLP;
* ``GATConv`` (``convs.py:111-312``, ``concat=False``): additive attention
  LeakyReLU(α_dst[i] + α_src[j]) with self-loops, softmax over each
  receiver's senders, head mean, plus the bias.  In eval, and in training
  with ``fuse_train``, the projection z = x·W happens inside the kernel and
  the packed logits factor through W as α = x·(W·amat), one [N, 2H] f32
  product (``banded_gat_mean_fused`` / ``banded_gat_mean_fused_wa``, the
  latter with attention dropout in the kernel).  Training with
  ``fuse_train=False`` runs the unfused path: z = x·W in the compute dtype,
  α = z·amat in f32, then ``banded_gat_mean_packed`` on z.
* ``TransformerConv`` (``convs.py:366-618``): q, k, v = x·W + b, scaled
  dot-product attention over each receiver's senders (no self-loops) on
  the band's ``bias_noself`` mask, with attention dropout in training, the
  head mean (or concat), plus ``lin_skip(x)``.  Edge-conditioned
  (``edge_dim``): the logit edge term factors through ``qw = q·W_e`` per
  head and the value edge term through ``s``, the attention-weighted raw
  edge features, which W_e projects outside the kernel; on a band with the
  geometric ``geo`` planes (every mesh the system builds) the factorised
  geo form runs, else the generic ``edge`` form.  Training on the geo
  head-mean path runs ``banded_transformer_geo_mean_projgrad`` (the q/k/v
  projections inside the op, q/k/v rounded once after the f32 bias); every
  other form runs row 9's op on dense q/k/v.  In eval, with ``fuse_eval``
  (and a deterministic forward) the geo head-mean path projects q/k/v
  inside the launch (``banded_transformer_geo_mean_fused``, row 11);
  otherwise row 9 runs on dense q/k/v.  The JAX package's eval also routes
  the geo head-mean path through its projgrad op, whose forward is the
  same on weights extracted as ``lin(eye) − lin(0)``; the port takes that
  op in training only and uses the weights themselves.

The dense products stay ``torch.matmul``: in the JAX package they are XLA
products outside any Pallas kernel.  The projgrad op's are hand-written
(``gemm.cuh``): its backward's products run inside the JAX op's kernel,
and its forward rounds q/k/v once after the f32 bias.  The segment and dense backends and the
concat GAT are not ported yet; a graph without the band plane a conv needs
raises.

Parameters keep PyG's names and layouts (GCN ``lin.weight`` [F, F] and
``bias``; GAT ``lin.weight`` [H·C, F], ``att_src``/``att_dst`` [1, H, C],
``bias`` [C]; GIN ``nn.0`` and ``nn.2``, the Linear layers of
``Sequential(Linear, ReLU, Linear)``; Transformer ``lin_query``,
``lin_key``, ``lin_value`` [H·C, F] with bias, ``lin_edge`` [H·C, D_e]
without, ``lin_skip`` [C or H·C, F] with bias); they stay float32 and are
cast to the compute dtype where the JAX modules cast them.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from ..graph.structs import Graph
from ..kernels.banded import (
    banded_gat_mean_fused,
    banded_gat_mean_fused_wa,
    banded_gat_mean_packed,
    banded_spmm,
    banded_transformer_fwd,
    banded_transformer_geo_mean_fused,
    banded_transformer_geo_mean_projgrad,
)


def dense(layer: nn.Linear, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs, kernel and bias cast to the compute
    dtype (x's when None), product then bias add, each rounded there."""
    dt = x.dtype if dtype is None else dtype
    y = x.to(dt) @ layer.weight.t().to(dt)
    return y if layer.bias is None else y + layer.bias.to(dt)


@torch.no_grad()
def lecun_init_(layer: nn.Linear, generator: torch.Generator) -> None:
    """The JAX modules' ``_lecun_linear`` init: variance_scaling(1/3,
    fan_in, uniform) = uniform ±1/√fan_in, zero bias."""
    f = layer.weight.shape[1]
    layer.weight.uniform_(-f ** -0.5, f ** -0.5, generator=generator)
    if layer.bias is not None:
        layer.bias.zero_()


def _plane(graph: Graph, name: str, conv: str) -> torch.Tensor:
    """The band plane ``name`` a conv aggregates over, or a raise."""
    plane = None if graph.band is None else getattr(graph.band, name)
    if plane is None:
        raise NotImplementedError(
            f"{conv} needs the banded adjacency (graph.band.{name}); this "
            "graph has none — the dense and segment paths are not ported "
            "yet")
    return plane


class GCNConv(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        self.lin = nn.utils.skip_init(nn.Linear, features, features,
                                      bias=False)
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_init_(self.lin, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        gcn = _plane(graph, "gcn", "GCNConv")
        h = dense(self.lin, x)
        out = banded_spmm(gcn, h, functools.partial(graph.band.transposed,
                                                    "gcn"))
        # the bias in the compute dtype, as the JAX module adds it
        return out + self.bias.to(h.dtype)


class GINConv(nn.Module):
    def __init__(self, features: int):
        super().__init__()
        lin = functools.partial(nn.utils.skip_init, nn.Linear)
        self.nn = nn.Sequential(lin(features, features), nn.ReLU(),
                                lin(features, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_init_(self.nn[0], generator)
        lecun_init_(self.nn[2], generator)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        adj = _plane(graph, "adj", "GINConv")
        agg = banded_spmm(adj, x, functools.partial(graph.band.transposed,
                                                    "adj"))
        h = x + agg                        # (1 + eps)·x + Σ_nbr x, eps = 0
        h = torch.relu(dense(self.nn[0], h))
        return dense(self.nn[2], h)


class GATConv(nn.Module):
    def __init__(self, features: int, heads: int = 4,
                 negative_slope: float = 0.2, dropout: float = 0.0,
                 fuse_train: bool = True):
        super().__init__()
        self.heads = heads
        self.features = features
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.fuse_train = fuse_train
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
        lecun_init_(self.lin, generator)
        for att in (self.att_src, self.att_dst):
            att.uniform_(-self.heads ** -0.5, self.heads ** -0.5,
                         generator=generator)
        self.bias.zero_()

    def forward(self, x: torch.Tensor, graph: Graph, train: bool = False,
                seed: torch.Tensor | None = None) -> torch.Tensor:
        """``train``: the differentiable op with attention dropout at
        ``self.dropout``, masked from ``seed`` ([1] int32 on x's device)."""
        mask = _plane(graph, "bias_self", "GATConv")
        H, C = self.heads, self.features
        dt = x.dtype
        rate = self.dropout if seed is not None else 0.0
        if train and not self.fuse_train:
            # unfused: z = x·W, α = z·amat in f32 with amat in z's dtype
            z = dense(self.lin, x)                             # [N, H·C]
            z3 = z.float().view(-1, H, C)
            alphas = torch.cat(
                [torch.einsum("nhc,hc->nh", z3, att[0].to(dt).float())
                 for att in (self.att_src, self.att_dst)], dim=1)
            out = banded_gat_mean_packed(mask, z, alphas, H,
                                         self.negative_slope, rate, seed)
            return out + self.bias.to(dt)
        w = self.lin.weight.t().to(dt).contiguous()            # [F, H·C]
        # packed α factor wa = (W·amat) in f32, rounded to x's dtype:
        # wa[:, h] = Σ_c W[:, h·C + c]·att_src[h, c], then the dst half
        w3 = w.float().view(-1, H, C)
        wa = torch.cat([torch.einsum("fhc,hc->fh", w3, self.att_src[0]),
                        torch.einsum("fhc,hc->fh", w3, self.att_dst[0])],
                       dim=1).to(dt)
        if train:
            out = banded_gat_mean_fused_wa(mask, w, wa, x, H,
                                           self.negative_slope, rate, seed)
        else:
            alphas = x.float() @ wa.float()                    # [N, 2H] f32
            out = banded_gat_mean_fused(mask, w, alphas.contiguous(),
                                        x.contiguous(), H, self.negative_slope)
        return out + self.bias.to(dt)


class TransformerConv(nn.Module):
    def __init__(self, features: int, heads: int = 4, concat: bool = False,
                 edge_dim: int | None = None, fuse_eval: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        self.heads = heads
        self.features = features
        self.concat = concat
        self.edge_dim = edge_dim
        self.fuse_eval = fuse_eval
        self.dropout = dropout
        hc = heads * features
        lin = functools.partial(nn.utils.skip_init, nn.Linear)
        self.lin_query = lin(features, hc)
        self.lin_key = lin(features, hc)
        self.lin_value = lin(features, hc)
        self.lin_edge = (lin(edge_dim, hc, bias=False)
                         if edge_dim is not None else None)
        self.lin_skip = lin(features, hc if concat else features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for layer in (self.lin_query, self.lin_key, self.lin_value,
                      self.lin_edge, self.lin_skip):
            if layer is not None:
                lecun_init_(layer, generator)

    def forward(self, x: torch.Tensor, graph: Graph, train: bool = False,
                seed: torch.Tensor | None = None,
                fused_ok: bool = True) -> torch.Tensor:
        """``train``: the training forms, the geo head-mean path through
        ``banded_transformer_geo_mean_projgrad`` (the JAX module's branch,
        which the port takes in training only), with attention dropout at
        ``self.dropout`` masked from ``seed`` ([1] int32 on x's device).
        ``fused_ok``: the forward is deterministic (the JAX module's
        ``deterministic``), so ``fuse_eval`` may take row 11 in eval; the
        ``exact_bn`` forward passes False, as the JAX package runs it in
        train mode."""
        mask = _plane(graph, "bias_noself", "TransformerConv")
        H, C = self.heads, self.features
        dt = x.dtype
        band = graph.band
        rate = self.dropout if seed is not None else 0.0
        if self.edge_dim is not None:
            d_e = self.edge_dim
            if band.geo is None and band.edge is None:
                raise NotImplementedError(
                    "the edge-conditioned TransformerConv needs the band's "
                    "geo or edge planes; this graph has neither")
            # W_e = lin_edge(I) in the compute dtype, [D_e, H, C]
            w_e = self.lin_edge.weight.t().to(dt).view(d_e, H, C)
            # block-diagonal [H·C, H·D_e]: qw[n, h·D + d] = q_h · w_e[d, h]
            w_blk = (torch.eye(H, device=x.device)[:, None, :, None]
                     * w_e.float().permute(1, 2, 0)[:, :, None, :]
                     ).reshape(H * C, H * d_e).to(dt)
            geo_mean = band.geo is not None and not self.concat
            qkv_layers = (self.lin_query, self.lin_key, self.lin_value)
            if geo_mean and (train or (self.fuse_eval and fused_ok)):
                ws = [m.weight.t().to(dt).contiguous() for m in qkv_layers]
                bs = [m.bias.to(dt) for m in qkv_layers]
                if train:
                    out, s = banded_transformer_geo_mean_projgrad(
                        mask, band.geo, band.pos, x, *ws, *bs, w_blk, H,
                        rate, seed)
                else:
                    out, s = banded_transformer_geo_mean_fused(
                        mask, band.geo, band.pos, x.contiguous(), *ws, *bs,
                        w_blk, H)
            else:
                q, k, v = (dense(m, x) for m in qkv_layers)
                qw = (q.float() @ w_blk.float()).to(dt)
                cond = (dict(geo=band.geo, pos=band.pos)
                        if band.geo is not None else dict(edge=band.edge))
                out, s = banded_transformer_fwd(
                    mask, q, k, v, H, qw=qw, mean_heads=not self.concat,
                    dropout_rate=rate, seed=seed, **cond)
            if self.concat:
                out = out.view(-1, H, C) + torch.einsum(
                    "nhd,dhc->nhc", s.view(-1, H, d_e), w_e.float()
                ).to(out.dtype)
                out = out.reshape(-1, H * C)
            else:
                # Σ_h p·e_ij / H as one [N, H·D_e] @ [H·D_e, C] product
                w_flat = w_e.permute(1, 0, 2).reshape(H * d_e, C)
                edge_term = (s @ w_flat.float()) * (1.0 / H)
                out = out + edge_term.to(out.dtype)
        else:
            q, k, v = (dense(m, x) for m in
                       (self.lin_query, self.lin_key, self.lin_value))
            out = banded_transformer_fwd(mask, q, k, v, H,
                                         mean_heads=not self.concat,
                                         dropout_rate=rate, seed=seed)
        return out + dense(self.lin_skip, x)
