"""GCN, GAT, GIN and Transformer convolutions on three backends.

Counterparts of ``gnn_bfs_rans_tpu/models/convs.py``'s ``GCNConv``,
``GATConv``, ``GINConv`` and ``TransformerConv``.  Each conv takes the JAX
module's ``backend``: ``pallas`` runs the banded kernels when the graph
carries the band plane the conv reads, and otherwise (a mesh whose band
would be wider than 5 tiles, or a band built without that plane) the
``dense`` branch, as the JAX module decides; ``dense`` aggregates over the
padded neighbour layout (``ops/dense.py``) and ``segment`` over the COO
edges (``ops/segment.py``), both plain torch, as the JAX package leaves
them to XLA.  The routing reads only the config and the graph.

* ``GCNConv`` (``convs.py:67-108``): ``h = x·W`` (no bias), then the
  normalized aggregation ``D̂^-1/2 (A+I) D̂^-1/2 h``: ``banded_spmm`` on the
  band's ``gcn`` plane, or the f32 coefficients ``1/√(deĝ_i deĝ_j)`` over
  the edges and the self-loop ``h/deĝ`` (f32 on bf16 h: the sum is f32);
  plus the bias in the result's dtype.
* ``GINConv`` (``convs.py:334-363``, ``train_eps=False``):
  ``MLP(x + Σ_nbr x)`` with the sum as ``banded_spmm`` on the ``adj``
  plane or an unweighted neighbour sum, and the reference's 2-layer MLP.
* ``GATConv`` (``convs.py:111-312``): additive attention
  LeakyReLU(α_dst[i] + α_src[j]) with self-loops, softmax over each
  receiver's senders, the head mean (or, with ``concat``, every head's
  output and a bias of H·C), plus the bias.  On the kernels: in eval, and
  in training with ``fuse_train``, the head-mean conv projects z = x·W
  inside the kernel and the packed logits factor through W as
  α = x·(W·amat), one [N, 2H] f32 product (``banded_gat_mean_fused`` /
  ``banded_gat_mean_fused_wa``, the latter with attention dropout in the
  kernel).  Otherwise (training with ``fuse_train=False``, and the concat
  conv always, as in the JAX module) z = x·W in the compute dtype,
  α = z·amat in f32, then row 4 on z: ``banded_gat_mean_packed`` or
  ``banded_gat_packed``.  The dense and segment branches compute the same
  softmax in f32 with the self-loop as an extra slot.
* ``TransformerConv`` (``convs.py:366-618``): q, k, v = x·W + b, scaled
  dot-product attention over each receiver's senders (no self-loops), with
  attention dropout in training, the head mean (or concat), plus
  ``lin_skip(x)``.  On the kernels (the band's ``bias_noself`` mask; with
  ``edge_dim`` also its ``geo`` or ``edge`` planes): the logit edge term
  factors through ``qw = q·W_e`` per head and the value edge term through
  ``s``, the attention-weighted raw edge features, which W_e projects
  outside the kernel; on a band with the geometric ``geo`` planes (every
  mesh the system builds) the factorised geo form runs, else the generic
  ``edge`` form.  Training on the geo head-mean path runs
  ``banded_transformer_geo_mean_projgrad`` (the q/k/v projections inside
  the op, q/k/v rounded once after the f32 bias); every other form runs
  row 9's op on dense q/k/v.  In eval, with ``fuse_eval`` (and a
  deterministic forward) the geo head-mean path projects q/k/v inside the
  launch (``banded_transformer_geo_mean_fused``, row 11); otherwise row 9
  runs on dense q/k/v.  The JAX package's eval also routes the geo
  head-mean path through its projgrad op, whose forward is the same on
  weights extracted as ``lin(eye) − lin(0)``; the port takes that op in
  training only and uses the weights themselves.  The dense and segment
  branches add the per-edge ``edge_kv = lin_edge(edge_feat)`` to k and v
  and scale the logits by 1/√C in x's dtype.

Dtypes follow the JAX modules: the products run in the compute dtype
``dtype`` (the flax modules' ``dtype``; None: x's), and in bf16 the dense
and segment GCN, GAT and Transformer return f32, where the f32 softmax or
coefficients meet bf16 values (GIN returns bf16).  Attention dropout on
the dense and segment branches draws its masks from the explicit
``generator`` (``kernels/dropout.py::bernoulli_keep``); the kernels draw
from the hash stream keyed by ``seed``.

The dense products stay ``torch.matmul``: in the JAX package they are XLA
products outside any Pallas kernel.  The projgrad op's are hand-written
(``csrc/gemm_sm90.cuh``): its backward's products run inside the JAX op's
kernel, and its forward rounds q/k/v once after the f32 bias.

Parameters keep PyG's names and layouts (GCN ``lin.weight`` [F, F] and
``bias``; GAT ``lin.weight`` [H·C, F], ``att_src``/``att_dst`` [1, H, C],
``bias`` [C] or, concat, [H·C]; GIN ``nn.0`` and ``nn.2``, the Linear
layers of ``Sequential(Linear, ReLU, Linear)``; Transformer ``lin_query``,
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
    banded_gat_packed,
    banded_spmm,
    banded_transformer_fwd,
    banded_transformer_geo_mean_fused,
    banded_transformer_geo_mean_projgrad,
)
from ..kernels.dropout import bernoulli_keep
from ..ops import dense as dops
from ..ops import segment as sops

BACKENDS = ("segment", "dense", "pallas")


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


def _plane(graph: Graph, name: str, backend: str) -> torch.Tensor | None:
    """The band plane ``name`` the kernels aggregate over, or None when the
    conv takes a non-banded branch (``backend`` other than pallas, or no
    such plane: the JAX modules' rule)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "pallas" or graph.band is None:
        return None
    return getattr(graph.band, name)


def _leaky(v: torch.Tensor, slope: float) -> torch.Tensor:
    """``jax.nn.leaky_relu``."""
    return torch.where(v >= 0, v, slope * v)


def _dropped(attn: torch.Tensor, rate: float,
             generator: torch.Generator) -> torch.Tensor:
    """``attn · keep / (1 − rate)`` with a Bernoulli(1 − rate) mask of
    attn's shape (the dense and segment branches' attention dropout)."""
    keep = bernoulli_keep(attn.shape, rate, generator, attn.device)
    return attn * keep / (1 - rate)


class GCNConv(nn.Module):
    def __init__(self, features: int, backend: str = "pallas", dtype=None):
        super().__init__()
        self.backend = backend
        self.dtype = dtype
        self.lin = nn.utils.skip_init(nn.Linear, features, features,
                                      bias=False)
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_init_(self.lin, generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        gcn = _plane(graph, "gcn", self.backend)
        h = dense(self.lin, x, self.dtype)
        if gcn is not None:
            out = banded_spmm(gcn, h, functools.partial(graph.band.transposed,
                                                        "gcn"))
            # the bias in the compute dtype, as the JAX module adds it
            return out + self.bias.to(h.dtype)
        inv_sqrt = torch.rsqrt((graph.in_degree + 1.0).clamp_min(1.0))
        inv_sqrt = torch.where(graph.node_mask, inv_sqrt, 0.0)
        if self.backend == "segment":
            s, r = graph.senders.long(), graph.receivers.long()
            agg = sops.aggregate_sum(h, graph.senders, graph.receivers,
                                     graph.n_pad, edge_mask=graph.edge_mask,
                                     edge_weight=inv_sqrt[s] * inv_sqrt[r])
        else:
            # coeff[i, d] = 1/√(deĝ_i deĝ_nbr[i, d])
            coeff = inv_sqrt[:, None] * inv_sqrt[graph.nbr_idx.long()]
            agg = dops.masked_sum(h, graph.nbr_idx, graph.nbr_mask, coeff)
        agg = agg + h * (inv_sqrt * inv_sqrt)[:, None]   # self-loop: 1/deĝ
        return agg + self.bias.to(agg.dtype)


class GINConv(nn.Module):
    def __init__(self, features: int, backend: str = "pallas", dtype=None):
        super().__init__()
        self.backend = backend
        self.dtype = dtype
        lin = functools.partial(nn.utils.skip_init, nn.Linear)
        self.nn = nn.Sequential(lin(features, features), nn.ReLU(),
                                lin(features, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_init_(self.nn[0], generator)
        lecun_init_(self.nn[2], generator)

    def forward(self, x: torch.Tensor, graph: Graph) -> torch.Tensor:
        adj = _plane(graph, "adj", self.backend)
        if adj is not None:
            agg = banded_spmm(adj, x, functools.partial(graph.band.transposed,
                                                        "adj"))
        elif self.backend == "segment":
            agg = sops.aggregate_sum(x, graph.senders, graph.receivers,
                                     graph.n_pad, edge_mask=graph.edge_mask)
        else:
            agg = dops.masked_sum(x, graph.nbr_idx, graph.nbr_mask)
        h = x + agg                        # (1 + eps)·x + Σ_nbr x, eps = 0
        h = torch.relu(dense(self.nn[0], h, self.dtype))
        return dense(self.nn[2], h, self.dtype)


class GATConv(nn.Module):
    def __init__(self, features: int, heads: int = 4, concat: bool = False,
                 negative_slope: float = 0.2, dropout: float = 0.0,
                 fuse_train: bool = True, backend: str = "pallas",
                 dtype=None):
        super().__init__()
        self.heads = heads
        self.features = features
        self.concat = concat
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.fuse_train = fuse_train
        self.backend = backend
        self.dtype = dtype
        self.lin = nn.utils.skip_init(nn.Linear, features, heads * features,
                                      bias=False)
        self.att_src = nn.Parameter(torch.empty(1, heads, features))
        self.att_dst = nn.Parameter(torch.empty(1, heads, features))
        self.bias = nn.Parameter(torch.empty(heads * features if concat
                                             else features))

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
                seed: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``train``: the training forms.  Attention dropout at
        ``self.dropout``: on the kernels masked from ``seed`` ([1] int32 on
        x's device), on the dense and segment branches drawn from
        ``generator``; without them, none."""
        mask = _plane(graph, "bias_self", self.backend)
        H, C = self.heads, self.features
        if mask is not None and not self.concat and (
                not train or self.fuse_train):
            return self._fused(x, mask, train, seed, graph.band)
        # z = x·W in the compute dtype, α = z·amat in f32 with amat in z's
        # dtype
        z = dense(self.lin, x, self.dtype)                     # [N, H·C]
        z3 = z.float().view(-1, H, C)
        alphas = torch.cat(
            [torch.einsum("nhc,hc->nh", z3, att[0].to(z.dtype).float())
             for att in (self.att_src, self.att_dst)], dim=1)
        if mask is not None:
            rate = self.dropout if seed is not None else 0.0
            op = banded_gat_packed if self.concat else banded_gat_mean_packed
            out = op(mask, z, alphas, H, self.negative_slope, rate, seed,
                     graph.band.transposed("bias_self"))
            return out + self.bias.to(out.dtype)
        rate = self.dropout if generator is not None else 0.0
        z3 = z.view(-1, H, C)
        a_src, a_dst = alphas[:, :H], alphas[:, H:]
        self_logit = _leaky(a_src + a_dst, self.negative_slope)   # [N, H]
        if self.backend == "segment":
            out = self._segment(z3, a_src, a_dst, self_logit, graph, rate,
                                generator)
        else:
            logits = _leaky(dops.gather_neighbors(a_src, graph.nbr_idx)
                            + a_dst[:, None, :],
                            self.negative_slope)                  # [N, D, H]
            if rate > 0:
                # the dropout acts on the softmax with the self slot
                n = x.shape[0]
                full = torch.cat([logits, self_logit[:, None, :]], dim=1)
                slots = torch.cat([graph.nbr_mask,
                                   graph.nbr_mask.new_ones((n, 1))], dim=1)
                attn = _dropped(dops.masked_softmax(full, slots), rate,
                                generator)
                z32 = z3.float()   # the f32 attention promotes z (exact)
                vals = torch.cat([dops.gather_neighbors(z32, graph.nbr_idx),
                                  z32[:, None]], dim=1)       # [N, D+1, H, C]
                out = dops.contract("ndh,ndhc->nhc", attn, vals)
            else:
                out = dops.attention_aggregate(
                    z3, logits, graph.nbr_idx, graph.nbr_mask,
                    self_logit=self_logit, self_value=z3)
        out = out.reshape(-1, H * C) if self.concat else out.mean(dim=1)
        return out + self.bias.to(out.dtype)

    def _fused(self, x, mask, train, seed, band):
        """The head-mean conv with the projection inside kernel 1."""
        H, C = self.heads, self.features
        dt = x.dtype
        rate = self.dropout if seed is not None else 0.0
        w = self.lin.weight.t().to(dt).contiguous()            # [F, H·C]
        # packed α factor wa = (W·amat) in f32, rounded to x's dtype:
        # wa[:, h] = Σ_c W[:, h·C + c]·att_src[h, c], then the dst half
        w3 = w.float().view(-1, H, C)
        wa = torch.cat([torch.einsum("fhc,hc->fh", w3, self.att_src[0]),
                        torch.einsum("fhc,hc->fh", w3, self.att_dst[0])],
                       dim=1).to(dt)
        if train:
            out = banded_gat_mean_fused_wa(mask, w, wa, x, H,
                                           self.negative_slope, rate, seed,
                                           band.transposed("bias_self"))
        else:
            alphas = x.float() @ wa.float()                    # [N, 2H] f32
            out = banded_gat_mean_fused(mask, w, alphas.contiguous(),
                                        x.contiguous(), H, self.negative_slope)
        return out + self.bias.to(dt)

    def _segment(self, z3, a_src, a_dst, self_logit, graph, rate, generator):
        """The softmax over {edges into i} ∪ {i} on the COO edges, f32."""
        s, r = graph.senders, graph.receivers
        rows = sops.gather_src   # index_select: its backward, one index_add_
        n = graph.n_pad
        e_logit = _leaky(rows(a_src, s) + rows(a_dst, r),
                         self.negative_slope)                      # [E, H]
        seg_max = sops.segment_max_to_nodes(e_logit, graph.receivers, n,
                                            graph.edge_mask)
        m = torch.maximum(seg_max, self_logit)
        e_exp = torch.exp(e_logit - rows(m, r))
        e_exp = torch.where(graph.edge_mask[:, None], e_exp, 0.0)
        s_exp = torch.exp(self_logit - m)
        denom = (sops.segment_sum_to_nodes(e_exp, graph.receivers, n)
                 + s_exp).clamp_min(1e-16)
        attn_e = e_exp / rows(denom, r)
        attn_s = s_exp / denom
        if rate > 0:
            # one [E_pad + N_pad, H] mask: the edges, then the self slots
            keep = bernoulli_keep((graph.e_pad + n, attn_e.shape[1]), rate,
                                  generator, attn_e.device)
            attn_e = attn_e * keep[:graph.e_pad] / (1 - rate)
            attn_s = attn_s * keep[graph.e_pad:] / (1 - rate)
        msg = rows(z3, s) * attn_e[:, :, None]
        out = sops.segment_sum_to_nodes(msg, graph.receivers, n,
                                        graph.edge_mask)
        return out + z3 * attn_s[:, :, None]


class TransformerConv(nn.Module):
    def __init__(self, features: int, heads: int = 4, concat: bool = False,
                 edge_dim: int | None = None, fuse_eval: bool = False,
                 dropout: float = 0.0, backend: str = "pallas", dtype=None):
        super().__init__()
        self.heads = heads
        self.features = features
        self.concat = concat
        self.edge_dim = edge_dim
        self.fuse_eval = fuse_eval
        self.dropout = dropout
        self.backend = backend
        self.dtype = dtype
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
                fused_ok: bool = True,
                generator: torch.Generator | None = None,
                use_edge: bool = True) -> torch.Tensor:
        """``train``: the training forms, the geo head-mean path through
        ``banded_transformer_geo_mean_projgrad`` (the JAX module's branch,
        which the port takes in training only).  Attention dropout at
        ``self.dropout``: on the kernels masked from ``seed`` ([1] int32 on
        x's device), on the dense and segment branches drawn from
        ``generator``.  ``fused_ok``: the forward is deterministic (the JAX
        module's ``deterministic``), so ``fuse_eval`` may take row 11 in
        eval; the ``exact_bn`` forward passes False, as the JAX package runs
        it in train mode.  ``use_edge`` False: the conv as built without
        ``edge_dim`` (the partitioned model's ``edge_ok`` rule)."""
        edge_dim = self.edge_dim if use_edge else None
        mask = _plane(graph, "bias_noself", self.backend)
        band = graph.band
        if mask is not None and edge_dim is not None and (
                band.geo is None and band.edge is None):
            mask = None          # edge conditioning needs geo or edge planes
        if mask is None:
            out = self._unbanded(x, graph, generator, edge_dim)
        else:
            out = self._banded(x, mask, band, train, seed, fused_ok,
                               edge_dim)
        return out + dense(self.lin_skip, x, self.dtype)

    def _banded(self, x, mask, band, train, seed, fused_ok, edge_dim):
        H, C = self.heads, self.features
        dt = x.dtype
        rate = self.dropout if seed is not None else 0.0
        if edge_dim is None:
            q, k, v = (dense(m, x) for m in
                       (self.lin_query, self.lin_key, self.lin_value))
            return banded_transformer_fwd(mask, q, k, v, H,
                                          mean_heads=not self.concat,
                                          dropout_rate=rate, seed=seed)
        d_e = edge_dim
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
                    mask, band.geo, band.pos, x, *ws, *bs, w_blk, H, rate,
                    seed)
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
            return out.reshape(-1, H * C)
        # Σ_h p·e_ij / H as one [N, H·D_e] @ [H·D_e, C] product
        w_flat = w_e.permute(1, 0, 2).reshape(H * d_e, C)
        edge_term = (s @ w_flat.float()) * (1.0 / H)
        return out + edge_term.to(out.dtype)

    def _unbanded(self, x, graph, generator, edge_dim):
        """The dense and segment branches: k and v conditioned on the
        per-edge ``edge_kv = lin_edge(edge_feat)``, logits scaled by 1/√C in
        x's dtype, the softmax in f32."""
        H, C = self.heads, self.features
        rate = self.dropout if generator is not None else 0.0
        q, k, v = (dense(m, x, self.dtype).view(-1, H, C) for m in
                   (self.lin_query, self.lin_key, self.lin_value))
        # a CPU scalar: no host-to-device copy, so the step captures into
        # a CUDA graph
        scale = 1.0 / torch.sqrt(torch.tensor(float(C), dtype=x.dtype))
        edge_kv = None
        if edge_dim is not None:
            edge_kv = dense(self.lin_edge, graph.edge_feat,
                            self.dtype).view(-1, H, C)

        def scaled(logits):      # JAX's promotion of logits · scale
            dt = torch.promote_types(logits.dtype, scale.dtype)
            return logits.to(dt) * scale.to(dt)

        if self.backend == "segment":
            s, r = graph.senders, graph.receivers
            k_e, v_e = sops.gather_src(k, s), sops.gather_src(v, s)
            if edge_kv is not None:
                k_e, v_e = k_e + edge_kv, v_e + edge_kv
            logits = scaled((sops.gather_src(q, r) * k_e).sum(dim=-1))
            attn = sops.edge_softmax(logits, graph.receivers, graph.n_pad,
                                     graph.edge_mask)
            if rate > 0:
                attn = _dropped(attn, rate, generator)
            out = sops.segment_sum_to_nodes(v_e * attn[:, :, None],
                                            graph.receivers, graph.n_pad,
                                            graph.edge_mask)
        else:
            k_n = dops.gather_neighbors(k, graph.nbr_idx)      # [N, D, H, C]
            v_n = dops.gather_neighbors(v, graph.nbr_idx)
            if edge_kv is not None:
                e_n = dops.gather_neighbors(edge_kv, graph.nbr_edge)
                k_n, v_n = k_n + e_n, v_n + e_n
            logits = scaled(dops.contract("nhc,ndhc->ndh", q, k_n))
            attn = dops.masked_softmax(logits, graph.nbr_mask, axis=1)
            if rate > 0:
                attn = _dropped(attn, rate, generator)
            out = dops.contract("ndh,ndhc->nhc", attn, v_n)
        return out.reshape(-1, H * C) if self.concat else out.mean(dim=1)


# the conv class of each layer type (JAX ``convs.py:621-626``)
CONV_REGISTRY = {
    "GCN": GCNConv,
    "GAT": GATConv,
    "GIN": GINConv,
    "Transformer": TransformerConv,
}
