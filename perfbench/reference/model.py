"""Plain PyTorch forward of the FlowGNN configurations, in float32.

The model as its configuration states it, with no kernel, band or graph
replay: ``Linear(3→H)``; per layer a conv, the residual add, BatchNorm
(``mode='train'``: the batch statistics of the real rows, momentum 0.1
and the unbiased variance into the running statistics; ``'exact'``: the
batch statistics, the running ones untouched, no dropout — the eval of a
bfloat16 model trained with BatchNorm recalibration; ``'eval'``: the
running statistics), ReLU and dropout; then the MLP ``H→H→H→H/2→7``
with dropout after its first two ReLUs.

* GAT (PyG ``GATConv``, head mean): ``z = x·Wᵀ``; logits
  ``LeakyReLU_0.2(a_dst·z_i + a_src·z_j)`` over each receiver's senders
  and itself; softmax; attention dropout; ``mean_h Σ_j α z_j`` + bias.
* Transformer (PyG ``TransformerConv``, ``concat=False``, ``edge_dim``
  4, root weight): ``q, k, v = x·Wᵀ + b``, ``e_ij = W_e·edge_ij``; logits
  ``q_i·(k_j + e_ij)/√C`` over the senders; softmax; attention dropout;
  ``mean_h Σ_j α (v_j + e_ij)`` + ``lin_skip(x)``.

The training dropout follows the configuration's stream (:mod:`.stream`).
Products run in float32 with TF32 off.  ``quant='fp8'`` is the control:
the same model computed in 8-bit floats as the program computes in
bfloat16 — every product's operands and result, every activation the
model keeps (the residual stream, each conv's output, the normalized and
dropped activations, the MLP's) and the gradients flowing through them
rounded to 8 bits (e4m3 forward, e5m2 backward, one scale a tensor), the
precision below the configurations' bfloat16.
"""

from __future__ import annotations

import torch

from . import stream

_CHUNK = 1 << 16
_E4M3_MAX = 448.0
_E5M2_MAX = 57344.0


def _fake8(x: torch.Tensor, dtype, top: float) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fake8(x, torch.float8_e4m3fn, _E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _fake8(g, torch.float8_e5m2, _E5M2_MAX)


def quantizer(quant: str):
    if quant == "f32":
        return lambda t: t
    if quant == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown precision {quant!r}")


class _Aggregate(torch.autograd.Function):
    """out[r] += α[e, h]·v[s, h, :] over the edges, in chunks of edges."""

    @staticmethod
    def forward(ctx, alpha, v, s, r, n):
        out = torch.zeros((n,) + v.shape[1:], dtype=v.dtype, device=v.device)
        for a in range(0, s.shape[0], _CHUNK):
            b = a + _CHUNK
            out.index_add_(0, r[a:b], alpha[a:b, :, None] * v[s[a:b]])
        ctx.save_for_backward(alpha, v, s, r)
        return out

    @staticmethod
    def backward(ctx, g):
        alpha, v, s, r = ctx.saved_tensors
        d_alpha = torch.empty_like(alpha)
        d_v = torch.zeros_like(v)
        for a in range(0, s.shape[0], _CHUNK):
            b = a + _CHUNK
            gr = g[r[a:b]]
            d_alpha[a:b] = (gr * v[s[a:b]]).sum(-1)
            d_v.index_add_(0, s[a:b], alpha[a:b, :, None] * gr)
        return d_alpha, d_v, None, None, None


class _EdgeDot(torch.autograd.Function):
    """⟨q[r, h], k[s, h]⟩ per edge and head, in chunks of edges."""

    @staticmethod
    def forward(ctx, q, k, s, r):
        out = torch.empty((s.shape[0], q.shape[1]), dtype=q.dtype,
                          device=q.device)
        for a in range(0, s.shape[0], _CHUNK):
            b = a + _CHUNK
            out[a:b] = (q[r[a:b]] * k[s[a:b]]).sum(-1)
        ctx.save_for_backward(q, k, s, r)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, s, r = ctx.saved_tensors
        dq, dk = torch.zeros_like(q), torch.zeros_like(k)
        for a in range(0, s.shape[0], _CHUNK):
            b = a + _CHUNK
            ge = g[a:b, :, None]
            dq.index_add_(0, r[a:b], ge * k[s[a:b]])
            dk.index_add_(0, s[a:b], ge * q[r[a:b]])
        return dq, dk, None, None


def _softmax(logit: torch.Tensor, r: torch.Tensor, n: int) -> torch.Tensor:
    m = torch.full((n, logit.shape[1]), -torch.inf, device=logit.device)
    m = m.scatter_reduce(0, r[:, None].expand_as(logit), logit.detach(),
                         "amax", include_self=True)
    e = torch.exp(logit - m[r])
    den = torch.zeros((n, logit.shape[1]), device=logit.device)
    den = den.index_add(0, r, e)
    return e / den[r]


def _linear(p, name, x, q, bias=True):
    y = q(x) @ q(p[f"{name}.weight"]).t()
    return q(y + p[f"{name}.bias"] if bias else y)


class Forward:
    """``Forward(cfg, graph, quant)(p, stats, x, mode, gen)`` → [n, 7].

    ``p``: parameters by name; ``stats``: the running statistics by name
    (updated in place by a training forward); ``x`` [n, 3] f32 row
    coordinates; ``gen``: the training generator (on the graph's
    device), from which the dropout seeds and masks are drawn."""

    def __init__(self, cfg: dict, graph, quant: str = "f32"):
        self.cfg = cfg
        self.g = graph
        self.q = quantizer(quant)
        self.rate = cfg["dropout"]
        self.itemsize = 2 if cfg["compute_dtype"] in ("bfloat16",
                                                      "mixed") else 4
        n = graph.n
        dev = graph.senders.device
        if cfg["layer_type"] == "GAT":
            # each receiver's senders and itself
            ar = torch.arange(n, device=dev)
            self.s = torch.cat([graph.senders, ar])
            self.r = torch.cat([graph.receivers, ar])
            self.cols = torch.cat([graph.col, graph.self_col])
        else:
            self.s, self.r, self.cols = graph.senders, graph.receivers, \
                graph.col

    def __call__(self, p, stats, x, mode: str, gen=None) -> torch.Tensor:
        cfg, g, q = self.cfg, self.g, self.q
        dev = x.device
        rate = self.rate if mode == "train" else 0.0
        x = _linear(p, "input_proj", x, q)
        for i in range(cfg["num_layers"]):
            seed = stream.draw_seed(gen, dev) if rate > 0 else None
            conv = (self._gat if cfg["layer_type"] == "GAT"
                    else self._transformer)
            x_res = q(x + q(conv(p, f"convs.{i}", x, rate, seed)))
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
            h = torch.relu(_linear(p, name, h, q))
            if rate > 0 and j < 2:
                keep = torch.rand((g.n_pad, h.shape[1]), generator=gen,
                                  device=dev) < 1.0 - rate
                h = q(torch.where(keep[:g.n], h / (1.0 - rate), 0.0))
        return _linear(p, "out_3", h, q)

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

    def _gat(self, p, name, x, rate, seed):
        g, q = self.g, self.q
        heads, c = self.cfg["heads"], self.cfg["hidden_dim"]
        z = _linear(p, f"{name}.lin", x, q, bias=False).view(-1, heads, c)
        a_src = (z * p[f"{name}.att_src"]).sum(-1)
        a_dst = (z * p[f"{name}.att_dst"]).sum(-1)
        logit = torch.nn.functional.leaky_relu(a_dst[self.r] + a_src[self.s],
                                               0.2)
        alpha = _softmax(logit, self.r, g.n)
        if rate > 0:
            k = stream.gat_attention_keep(seed, self.r, self.cols, heads,
                                          g.width, rate, 128)
            alpha = torch.where(k, alpha / (1.0 - rate), 0.0)
        out = _Aggregate.apply(alpha, q(z), self.s, self.r, g.n)
        return out.mean(1) + p[f"{name}.bias"]

    def _transformer(self, p, name, x, rate, seed):
        g, q = self.g, self.q
        heads, c = self.cfg["heads"], self.cfg["hidden_dim"]
        s, r = self.s, self.r
        qq, kk, vv = (_linear(p, f"{name}.{m}", x, q).view(-1, heads, c)
                      for m in ("lin_query", "lin_key", "lin_value"))
        # W_e [H, C, D]: e_ij = W_e·edge_ij per head
        w_e = p[f"{name}.lin_edge.weight"].view(heads, c, -1)
        ef = g.edge_feat
        qw = torch.einsum("nhc,hcd->nhd", q(qq), q(w_e))
        logit = (_EdgeDot.apply(q(qq), q(kk), s, r)
                 + (qw[r] * ef[:, None, :]).sum(-1)) / c ** 0.5
        alpha = _softmax(logit, r, g.n)
        if rate > 0:
            k = stream.transformer_attention_keep(seed, r, self.cols, heads,
                                                  g.width, rate, 128)
            alpha = torch.where(k, alpha / (1.0 - rate), 0.0)
        out = _Aggregate.apply(alpha, q(vv), s, r, g.n)
        sums = torch.zeros((g.n, heads, ef.shape[1]), device=x.device)
        sums = sums.index_add(0, r, alpha[:, :, None] * ef[:, None, :])
        out = out + torch.einsum("nhd,hcd->nhc", q(sums), q(w_e))
        return out.mean(1) + _linear(p, f"{name}.lin_skip", x, q)


FIELD_WEIGHTS = (1.0, 3.0, 0.5, 0.5, 0.5)


def loss(pred: torch.Tensor, target: torch.Tensor,
         pressure_ref_weight: float = 0.1) -> torch.Tensor:
    """The field-weighted MSE with the pressure-mean anchor over the real
    rows of one snapshot: U's three components as one mean, then p
    (+ the anchor on its mean), k, epsilon, nut."""
    sq = (pred - target) ** 2
    u = sq[:, 0:3].mean()
    pl = sq[:, 3].mean() + pressure_ref_weight * (
        pred[:, 3].mean() - target[:, 3].mean()) ** 2
    w = FIELD_WEIGHTS
    return (w[0] * u + w[1] * pl + w[2] * sq[:, 4].mean()
            + w[3] * sq[:, 5].mean() + w[4] * sq[:, 6].mean())
