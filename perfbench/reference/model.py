"""The reference's building blocks, its precisions and its loss.

:func:`Forward` gives the plain forward of a configuration, found by its
``layer_type`` (``archs/``): in float32, products with TF32 off, with no
kernel, band or graph replay, the training dropout following the
configuration's stream (:mod:`.stream`).  The blocks here serve every
architecture: the rounding of a precision (:func:`quantizer`,
:func:`products`), a linear layer, the edge-chunked aggregation and dot
product with their backward, the softmax over each receiver's edges.

The precisions (``quant``):

* ``f32``: the reference;
* ``fp8`` (the control of a bfloat16 configuration): the same model in
  8-bit floats as the program computes in bfloat16 — every product's
  operands and result, every activation the model keeps and the gradients
  flowing through them rounded to 8 bits (e4m3 forward, e5m2 backward,
  one scale a tensor), the precision below bfloat16;
* ``tf32`` (the control of a float32 configuration): every product of a
  linear layer in TF32, as cuBLAS computes with TF32 on — both operands
  rounded to TF32's 10-bit mantissa (to nearest, ties away from zero, as
  PTX ``cvt.rna.tf32.f32``), forward and backward, sums in float32; the
  rest in float32.
"""

from __future__ import annotations

import torch

from . import archs

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


def _tf32(x: torch.Tensor) -> torch.Tensor:
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Mm(torch.autograd.Function):
    """``a @ b`` of 2-D operands in TF32, and its backward alike."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = _tf32(a), _tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = _tf32(g)
        return rg @ rb.t(), ra.t() @ rg


PRECISIONS = ("f32", "fp8", "tf32")
# the control of each compute dtype: the precision below it
CONTROL = {"bfloat16": "fp8", "mixed": "fp8", "float32": "tf32"}


def control_precision(cfg: dict) -> str:
    return CONTROL[cfg["compute_dtype"]]


def quantizer(quant: str):
    """The rounding of a value the model keeps."""
    if quant in ("f32", "tf32"):
        return lambda t: t
    if quant == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown precision {quant!r}")


def products(quant: str):
    """A linear layer's product."""
    if quant not in PRECISIONS:
        raise ValueError(f"unknown precision {quant!r}")
    return _Tf32Mm.apply if quant == "tf32" else torch.matmul


class Aggregate(torch.autograd.Function):
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


class EdgeDot(torch.autograd.Function):
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


def softmax(logit: torch.Tensor, r: torch.Tensor, n: int) -> torch.Tensor:
    m = torch.full((n, logit.shape[1]), -torch.inf, device=logit.device)
    m = m.scatter_reduce(0, r[:, None].expand_as(logit), logit.detach(),
                         "amax", include_self=True)
    e = torch.exp(logit - m[r])
    den = torch.zeros((n, logit.shape[1]), device=logit.device)
    den = den.index_add(0, r, e)
    return e / den[r]


def linear(p, name, x, q, bias=True, mm=torch.matmul):
    y = mm(q(x), q(p[f"{name}.weight"]).t())
    return q(y + p[f"{name}.bias"] if bias else y)


def Forward(cfg: dict, graph, quant: str = "f32"):
    """``Forward(cfg, graph, quant)(p, stats, x, mode, gen)`` → [n, 7].

    ``p``: parameters by name; ``stats``: the running statistics by name
    (updated in place by a training forward); ``x`` [n, 3] f32 row
    coordinates; ``mode``: ``train``, ``exact`` (batch statistics, the
    running ones untouched, no dropout) or ``eval`` (running
    statistics); ``gen``: the training generator (on the graph's
    device), from which the dropout seeds and masks are drawn."""
    return archs.load(cfg).Forward(cfg, graph, quant)


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
