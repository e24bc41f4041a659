"""Padded-neighbour aggregation: the ``dense`` backend.

Counterpart of ``gnn_bfs_rans_tpu/ops/dense.py``: each receiver gathers
its ``D_max`` neighbour rows (``graph.nbr_idx``) and reduces over the slot
axis under ``graph.nbr_mask``.  Shapes: ``nbr_idx`` / ``nbr_mask`` [N, D],
features [N, ...].  Dtypes follow JAX's promotion: a weighted sum or an
attention product takes the wider of its operands' types (f32 weights on
bf16 values give f32), and the contraction accumulates in f32 and rounds
once to that type, as XLA's CPU dot does; the softmax runs in f32 whatever
its input's dtype.
"""

from __future__ import annotations

import torch


def gather_neighbors(x: torch.Tensor, nbr_idx: torch.Tensor) -> torch.Tensor:
    """[N, ...] → [N, D, ...] neighbour features (``index_select``, whose
    backward is one ``index_add_``)."""
    rows = x.index_select(0, nbr_idx.reshape(-1).long())
    return rows.view(*nbr_idx.shape, *x.shape[1:])


def contract(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(spec, a, b)`` in the promoted dtype of a and b, accumulated
    in f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.float(), b.float()).to(dt)


def masked_sum(x: torch.Tensor, nbr_idx: torch.Tensor,
               nbr_mask: torch.Tensor,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """out[i] = Σ_d mask[i, d] · w[i, d] · x[nbr_idx[i, d]] → [N, ...]."""
    w = nbr_mask.to(x.dtype)
    if weight is not None:
        w = w * weight
    # x widened before the gather (exact) rather than its D-fold gather
    nbr = gather_neighbors(x.to(torch.promote_types(w.dtype, x.dtype)),
                           nbr_idx)
    return contract("nd,nd...->n...", w, nbr)


def masked_softmax(logits: torch.Tensor, nbr_mask: torch.Tensor,
                   axis: int = 1) -> torch.Tensor:
    """Softmax over the neighbour-slot axis in f32, masked slots 0:
    ``logits`` [N, D] or [N, D, H]; a row without a valid slot gives 0."""
    mask = nbr_mask[:, :, None] if logits.dim() == 3 else nbr_mask
    logits = logits.float()
    masked = torch.where(mask, logits, -1e30)
    m = masked.amax(dim=axis, keepdim=True).clamp_min(-1e30)
    e = torch.where(mask, torch.exp(masked - m), 0.0)
    denom = e.sum(dim=axis, keepdim=True)
    return e / denom.clamp_min(1e-16)


def attention_aggregate(values: torch.Tensor, logits: torch.Tensor,
                        nbr_idx: torch.Tensor, nbr_mask: torch.Tensor,
                        self_logit: torch.Tensor | None = None,
                        self_value: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Multi-head neighbour attention → [N, H, C]: ``values`` [N, H, C],
    ``logits`` [N, D, H], softmax over the slots plus the optional self
    slot (``self_logit`` [N, H], ``self_value`` [N, H, C])."""
    n = logits.shape[0]
    # the f32 softmax promotes the values: widen before the gather (exact)
    values = values.to(torch.promote_types(values.dtype, torch.float32))
    if self_value is not None:
        self_value = self_value.to(values.dtype)
    nbr_vals = gather_neighbors(values, nbr_idx)          # [N, D, H, C]
    mask = nbr_mask
    if self_logit is not None:
        logits = torch.cat([logits, self_logit[:, None, :]], dim=1)
        mask = torch.cat([nbr_mask, nbr_mask.new_ones((n, 1))], dim=1)
        nbr_vals = torch.cat([nbr_vals, self_value[:, None]], dim=1)
    attn = masked_softmax(logits, mask, axis=1)           # [N, D(+1), H]
    return contract("ndh,ndhc->nhc", attn, nbr_vals)
