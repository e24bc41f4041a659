"""COO aggregation primitives: the ``segment`` backend.

Counterpart of ``gnn_bfs_rans_tpu/ops/segment.py`` (the JAX package's
``jax.ops.segment_*`` ground truth), as plain torch: ``index_select`` for
the per-edge gather, ``index_add_`` for the scatter-add and
``scatter_reduce(amax)`` for the per-receiver max.  Edges are
receiver-sorted (``graph.structs``).  Dtypes follow JAX's promotion: the
result of a product takes the wider of its operands' types.  An empty
segment (a padding row, or a receiver without edges) sums to 0 and its max
is −inf, as ``jax.ops.segment_max`` gives; ``edge_softmax`` clamps that max
to −1e30 and the denominator to 1e-16, as the JAX function does.
"""

from __future__ import annotations

import torch


def _bcast(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[E] → [E, 1, ...] against ``like`` [E, ...]."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def gather_src(x: torch.Tensor, senders: torch.Tensor) -> torch.Tensor:
    """Per-edge source-node features ``x[senders]`` → [E, ...]."""
    return x.index_select(0, senders.long())


def segment_sum_to_nodes(messages: torch.Tensor, receivers: torch.Tensor,
                         num_nodes: int,
                         edge_mask: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """Scatter-add per-edge messages to their receiver nodes → [N, ...] in
    the messages' dtype."""
    if edge_mask is not None:
        messages = torch.where(_bcast(edge_mask, messages), messages, 0.0)
    out = messages.new_zeros((num_nodes, *messages.shape[1:]))
    return out.index_add_(0, receivers.long(), messages)


def segment_max_to_nodes(values: torch.Tensor, receivers: torch.Tensor,
                         num_nodes: int,
                         edge_mask: torch.Tensor | None = None,
                         neg_fill: float = -1e30) -> torch.Tensor:
    """Per-receiver max of per-edge values (masked edges count as
    ``neg_fill``); −inf where a receiver has no edge."""
    if edge_mask is not None:
        values = torch.where(_bcast(edge_mask, values), values, neg_fill)
    out = values.new_full((num_nodes, *values.shape[1:]), float("-inf"))
    idx = _bcast(receivers.long(), values).expand_as(values)
    return out.scatter_reduce(0, idx, values, "amax", include_self=True)


def edge_softmax(logits: torch.Tensor, receivers: torch.Tensor,
                 num_nodes: int,
                 edge_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Softmax over each receiver's incoming edges, in f32: ``logits`` [E]
    or [E, H]; masked edges get weight 0."""
    logits = logits.float()
    seg_max = segment_max_to_nodes(logits, receivers, num_nodes, edge_mask)
    seg_max = seg_max.clamp_min(-1e30)       # empty segments
    r = receivers.long()
    expv = torch.exp(logits - seg_max.index_select(0, r))
    if edge_mask is not None:
        expv = torch.where(_bcast(edge_mask, expv), expv, 0.0)
    denom = segment_sum_to_nodes(expv, receivers, num_nodes).clamp_min(1e-16)
    return expv / denom.index_select(0, r)


def aggregate_sum(x: torch.Tensor, senders: torch.Tensor,
                  receivers: torch.Tensor, num_nodes: int,
                  edge_mask: torch.Tensor | None = None,
                  edge_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted scatter-add of source features: out[i] = Σ_{j→i} w_ij x_j."""
    msg = gather_src(x, senders)
    if edge_weight is not None:
        msg = msg * _bcast(edge_weight, msg)
    return segment_sum_to_nodes(msg, receivers, num_nodes, edge_mask)
