"""Masked batch normalization and LayerNorm.

Counterpart of ``gnn_bfs_rans_tpu/models/norm.py`` and of the flax
``nn.LayerNorm`` FlowGNN uses with ``norm_type='layer'``.

``MaskedBatchNorm`` normalizes in eval mode with the running statistics in
the exact mean-centred form of the JAX module (``norm.py:79-85``):
``(x − m̃)·a + b̃`` in x's dtype, with m̃ the mean rounded to x's dtype and
its rounding error folded into b̃ in f32.  ``nn.BatchNorm1d`` is not used:
it rounds at other points in bf16.  ``batch_norm`` is the JAX module's
train-mode forward (``norm.py:44-86``), the unfused path of every backend
but ``pallas`` with the fused epilogue: f32 masked sums over
``node_mask`` (the mean, then the biased variance of the centred values),
the same affine in x's dtype, and with ``update`` the running-statistics
update (momentum 0.1, running var from the unbiased var·n/(n − 1)).
``batch_forward`` is ``FusedEpilogueBN``'s train-mode forward at dropout 0
(residual add + batch statistics over the real rows + ReLU, one fused op),
the ``exact_bn`` serving mode; it leaves the running statistics untouched.
``train_forward`` is ``FusedEpilogueBN`` in training (``norm.py:88-156``):
the differentiable fused op with dropout, then the running-statistics
update.  Both training forms keep the batch statistics they used
(``batch_stats``) for the exact recalibration (``train/recal.py``).

``LayerNorm`` is flax's ``nn.LayerNorm`` as the installed flax (0.12)
computes it: per-row statistics over the features in f32 whatever x's
dtype (``force_float32_reductions``), the variance as E[x²] − E[x]²
clamped at 0 (``use_fast_variance``), ``(x − mean)·(rsqrt(var + ε)·scale)
+ bias`` in f32, rounded once to ``dtype`` (None: the promotion of x's
dtype and f32); parameters ``scale`` and ``bias``, ε 1e-6.
"""

from __future__ import annotations

import torch
from torch import nn

from ..kernels.epilogue import fused_epilogue, fused_epilogue_fwd

MOMENTUM = 0.1   # flax BatchNorm(momentum=0.9): new = 0.9·old + 0.1·batch


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        # (mean, unbiased var) of the last train_forward's batch
        self.batch_stats: tuple[torch.Tensor, torch.Tensor] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Eval-mode affine with the running statistics."""
        return self._affine(x, self.running_mean, self.running_var)

    def _affine(self, x, mean, var):
        """``(x − m̃)·a + b̃`` in x's dtype, a = scale·rsqrt(var + ε)."""
        dt = x.dtype
        eff_scale = self.weight * torch.rsqrt(var + self.eps)
        mean_lo = mean.to(dt)
        eff_bias = self.bias + (mean_lo.float() - mean) * eff_scale
        return (x - mean_lo) * eff_scale.to(dt) + eff_bias.to(dt)

    def batch_norm(self, x: torch.Tensor, node_mask: torch.Tensor,
                   update: bool = True, group=None) -> torch.Tensor:
        """Train-mode BatchNorm with the batch statistics of the rows under
        ``node_mask``; with ``update`` also the running-statistics update.
        ``group``: the rows are one shard of a node-partitioned graph
        (``axis_name``); the masked count and sums are summed over the
        group's ranks in the JAX module's order: each shard's count
        max(Σmask, 1), then the sums of the counts and totals, the mean,
        the sum of Σ(x − mean)²·mask, the biased variance.  The sums are
        differentiable (``parallel.distributed.psum``)."""
        from ..parallel.distributed import psum

        xf = x.float()
        m = node_mask.float()[:, None]
        count = m.sum().clamp_min(1.0)
        total = (xf * m).sum(0)
        if group is not None:
            count = psum(count, group)
            total = psum(total, group)
        mean = total / count
        sq = (((xf - mean) ** 2) * m).sum(0)
        if group is not None:
            sq = psum(sq, group)
        var = sq / count                                    # biased
        if update:
            with torch.no_grad():
                unbiased = var * count / (count - 1.0).clamp_min(1.0)
                self.batch_stats = (mean.detach(), unbiased.detach())
                k = MOMENTUM
                self.running_mean.copy_((1 - k) * self.running_mean
                                        + k * mean)
                self.running_var.copy_((1 - k) * self.running_var
                                       + k * unbiased)
        return self._affine(x, mean, var)

    def batch_forward(self, x: torch.Tensor, x_new: torch.Tensor,
                      n_valid: int) -> torch.Tensor:
        """relu(BN(x + x_new)) with the batch statistics of rows < n_valid."""
        y, _, _ = fused_epilogue_fwd(x, x_new, self.weight, self.bias,
                                     n_valid, self.eps)
        return y

    def train_forward(self, x: torch.Tensor, x_new: torch.Tensor,
                      n_valid: int, rate: float = 0.0,
                      seed: torch.Tensor | None = None) -> torch.Tensor:
        """dropout(relu(BN(x + x_new))) with batch statistics, and the
        running-statistics update."""
        y, mean, var = fused_epilogue(x, x_new, self.weight, self.bias, seed,
                                      n_valid, rate if seed is not None
                                      else 0.0, self.eps)
        with torch.no_grad():
            count = float(n_valid)
            unbiased = var * count / max(count - 1.0, 1.0)
            self.batch_stats = (mean.detach(), unbiased.detach())
            m = MOMENTUM
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * unbiased)
        return y


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last axis (see the module doc)."""

    def __init__(self, features: int, eps: float = 1e-6, dtype=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        y = y + self.bias
        dt = (torch.promote_types(x.dtype, torch.float32) if self.dtype is None
              else self.dtype)
        return y.to(dt)
