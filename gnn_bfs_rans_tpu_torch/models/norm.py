"""Masked batch normalization: running-stats eval and the batch-stats forward.

Counterpart of ``gnn_bfs_rans_tpu/models/norm.py``.  ``MaskedBatchNorm``
normalizes in eval mode with the running statistics in the exact
mean-centred form of the JAX module (``norm.py:79-85``):
``(x − m̃)·a + b̃`` in x's dtype, with m̃ the mean rounded to x's dtype and
its rounding error folded into b̃ in f32.  ``nn.BatchNorm1d`` is not used:
it rounds at other points in bf16.  ``batch_forward`` is
``FusedEpilogueBN``'s train-mode forward at dropout 0 (residual add +
batch statistics over the real rows + ReLU, one fused op), the ``exact_bn``
serving mode; it leaves the running statistics untouched.
``train_forward`` is ``FusedEpilogueBN`` in training (``norm.py:88-156``):
the differentiable fused op with dropout, then the running-statistics
update (momentum 0.1, running var from the unbiased var·n/(n − 1)).  It
keeps the batch statistics it used (``batch_stats``) for the exact
recalibration (``train/recal.py``).
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
        dt = x.dtype
        mean = self.running_mean
        eff_scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        mean_lo = mean.to(dt)
        eff_bias = self.bias + (mean_lo.float() - mean) * eff_scale
        return (x - mean_lo) * eff_scale.to(dt) + eff_bias.to(dt)

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
