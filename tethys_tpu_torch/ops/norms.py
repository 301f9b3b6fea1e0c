"""Normalisation layers (tethys_tpu/ops/norms.py, flax LayerNorm).

``LayerNorm``: flax's LayerNorm with ``dtype=``: the parameters are cast to
the input's dtype; torch's kernel keeps the statistics in f32.

``ReferenceGroupNorm``: Wav2Vec2's GroupNorm with the reference's two
choices (num_conv_pos_embedding_groups groups; moments over time and the
channels of a group jointly), as an autograd Function holding the JAX
custom VJP (norms.py:42-120), built from ops/group_norm.py's four entry
points (kernels on the card, plain versions on the CPU):
- forward: ``group_moments`` (mean, var, rstd = rsqrt(var + eps)), then
  ``apply``, y = gamma * ((x - mu) * rstd) + beta in f32, rounded once to
  the module's dtype;
- backward, the closed form, with S the (T, C/G) set of a (batch, group):
      dx = r * (dy g - mean_S(dy g) - xhat * mean_S(dy g xhat))
      dgamma = sum_{b,t} dy xhat,  dbeta = sum_{b,t} dy,
  as ``grad_sums`` (the per-channel sums and the two group means) and
  ``apply_bwd``.
The kernels take x and dy of one dtype, so on the card the module's dtype
must be x's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tethys_tpu_torch.ops import group_norm


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose parameters are cast to the input's dtype; the
    statistics are f32 inside torch's kernel, as in flax's dtype=bf16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class GroupNormFunction(torch.autograd.Function):
    """y = gamma * (x - mu_g) * rsqrt(var_g + eps) + beta, in ``dtype``."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float,
                dtype: torch.dtype):
        mean_g, _, rstd_g = group_norm.group_moments(x, groups, eps)
        y = group_norm.apply(x, gamma, beta, mean_g, rstd_g, groups, dtype)
        ctx.save_for_backward(x, mean_g, rstd_g, gamma)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean_g, rstd_g, gamma = ctx.saved_tensors
        groups = ctx.groups
        dy = dy.contiguous()
        sums, s = group_norm.grad_sums(x, dy, mean_g, rstd_g, gamma, groups)
        dx = group_norm.apply_bwd(x, dy, gamma, mean_g, rstd_g, s, groups)
        dgamma, dbeta = sums.sum(dim=1)
        return dx, dgamma, dbeta, None, None, None


class ReferenceGroupNorm(nn.Module):
    """GroupNorm over [B, T, C] with reference semantics; f32 ``gamma`` and
    ``beta`` (the flax names), output in ``dtype``."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % groups:
            raise ValueError(f"channels ({channels}) must be divisible by "
                             f"groups ({groups})")
        self.groups = groups
        self.eps = eps
        self.dtype = dtype
        self.gamma = nn.Parameter(torch.ones(channels))
        self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return GroupNormFunction.apply(x.contiguous(), self.gamma, self.beta,
                                       self.groups, float(self.eps),
                                       self.dtype)
