"""Normalisation layers (tethys_tpu/ops/norms.py, flax LayerNorm).

``LayerNorm``: flax's LayerNorm with ``dtype=``: the parameters are cast to
the input's dtype; torch's kernel keeps the statistics in f32.

``ReferenceGroupNorm``: Wav2Vec2's GroupNorm with the reference's two
choices (num_conv_pos_embedding_groups groups; moments over time and the
channels of a group jointly), as an autograd Function holding the JAX
custom VJP (norms.py:42-120):
- forward: ``group_moments`` (the gn_stats kernel on the card), then
  ``gamma * (x - mu) * r + beta`` in f32, r = rsqrt(var + eps);
- backward, the closed form in plain torch (the JAX backward is no Pallas
  kernel either), with S the (T, C/G) set of a (batch, group):
      dx = r * (dy g - mean_S(dy g) - xhat * mean_S(dy g xhat))
      dgamma = sum_{b,t} dy xhat,  dbeta = sum_{b,t} dy.
The module returns the compute dtype (norms.py:157).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tethys_tpu_torch.ops.group_norm import group_moments


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose parameters are cast to the input's dtype; the
    statistics are f32 inside torch's kernel, as in flax's dtype=bf16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


def _spread(v: torch.Tensor, pg: int) -> torch.Tensor:
    """[B, G] -> [B, 1, C]."""
    return v.repeat_interleave(pg, dim=-1)[:, None, :]


def _fold(per_channel: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, C] -> [B, G] sums."""
    b, c = per_channel.shape
    return per_channel.view(b, groups, c // groups).sum(dim=-1)


class GroupNormFunction(torch.autograd.Function):
    """y = gamma * (x - mu_g) * rsqrt(var_g + eps) + beta, f32 out."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float):
        pg = x.shape[-1] // groups
        mean_g, var_g = group_moments(x, groups)
        rstd_g = torch.rsqrt(var_g + eps)
        xhat = (x.float() - _spread(mean_g, pg)) * _spread(rstd_g, pg)
        y = gamma * xhat + beta
        ctx.save_for_backward(x, mean_g, rstd_g, gamma)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mean_g, rstd_g, gamma = ctx.saved_tensors
        groups = ctx.groups
        _, t, c = x.shape
        pg = c // groups
        n = t * pg
        r = _spread(rstd_g, pg)
        dyf = dy.float()
        xhat = (x.float() - _spread(mean_g, pg)) * r
        a = (dyf * xhat).sum(dim=1)              # [B, C]
        s = dyf.sum(dim=1)                       # [B, C]
        s1 = _spread(_fold(s * gamma, groups) / n, pg)
        s2 = _spread(_fold(a * gamma, groups) / n, pg)
        dx = r * (dyf * gamma - s1 - xhat * s2)
        return dx.to(x.dtype), a.sum(dim=0), s.sum(dim=0), None, None


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
        y = GroupNormFunction.apply(x.contiguous(), self.gamma, self.beta,
                                    self.groups, float(self.eps))
        return y.to(self.dtype)
