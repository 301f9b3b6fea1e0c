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

Under tensor parallelism (a ``tp`` ``Shard``, set by parallel/tp.
shard_model; Wav2Vec2's conv outputs are sharded over their channels) the
module takes and returns this rank's channels [B, T, C / tp]; gamma and
beta stay replicated, as the JAX rule table leaves them.  When tp divides
both C and the groups, the rank's channels hold groups / tp whole groups,
whose moments never cross ranks: the kernels run on the shard, forward and
backward, with gamma's and beta's slices (``sharding.replicated_slice``,
whose backward sums the slices' gradients over the group).  Otherwise the
channels are gathered, the kernels run on the whole tensor (gamma and beta
through ``copy_to_group``: each rank's gradient is its slice's share) and
the rank's slice is returned.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from tethys_tpu_torch.ops import group_norm, sharding


class LayerNorm(nn.LayerNorm):
    """LayerNorm whose parameters are cast to the input's dtype; the
    statistics are f32 inside torch's kernel, as in flax's dtype=bf16."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape,
                            self.weight.to(x.dtype), self.bias.to(x.dtype),
                            self.eps)


class GroupNormFunction(torch.autograd.Function):
    """y = gamma * (x - mu_g) * rsqrt(var_g + eps) + beta, in ``dtype``.
    gamma and beta enter the kernels in f32 whatever their own dtype (bf16
    under bf16 master weights), as the JAX ``_gn_core`` computes in f32;
    their gradients leave in that dtype."""

    @staticmethod
    def forward(ctx, x, gamma, beta, groups: int, eps: float,
                dtype: torch.dtype):
        ctx.param_dtype = gamma.dtype
        gamma, beta = gamma.float(), beta.float()
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
        dgamma, dbeta = sums.sum(dim=1).to(ctx.param_dtype)
        return dx, dgamma, dbeta, None, None, None


class ReferenceGroupNorm(nn.Module):
    """GroupNorm over [B, T, C] with reference semantics; ``gamma`` and
    ``beta`` (the flax names, f32 but under bf16 master weights), output in
    ``dtype``; under ``tp`` on a channel shard (module doc)."""

    tp: Optional[sharding.Shard] = None

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

    def shards_whole_groups(self) -> bool:
        """Whether each rank's channels are whole groups (tp divides the
        channels and the groups)."""
        size = 1 if self.tp is None else self.tp.size
        return self.gamma.shape[0] % size == 0 and self.groups % size == 0

    def _norm(self, x, gamma, beta, groups):
        return GroupNormFunction.apply(x.contiguous(), gamma, beta, groups,
                                       float(self.eps), self.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None or tp.size == 1:
            return self._norm(x, self.gamma, self.beta, self.groups)
        if self.shards_whole_groups():
            return self._norm(x, sharding.replicated_slice(self.gamma, 0, tp),
                              sharding.replicated_slice(self.beta, 0, tp),
                              self.groups // tp.size)
        channels = self.gamma.shape[0]
        whole = sharding.gather_from_group(x, -1, tp, channels,
                                           reduce_grad=True)
        y = self._norm(whole, sharding.copy_to_group(self.gamma, tp),
                       sharding.copy_to_group(self.beta, tp), self.groups)
        start, stop = sharding.shard_range(channels, tp.size, tp.rank)
        return y.narrow(-1, start, stop - start)
