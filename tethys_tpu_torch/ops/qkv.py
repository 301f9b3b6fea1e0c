"""Projections around attention (tethys_tpu/ops/pallas_qkv.py, the
default unfused path).

``project_split``: y = (x @ W^T + b) * scale, then split_heads.
``merge_project``: merge_heads, then @ W_out^T + b.  The products stay
torch matmuls, as XLA computed them outside any kernel; the head split is
the kernel.  The fused projection kernels of the JAX package are opt-in
there (TETHYS_FUSED_QKV=1) and are not ported yet (ROADMAP.md).  Weights
use torch's Linear layout [out, in].
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from tethys_tpu_torch.ops.transpose import merge_heads, split_heads


def project_split(
        x: torch.Tensor,
        projections: Sequence[Tuple[torch.Tensor, torch.Tensor, float]],
        num_heads: int) -> Tuple[torch.Tensor, ...]:
    """[(weight [E_out, E_in], bias [E_out], scale)] -> tuple of [B, H, T, d]."""
    outs = []
    for weight, bias, scale in projections:
        y = F.linear(x, weight, bias)
        if scale != 1.0:
            y = y * scale
        outs.append(split_heads(y, num_heads))
    return tuple(outs)


def merge_project(attn: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """[B, H, T, d] -> [B, T, E_out]."""
    return F.linear(merge_heads(attn), weight, bias)
