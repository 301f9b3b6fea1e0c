"""Additive attention masks (tethys_tpu/ops/masks.py): the causal mask
and the padding mask.

``NEG_INF`` is the flash kernel's -1e30 (tethys_tpu/ops/pallas_attention.py);
the JAX masks use -1e9.  Either is absorbed exactly by any finite score in
f32 and gives a probability of exactly 0 after the softmax.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def causal_additive_mask(seq_len: int, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """[1, 1, seq_len, seq_len] additive bias: 0 on/below the diagonal,
    NEG_INF above."""
    allowed = torch.ones(seq_len, seq_len, device=device).tril()
    bias = (1.0 - allowed) * NEG_INF
    return bias[None, None].to(dtype)


def padding_additive_mask(attention_mask: torch.Tensor, dtype=torch.float32,
                          scale: float = NEG_INF) -> torch.Tensor:
    """[B, T] {0, 1} mask -> [B, 1, 1, T] additive bias ``(1 - mask) *
    scale``; Wav2Vec2 passes scale=-10000 as the reference does
    (wav2vec2_dist.py:355-357)."""
    m = attention_mask.float()
    return ((1.0 - m) * scale)[:, None, None, :].to(dtype)
