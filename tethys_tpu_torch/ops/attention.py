"""Scaled-dot-product attention (tethys_tpu/ops/attention.py).

Queries arrive pre-scaled by head_dim^-0.5.  Scores and the softmax are
f32 whatever the compute dtype; the probabilities are cast back to it.
Long self-attention on a CUDA tensor takes the flash kernel
(ops/flash_attention.py) under the JAX package's thresholds; everything
else, and every CPU tensor, takes the plain ``_xla_attention``.  Serving is
deterministic: attention dropout (the JAX ``dropout_rate``) is not ported
yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

from tethys_tpu_torch.ops.masks import NEG_INF

# Same thresholds as tethys_tpu.ops.attention (_FLASH_MIN_SEQ and
# _FLASH_MIN_TQ): the flash path needs a query of >= 16 rows and either
# sequence >= 512.
FLASH_MIN_SEQ = 512
FLASH_MIN_TQ = 16


def flash_active(use_flash: bool, tq: int, tk: int, is_cuda: bool) -> bool:
    """Whether multi_head_attention takes the flash kernel ("on a CUDA
    tensor" where the JAX package says "on TPU")."""
    return use_flash and is_cuda and tq >= FLASH_MIN_TQ and (
        tq >= FLASH_MIN_SEQ or tk >= FLASH_MIN_SEQ)


def multi_head_attention(
    query: torch.Tensor,   # [B, H, Tq, D] (already scaled by D^-0.5)
    key: torch.Tensor,     # [B, H, Tk, D]
    value: torch.Tensor,   # [B, H, Tk, D]
    bias: Optional[torch.Tensor] = None,  # additive, broadcast to [B,H,Tq,Tk]
    use_flash: bool = False,
    kv_len: Optional[int] = None,  # true KV length when key/value are padded
) -> torch.Tensor:
    """Returns [B, H, Tq, D]."""
    if flash_active(use_flash, query.shape[2], key.shape[2], query.is_cuda):
        from tethys_tpu_torch.ops import flash_attention as fa

        if fa.supported(query, key, value, bias):
            return fa.flash_attention(query, key, value, kv_len=kv_len)
    return _xla_attention(query, key, value, bias, kv_len)


def _xla_attention(query, key, value, bias=None, kv_len=None):
    """The plain composition: f32 scores, softmax, compute-dtype probs."""
    scores = torch.matmul(query.float(), key.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    if kv_len is not None and kv_len < key.shape[2]:
        col = torch.arange(key.shape[2], device=scores.device)
        scores = torch.where(col < kv_len, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(query.dtype)
    return torch.matmul(probs, value)


def decode_attention(
    query: torch.Tensor,    # [B, H, Tq, D] (already scaled)
    key_t: torch.Tensor,    # [B, H, D, Tk] transposed cache
    value_t: torch.Tensor,  # [B, H, D, Tk] transposed cache
    bias: Optional[torch.Tensor] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Attention of the decode step against transposed K/V caches: the
    cross-attention of every step, and the plain form of the decode
    self-attention (ops/decode.py).  Same numerics as ``_xla_attention``.
    Returns [B, H, Tq, D]."""
    scores = torch.matmul(query.float(), key_t.float())
    if bias is not None:
        scores = scores + bias.float()
    if kv_len is not None and kv_len < key_t.shape[3]:
        col = torch.arange(key_t.shape[3], device=scores.device)
        scores = torch.where(col < kv_len, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(query.dtype)
    return torch.matmul(probs, value_t.transpose(-1, -2))
