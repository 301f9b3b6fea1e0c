"""Scaled-dot-product attention (tethys_tpu/ops/attention.py).

Queries arrive pre-scaled by head_dim^-0.5.  Scores and the softmax are
f32 whatever the compute dtype; the probabilities are cast back to it.
Long self- and cross-attention on a CUDA tensor takes the flash kernels
(ops/flash_attention.py) under the JAX package's thresholds; everything
else, and every CPU tensor, takes the plain ``_xla_attention``.  In
training (``training=True``) the probabilities are dropped at
``dropout_rate``: inside the flash kernels, or on the plain path through
``fused_dropout`` on the compute-dtype probabilities, as the JAX package
does on the chip (attention.py:109-121).  Seeds come from the caller's CPU
``torch.Generator``.

A shard's probabilities (tensor parallelism: H / tp of the heads; sequence
parallelism: a window of the query rows) take a ``ProbsWindow``, where
they lie in the unsharded [B, H, Tq, Tk]; the plain path's dropout then
draws their slice of the unsharded mask (ops/dropout.Window): heads
[h0, h0 + h) of H are, viewed as [B, h * Tq, Tk], rows h0 * Tq onward of
H * Tq; query rows are rows of the last two dims.  The flash kernels take
no window (their mask keeps local coordinates, as the JAX kernel's does).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tethys_tpu_torch.ops.dropout import (
    Window,
    fused_dropout,
    seed_from_generator,
)
from tethys_tpu_torch.ops.masks import NEG_INF

# Same thresholds as tethys_tpu.ops.attention (_FLASH_MIN_SEQ and
# _FLASH_MIN_TQ): the flash path needs a query of >= 16 rows and either
# sequence >= 512.
FLASH_MIN_SEQ = 512
FLASH_MIN_TQ = 16


class ProbsWindow(NamedTuple):
    """Where a shard's probabilities [B, h, tq, Tk] lie in the unsharded
    [B, H, Tq, Tk]: heads [head0, head0 + h) of ``heads`` and query rows
    [row0, row0 + tq) of ``rows``; a zero ``heads`` or ``rows`` is the
    shard's own count.  ``ProbsWindow()`` is the whole tensor."""
    head0: int = 0
    heads: int = 0
    row0: int = 0
    rows: int = 0


def probs_dropout(probs: torch.Tensor, rate: float, seed: int,
                  window: ProbsWindow = ProbsWindow()) -> torch.Tensor:
    """Dropout of [B, h, tq, Tk] probabilities at ``window``: a shard of
    heads or of query rows (not both) draws its slice of the unsharded
    mask."""
    b, h, tq, tk = probs.shape
    heads, rows = window.heads or h, window.rows or tq
    if heads == h:
        return fused_dropout(probs, rate, seed, Window() if rows == tq
                             else Window(row0=window.row0, rows=rows))
    if rows != tq:
        raise ValueError(f"attention dropout: a shard of both heads "
                         f"{tuple(window)} and rows {tuple(probs.shape)}")
    flat = fused_dropout(probs.reshape(b, h * tq, tk), rate, seed,
                         Window(row0=window.head0 * tq, rows=heads * tq))
    return flat.view(b, h, tq, tk)


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
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    training: bool = False,
    use_flash: bool = False,
    kv_len: Optional[int] = None,  # true KV length when key/value are padded
    window: ProbsWindow = ProbsWindow(),  # a shard's place (module doc)
) -> torch.Tensor:
    """Returns [B, H, Tq, D]."""
    rate = dropout_rate if training else 0.0
    if rate > 0.0 and generator is None:
        # As the JAX package: fail on every device alike.
        raise ValueError("multi_head_attention: dropout_rate > 0 in training "
                         "requires a generator")
    seed = seed_from_generator(generator) if rate > 0.0 else 0
    if flash_active(use_flash, query.shape[2], key.shape[2], query.is_cuda):
        from tethys_tpu_torch.ops import flash_attention as fa

        if fa.supported(query, key, value, bias):
            if rate > 0.0 and window != ProbsWindow():
                raise ValueError("the flash kernels take no dropout window")
            return fa.flash_attention(query, key, value, dropout_rate=rate,
                                      seed=seed, kv_len=kv_len)
    return _xla_attention(query, key, value, bias, kv_len, rate, seed,
                          window)


def _xla_attention(query, key, value, bias=None, kv_len=None,
                   dropout_rate=0.0, seed=0, window=ProbsWindow()):
    """The plain composition: f32 scores, softmax, compute-dtype probs,
    dropout on those probs."""
    scores = torch.matmul(query.float(), key.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    if kv_len is not None and kv_len < key.shape[2]:
        col = torch.arange(key.shape[2], device=scores.device)
        scores = torch.where(col < kv_len, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(query.dtype)
    if dropout_rate > 0.0:
        probs = probs_dropout(probs, dropout_rate, seed, window)
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
