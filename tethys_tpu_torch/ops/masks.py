"""Attention masks and SpecAugment-style time and feature masking
(tethys_tpu/ops/masks.py).

``apply_time_mask`` / ``apply_feature_mask`` are the reference's utilities
(speech_jobs/wav2vec2_dist.py:1073-1119), which no training path calls, in
JAX or here.  A ``torch.Generator`` takes the place of JAX's key, so the
random starts differ from JAX's; from the same starts,
``run_mask_from_starts`` gives JAX's mask exactly.

``NEG_INF`` is the flash kernel's -1e30 (tethys_tpu/ops/pallas_attention.py);
the JAX masks use -1e9.  Either is absorbed exactly by any finite score in
f32 and gives a probability of exactly 0 after the softmax.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

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


def run_mask_from_starts(starts: torch.Tensor, run_length: int
                         ) -> torch.Tensor:
    """[B, L] bool run starts -> [B, L] bool mask: position j is masked iff
    some start i has 0 <= j - i < run_length.  Runs are clipped at L and
    never wrap.  Exact: the count of starts in (j - run_length, j] is a
    difference of integer prefix sums."""
    length = starts.shape[-1]
    upto = torch.cumsum(starts.to(torch.int32), dim=-1)
    before = F.pad(upto, (run_length, 0))[..., :length]
    return upto > before


def _run_mask(generator: Optional[torch.Generator], batch: int, length: int,
              prob: float, run_length: int, device=None) -> torch.Tensor:
    """Bernoulli(prob) run starts, drawn from ``generator`` on ``device``,
    expanded to runs of ``run_length`` along ``length``."""
    probs = torch.full((batch, length), float(prob), device=device)
    starts = torch.bernoulli(probs, generator=generator).bool()
    return run_mask_from_starts(starts, run_length)


def apply_time_mask(generator: Optional[torch.Generator],
                    hidden_states: torch.Tensor, mask_prob: float = 0.05,
                    mask_length: int = 10) -> torch.Tensor:
    """Zero out runs of time steps. hidden_states: [B, T, C]."""
    b, t, _ = hidden_states.shape
    mask = _run_mask(generator, b, t, mask_prob, mask_length,
                     hidden_states.device)
    return torch.where(mask[:, :, None], 0.0, hidden_states)


def apply_feature_mask(generator: Optional[torch.Generator],
                       hidden_states: torch.Tensor, mask_prob: float = 0.0,
                       mask_length: int = 10) -> torch.Tensor:
    """Zero out runs of feature channels. hidden_states: [B, T, C]."""
    b, _, c = hidden_states.shape
    mask = _run_mask(generator, b, c, mask_prob, mask_length,
                     hidden_states.device)
    return torch.where(mask[:, None, :], 0.0, hidden_states)
