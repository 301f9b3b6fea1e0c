"""Whisper's teacher-forcing loss (tethys_tpu/losses.py).

``seq2seq_shifted_ce`` is the CE of f32 ``logits[:, :-1]`` against
``labels[:, 1:]``: a plain mean over every position, pads included, unless
a decoder mask is given, then the mean over ``mask[:, :-1]``.  The decoder
inputs are already the labels right-shifted, so the loss shifts twice; that
is the reference's quirk, kept (reference speech_jobs/whisper_dist.py:
583-600).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def seq2seq_shifted_ce(
    logits: torch.Tensor,                  # [B, T, V]
    labels: torch.Tensor,                  # [B, T] int
    decoder_attention_mask: Optional[torch.Tensor] = None,  # [B, T] {0, 1}
) -> torch.Tensor:
    shift_logits = logits[:, :-1, :].float()
    shift_labels = labels[:, 1:].long()
    ce = F.cross_entropy(shift_logits.reshape(-1, shift_logits.shape[-1]),
                         shift_labels.reshape(-1),
                         reduction="none").view(shift_labels.shape)
    if decoder_attention_mask is not None:
        mask = decoder_attention_mask[:, :-1].to(ce.dtype)
        return (ce * mask).sum() / mask.sum()
    return ce.mean()
