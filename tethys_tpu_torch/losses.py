"""Loss functions of both model families (tethys_tpu/losses.py).

* ``seq2seq_shifted_ce``: Whisper's teacher-forcing loss, the CE of f32
  ``logits[:, :-1]`` against ``labels[:, 1:]``: a plain mean over every
  position, pads included, unless a decoder mask is given, then the mean
  over ``mask[:, :-1]``.  The decoder inputs are already the labels
  right-shifted, so the loss shifts twice; that is the reference's quirk,
  kept (reference speech_jobs/whisper_dist.py:583-600).
* ``sample_negative_indices`` / ``contrastive_loss``: Wav2Vec2's InfoNCE
  with the reference's sampler, one set of k positions per batch row tiled
  across time (repeat-tiled when T - 1 < k).  Negatives are drawn on the
  host from a CPU ``torch.Generator``, so the card and the CPU draw the
  same ones and the draw never waits on the device; JAX's PRNG stream
  cannot be reproduced, so parity is held on injected ``negative_indices``.
* ``diversity_loss`` = -perplexity, the reference's quirk #7
  (wav2vec2_dist.py:901-905).
* ``ctc_loss``: real CTC through ``F.ctc_loss`` with blank 0, label lengths
  counted as labels > 0, frame lengths from the mask, and the
  ``zero_infinity`` / ``reduction`` switches; "mean" is the plain mean of
  the per-sequence losses, as the JAX function's.  An impossible alignment
  is +inf here (optax returns a large finite value instead).
* ``dummy_ctc_loss``: CE against all-zero labels, the size-parameterised
  jobs' stand-in (wav2vec2_dist.py:994-1001); ``classification_loss``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from tethys_tpu_torch.utils.device import host_to_device


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


def sample_negative_indices(generator: torch.Generator, batch_size: int,
                            sequence_length: int, num_negatives: int
                            ) -> torch.Tensor:
    """[B, num_negatives] int64 time indices on the CPU: the top-k
    positions of -draws for [B, T] uniform draws in [0, T), k = max(min(K,
    T - 1), 1), repeat-tiled up to K.  (The reference tiles this one set
    across every timestep.)"""
    actual = max(min(num_negatives, sequence_length - 1), 1)
    draws = torch.randint(0, sequence_length, (batch_size, sequence_length),
                          generator=generator)
    top = torch.topk(-draws.float(), actual, dim=1).indices
    if actual < num_negatives:
        top = top.repeat(1, -(-num_negatives // actual))
    return top[:, :num_negatives]


def contrastive_loss(
    hidden_states: torch.Tensor,      # [B, T, D] projected transformer states
    quantized_states: torch.Tensor,   # [B, T, D] projected quantized targets
    generator: Optional[torch.Generator] = None,
    num_negatives: int = 100,
    temperature: float = 0.1,
    negative_indices: Optional[torch.Tensor] = None,  # [B, K] override
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(logits [B, T, 1 + K], mean CE against label 0), in f32."""
    h = hidden_states.float()
    q = quantized_states.float()
    b, t, d = h.shape
    pos_logits = (h * q).sum(dim=-1) / temperature           # [B, T]
    if num_negatives > 0:
        if negative_indices is None:
            negative_indices = sample_negative_indices(
                generator, b, t, num_negatives)
        neg_idx = host_to_device(negative_indices, h.device).long()
        neg_q = torch.gather(q, 1, neg_idx[:, :, None].expand(-1, -1, d))
        neg_logits = torch.bmm(h, neg_q.transpose(1, 2)) / temperature
        logits = torch.cat([pos_logits[:, :, None], neg_logits], dim=2)
    else:
        logits = pos_logits[:, :, None]
    labels = torch.zeros(b * t, dtype=torch.long, device=h.device)
    loss = F.cross_entropy(logits.reshape(b * t, -1), labels)
    return logits, loss


def diversity_loss(perplexity: torch.Tensor) -> torch.Tensor:
    """The reference's quirk: plain negative perplexity."""
    return -perplexity


def ctc_loss(
    logits: torch.Tensor,             # [B, T, V]
    labels: torch.Tensor,             # [B, L] int; 0 is both padding and blank
    attention_mask: Optional[torch.Tensor] = None,  # [B, T] frame validity
    blank_id: int = 0,
    zero_infinity: bool = False,
    reduction: str = "sum",
) -> torch.Tensor:
    b, t, _ = logits.shape
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    if attention_mask is not None:
        input_lengths = attention_mask.long().sum(dim=1)
    else:
        input_lengths = torch.full((b,), t, dtype=torch.long,
                                   device=logits.device)
    target_lengths = (labels > 0).long().sum(dim=1)
    per_seq = F.ctc_loss(log_probs, labels.long(), input_lengths,
                         target_lengths, blank=blank_id, reduction="none",
                         zero_infinity=zero_infinity)
    if reduction == "mean":
        return per_seq.mean()
    if reduction == "sum":
        return per_seq.sum()
    return per_seq


def dummy_ctc_loss(logits: torch.Tensor) -> torch.Tensor:
    """CE of f32 logits against all-zero labels, the mean."""
    flat = logits.float().reshape(-1, logits.shape[-1])
    return F.cross_entropy(flat, torch.zeros(flat.shape[0], dtype=torch.long,
                                             device=logits.device))


def classification_loss(logits: torch.Tensor,
                        labels: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.float(), labels.long())
