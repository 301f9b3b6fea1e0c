"""Streaming training metrics (tethys_tpu/metrics.py).

The reference compiles Keras ``Mean`` / ``SparseCategoricalAccuracy``
metrics on its models (reference speech_jobs/whisper_dist.py:904-910,
wav2vec2_dist.py:1280-1296) although its custom loops never update them;
these are the small accumulators a loop *can* use, on tensors.  As in the
JAX package, the jobs keep the reference's behaviour and do not wire them
into the hot path: ``SparseCategoricalAccuracy.update_state`` reads its
counts back to the host.
"""

from __future__ import annotations

from typing import Tuple

import torch


class Mean:
    """Streaming mean of scalar values."""

    def __init__(self, name: str = "mean"):
        self.name = name
        self.total = 0.0
        self.count = 0

    def update_state(self, value: float, weight: float = 1.0) -> None:
        self.total += float(value) * weight
        self.count += weight

    def result(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset_state(self) -> None:
        self.total, self.count = 0.0, 0


class SparseCategoricalAccuracy:
    """Streaming top-1 accuracy for integer labels."""

    def __init__(self, name: str = "accuracy"):
        self.name = name
        self.correct = 0
        self.count = 0

    def update_state(self, labels: torch.Tensor, logits: torch.Tensor) -> None:
        match = logits.argmax(dim=-1) == labels
        self.correct += int(match.sum())
        self.count += match.numel()

    def result(self) -> float:
        return self.correct / self.count if self.count else 0.0

    def reset_state(self) -> None:
        self.correct, self.count = 0, 0


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor,
                   shift: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(correct, total) as int32 tensors on the logits' device, for seq2seq
    token prediction; ``shift`` mirrors the teacher-forcing loss's
    alignment.  Nothing waits on the device."""
    if shift:
        logits = logits[:, :-1]
        labels = labels[:, 1:]
    correct = (logits.argmax(dim=-1) == labels).sum().to(torch.int32)
    return correct, torch.tensor(labels.numel(), dtype=torch.int32,
                                 device=logits.device)
