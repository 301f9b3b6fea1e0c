"""Positional encodings (tethys_tpu/ops/posenc.py).

``sinusoidal_table`` is the table the models use.  The two modules and
``relative_position_table`` are the reference's utilities
(speech_jobs/whisper_dist.py:49-69, speech_jobs/wav2vec2_dist.py:200-223),
which no model calls, in JAX or here.  Plain numpy and torch, copied: the
JAX module imports flax, so it cannot be shared.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] float32 table; even dims sin, odd dims cos."""
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    position = np.arange(0, max_len)[:, np.newaxis]
    div_term = np.exp(np.arange(0, d_model, 2) * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


class SinusoidalPositionalEncoding(nn.Module):
    """Adds the fixed sinusoidal table, cast to ``dtype``, to [B, T, d].
    The table is a buffer kept out of the state dict, as JAX's constant
    stays out of its params."""

    def __init__(self, d_model: int, max_len: int = 5000,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.max_len, self.dtype = d_model, max_len, dtype
        self.register_buffer(
            "pe", torch.from_numpy(sinusoidal_table(max_len, d_model)),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.pe[None, :x.shape[1]].to(self.dtype)


def relative_position_table(max_length: int, d_model: int) -> np.ndarray:
    """[max_length, d_model] float32 sin/cos table ``pos / 10000^(i/d)``
    (even dims sin, odd dims cos, odd d_model included) that
    RelativePositionalEncoding starts from."""
    pos = np.arange(max_length)[:, None].astype(np.float64)
    i = np.arange(0, d_model, 2).astype(np.float64)
    angles = pos / (10000.0 ** (i / d_model))
    table = np.zeros((max_length, d_model), dtype=np.float64)
    table[:, 0::2] = np.sin(angles)
    table[:, 1::2] = np.cos(angles[:, : table[:, 1::2].shape[1]])
    return table.astype(np.float32)


class RelativePositionalEncoding(nn.Module):
    """Trainable position table ``pos_embedding`` [max_length, dim],
    initialised with relative_position_table; a call returns its first
    ``length`` rows."""

    def __init__(self, dim: int, max_length: int = 5000):
        super().__init__()
        self.dim, self.max_length = dim, max_length
        self.pos_embedding = nn.Parameter(
            torch.from_numpy(relative_position_table(max_length, dim)))

    def forward(self, length: int) -> torch.Tensor:
        return self.pos_embedding[:length]
