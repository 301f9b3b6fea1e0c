"""Sinusoidal position table (tethys_tpu/ops/posenc.py ``sinusoidal_table``).

Plain numpy, copied: the JAX module imports flax, so it cannot be shared.
"""

from __future__ import annotations

import numpy as np


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model] float32 table; even dims sin, odd dims cos."""
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    position = np.arange(0, max_len)[:, np.newaxis]
    div_term = np.exp(np.arange(0, d_model, 2) * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)
