"""Exact-erf GELU and tanh (tethys_tpu/ops/activations.py ``gelu``,
``tanh``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """0.5 * x * (1 + erf(x / sqrt(2))), computed in f32, returned in the
    input dtype (the reference's exact GELU; bf16 stays bf16 in memory)."""
    return F.gelu(x.float(), approximate="none").to(x.dtype)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh in the input dtype, as ``jnp.tanh``."""
    return torch.tanh(x)
