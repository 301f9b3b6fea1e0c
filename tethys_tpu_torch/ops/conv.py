"""TF SAME 1-D convolution (flax ``nn.Conv(padding="SAME")``).

torch's ``Conv1d(padding="same")`` refuses a stride above 1, so the padding
is written out: the output has ceil(T / stride) frames, the total padding
is ``max((ceil(T/s) - 1) * s + k - T, 0)``, the left side gets half of it
rounded down and the right side the rest.  An even kernel at stride 1 pads
asymmetrically (Wav2Vec2's k = 128 positional conv: 63 left, 64 right).
The product itself is ``F.conv1d`` (cuDNN on the card), as the JAX package
leaves it to XLA's convolution outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def same_pad(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding (left, right) of a 1-D convolution."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def conv1d_same(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                groups: int = 1) -> torch.Tensor:
    """Channels-last SAME convolution, as flax computes it:
    x [B, T, C_in], weight [C_out, C_in / groups, k] -> [B, ceil(T/s), C_out]."""
    kernel = weight.shape[-1]
    xt = F.pad(x.transpose(1, 2), same_pad(x.shape[1], kernel, stride))
    return F.conv1d(xt, weight, bias, stride, groups=groups).transpose(1, 2)
