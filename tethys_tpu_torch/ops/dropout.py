"""Dropout (tethys_tpu/ops/pallas_dropout.py).

``fused_dropout(x, rate, seed)`` is an autograd Function: a CUDA tensor
launches csrc/dropout.cu, a CPU tensor takes ``plain_dropout``; the
backward is the same call on the gradient with the same seed, as the JAX
``_bwd`` reruns its kernel.

The mask is a pure function of (seed, flat element index): element n keeps
its value when ``philox_bits(seed, n) >= dropout_threshold(rate)``, with
Philox4x32-10 at counter n // 4 and key (seed, 0), output n % 4
(csrc/philox.cuh).  So the mask does not depend on how a kernel tiles the
tensor, the flash kernels draw the same bits for the [B*H, Tq, Tk]
probability matrix, and the plain version below computes exactly the
kernels' bits in int64 torch arithmetic.  The JAX package's bits come from
the TPU's PRNG and cannot be matched; its semantics are: P(drop) = rate,
survivors scaled by 1 / (1 - rate), here in f32 and rounded once to the
tensor's dtype.

Seeds are 31-bit ints drawn on the host from an explicit CPU
``torch.Generator`` (``seed_from_generator``, the JAX ``seed_from_rng``),
so no dropout site waits on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

_DTYPES = (torch.float32, torch.bfloat16)
_MASK32 = 0xFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
SEED_MAX = 2 ** 31 - 1   # seeds lie in [0, SEED_MAX), as seed_from_rng's


def dropout_threshold(rate: float) -> int:
    """uint32 threshold of the keep test (pallas_dropout.py:33)."""
    return min(int(rate * (2 ** 32)), 2 ** 32 - 1)


def dropout_scale(rate: float) -> float:
    """1 / (1 - rate) rounded to f32, the factor both versions multiply."""
    return float(np.float32(1.0 / (1.0 - rate)))


def _mul_hi_lo(a: int, b: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product a * b, a and b < 2^32:
    b is split into 16-bit halves so no int64 product overflows."""
    p_lo = a * (b & 0xFFFF)
    p_hi = a * (b >> 16)
    t = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (t >> 32), t & _MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 on int64 tensors holding uint32 words: counter is four
    tensors (c0, c1, c2, c3), key two ints or tensors; returns four tensors."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mul_hi_lo(PHILOX_M[0], c0)
        hi1, lo1 = _mul_hi_lo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _MASK32
        k1 = (k1 + PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_bits(seed: int, numel: int, device=None) -> torch.Tensor:
    """uint32 dropout bits (in int64) of flat elements 0 .. numel-1."""
    groups = -(-numel // 4)
    ctr = torch.arange(groups, dtype=torch.int64, device=device)
    zero = torch.zeros_like(ctr)
    words = philox4x32_10((ctr & _MASK32, ctr >> 32, zero, zero),
                          (int(seed) & _MASK32, 0))
    return torch.stack(words, dim=-1).reshape(-1)[:numel]


def keep_mask(seed: int, shape, rate: float, device=None) -> torch.Tensor:
    """Bool keep mask of a contiguous tensor of ``shape``."""
    numel = int(np.prod(shape))
    bits = philox_bits(seed, numel, device)
    return (bits >= dropout_threshold(rate)).reshape(shape)


def plain_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """What the kernel computes, in plain torch."""
    keep = keep_mask(seed, x.shape, rate, x.device)
    scaled = (x.float() * dropout_scale(rate)).to(x.dtype)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def dropout_cuda(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    check_kernel_inputs("dropout", x)
    if x.dtype not in _DTYPES:
        raise ValueError(f"dropout: unsupported dtype {x.dtype}")
    if not 0.0 < rate < 1.0 or not 0 <= seed < 2 ** 32:
        raise ValueError(f"dropout: rate {rate} or seed {seed} out of range")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        kernel_lib.DROPOUT(
            x.data_ptr(), y.data_ptr(), x.numel(), int(seed),
            dropout_threshold(rate), dropout_scale(rate),
            int(x.dtype == torch.bfloat16), kernel_lib.stream_handle(x))
    return y


def _dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    if x.is_cuda:
        return dropout_cuda(x, rate, seed)
    cpu_or_raise("dropout", x)
    return plain_dropout(x, rate, seed)


class FusedDropout(torch.autograd.Function):
    """y = dropout(x); dx = dropout(dy) with the same seed (same mask)."""

    @staticmethod
    def forward(ctx, x, rate: float, seed: int):
        ctx.rate, ctx.seed = rate, seed
        return _dropout(x.contiguous(), rate, seed)

    @staticmethod
    def backward(ctx, dy):
        return _dropout(dy.contiguous(), ctx.rate, ctx.seed), None, None


def fused_dropout(x: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """Dropout of any tensor; the identity at rate 0."""
    if rate <= 0.0:
        return x
    return FusedDropout.apply(x, float(rate), int(seed))


def seed_from_generator(generator: torch.Generator) -> int:
    """A 31-bit seed drawn on the host (pallas_dropout.seed_from_rng)."""
    if generator.device.type != "cpu":
        raise ValueError("dropout seeds come from a CPU torch.Generator, so "
                         "drawing one never waits on the device")
    return int(torch.randint(0, SEED_MAX, (), generator=generator))


def module_dropout(x: torch.Tensor, rate: float, training: bool,
                   generator: Optional[torch.Generator]) -> torch.Tensor:
    """Dropout at a module site: the identity unless training with a
    nonzero rate, then ``fused_dropout`` with a seed from ``generator``."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    return fused_dropout(x, rate, seed_from_generator(generator))
