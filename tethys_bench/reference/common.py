"""What both plain references share: the draws of a step, Philox dropout,
the precision of the products, the clips and Keras Adam.

Plain PyTorch, in float32 with TF32 off.  Nothing here imports the program:
whatever the program derives from the run's seed (a step's generator, the
dropout seeds it draws from it, the dropout bits, the negatives) is worked
out again here from the same seed, by the rules the program states:

- a step's CPU generator is seeded with a splitmix64 mix of (run seed,
  step), and every dropout site draws one 31-bit seed from it with
  ``torch.randint(0, 2**31 - 1, ())``, in the order the forward reaches
  the sites;
- element n of a dropped tensor (its flat index in row-major order) keeps
  its value where word n % 4 of Philox4x32-10 at counter n // 4 under key
  (seed, 0) is at least ``rate * 2**32``; survivors are scaled by
  float32(1 / (1 - rate)).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

SEED_MAX = 2 ** 31 - 1
_MASK32 = 0xFFFFFFFF
_M64 = 0xFFFFFFFFFFFFFFFF
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def f32_matmuls() -> None:
    """Products in float32 proper: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & _M64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
    return z ^ (z >> 31)


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of step ``step`` of a run seeded ``seed`` (one
    replica)."""
    z = _splitmix64((seed & _MASK32) << 32 | (step & _MASK32))
    return torch.Generator().manual_seed(z)


class SeedTape:
    """Dropout seeds in the order the forward reaches its sites.  The first
    block of rows draws them from the step's generator; every later block
    of the same step replays them (``rewind``), since the program draws a
    site's seed once for the whole batch."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.seeds: List[int] = []
        self.pos = 0

    def rewind(self) -> None:
        self.pos = 0

    def next(self) -> int:
        if self.pos == len(self.seeds):
            self.seeds.append(int(torch.randint(0, SEED_MAX, (),
                                                generator=self.generator)))
        self.pos += 1
        return self.seeds[self.pos - 1]


def _philox(c0, c1, k0: int):
    """Philox4x32-10 with counter (c0, c1, 0, 0) and key (k0, 0), on int64
    tensors holding uint32 words.  A product of two words is taken whole
    in int64, which wraps modulo 2**64: its low word and, after an
    arithmetic shift and a mask, its high word are exact."""
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k1 = 0
    for _ in range(10):
        p0 = c0 * PHILOX_M[0]
        p1 = c2 * PHILOX_M[1]
        hi0, lo0 = (p0 >> 32) & _MASK32, p0 & _MASK32
        hi1, lo1 = (p1 >> 32) & _MASK32, p1 & _MASK32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _MASK32
        k1 = (k1 + PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def keep_mask(seed: int, shape, rate: float, offset: int = 0,
              device=None) -> torch.Tensor:
    """Bool keep mask of a block of ``shape`` whose first element has the
    flat index ``offset`` in the dropped tensor."""
    n = int(np.prod(shape))
    first, last = offset // 4, (offset + n - 1) // 4
    ctr = torch.arange(first, last + 1, dtype=torch.int64, device=device)
    words = torch.stack(_philox(ctr & _MASK32, ctr >> 32,
                                int(seed) & _MASK32), dim=-1).reshape(-1)
    del ctr
    start = offset - 4 * first
    threshold = min(int(rate * 2 ** 32), 2 ** 32 - 1)
    return (words[start:start + n] >= threshold).reshape(shape)


def dropout(x: torch.Tensor, rate: float, seed: int,
            offset: int = 0) -> torch.Tensor:
    """Dropout of a block of rows whose first element sits at ``offset``."""
    if rate <= 0.0:
        return x
    keep = keep_mask(seed, x.shape, rate, offset, x.device)
    scale = float(np.float32(1.0 / (1.0 - rate)))
    return torch.where(keep, x * scale, torch.zeros((), device=x.device))


def row_offset(full_shape, row0: int) -> int:
    """Flat index of row ``row0`` (dim 0) of a tensor of ``full_shape``."""
    return row0 * int(np.prod(full_shape[1:]))


def _float8(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 type, one scale a tensor (its largest
    magnitude onto ``top``), back in x's type."""
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _GradToE5M2(torch.autograd.Function):
    """The identity, whose backward rounds the incoming gradient to float8
    e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return _float8(grad, torch.float8_e5m2, 57344.0)


class Precision:
    """The precision of every product (matmuls and convolutions): float32,
    or float8 as a training step takes it (the control, one step below the
    bfloat16 that the configurations compute in): each operand rounded to
    float8 e4m3 and, in the backward, the gradient of each product's
    output rounded to float8 e5m2 before it enters the backward's
    products, each with one scale a tensor (its largest magnitude onto 448
    and 57344).  Products are taken in float32.  An operand's rounding
    passes the gradient straight through, so the backward's products read
    the rounded operands."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "float8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product."""
        if self.name == "float32":
            return x
        q = _float8(x.detach(), torch.float8_e4m3fn, 448.0)
        return x + (q - x.detach())

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output."""
        return y if self.name == "float32" else _GradToE5M2.apply(y)


FLOAT32 = Precision("float32")


def linear(x, weight, bias, prec: Precision):
    y = prec.out(torch.matmul(prec(x), prec(weight).t()))
    return y if bias is None else y + bias


def layer_norm(x, weight, bias, eps: float):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), weight, bias, eps)


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="none")


def same_pad(length: int, kernel: int, stride: int):
    """TF SAME padding (left, right) of a 1-D convolution."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


def conv1d_same(x, weight, bias, stride: int, groups: int, prec: Precision):
    """SAME convolution of channels-first x [B, C, T]."""
    x = torch.nn.functional.pad(x, same_pad(x.shape[-1], weight.shape[-1],
                                            stride))
    return prec.out(torch.nn.functional.conv1d(prec(x), prec(weight), bias,
                                               stride, groups=groups))


def attention(q, k, v, rate: float, seed: int, offset: int,
              prec: Precision, bias: Optional[torch.Tensor] = None):
    """softmax(q k^T + bias) v, the probabilities dropped; q [b, H, Tq, D]
    already scaled; ``offset`` is the flat index of the block's first
    probability in the whole batch's [B, H, Tq, Tk]."""
    scores = prec.out(torch.matmul(prec(q), prec(k).transpose(-1, -2)))
    if bias is not None:
        scores = scores + bias
    probs = dropout(torch.softmax(scores, dim=-1), rate, seed, offset)
    return prec.out(torch.matmul(prec(probs), prec(v)))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    for g in grads:
        g.mul_(scale)


def clip_per_variable(grads: List[torch.Tensor], max_norm: float) -> None:
    for g in grads:
        g.mul_((max_norm / torch.linalg.vector_norm(g).clamp_min(1e-12)
                ).clamp_max(1.0))


class KerasAdam:
    """tf.keras Adam: the bias corrections folded into the step size, eps
    added to the uncorrected sqrt(v); ``clipnorm`` clips each gradient by
    its own norm first."""

    def __init__(self, lr: float, eps: float, b1: float = 0.9,
                 b2: float = 0.999, clipnorm: Optional[float] = None):
        self.lr, self.eps, self.b1, self.b2 = lr, eps, b1, b2
        self.clipnorm = clipnorm
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.count = 0

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor]) -> None:
        self.count += 1
        names = list(grads)
        if self.clipnorm is not None:
            clip_per_variable([grads[n] for n in names], self.clipnorm)
        one, c = np.float32(1.0), np.float32(self.count)
        alpha = float(np.float32(self.lr) * np.sqrt(one - np.float32(self.b2)
                                                     ** c)
                      / (one - np.float32(self.b1) ** c))
        for n in names:
            g = grads[n]
            m = self.m.setdefault(n, torch.zeros_like(g))
            v = self.v.setdefault(n, torch.zeros_like(g))
            m.add_((g - m) * (1.0 - self.b1))
            v.add_((g * g - v) * (1.0 - self.b2))
            params[n].sub_(alpha * m / (v.sqrt() + self.eps))
