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

A shard of a tensor takes a ``Window``: where it lies in the unsharded
tensor on the last two dims (its first row and the unsharded row count,
its first column and the unsharded width).  Its elements draw their bits
at their flat index in the unsharded tensor, so a shard's mask is the
slice of the whole tensor's mask and a sharded model drops exactly what
the unsharded one drops (the JAX dropout gathers the shard and draws at
the global index, pallas_dropout.py:78-127).  The default window is the
tensor itself: every element at its own flat index, the bits drawn
before windows existed.

csrc/dropout.cu takes the launches of a ``plan``: each segment of the
window is cut into slots of 16 bytes of elements (8 bf16, 4 f32), each
slot whole Philox counters of the unsharded index.  A bf16 grid fills the
card once (the SM count and the occupancy the kernel reports) or less; an
f32 grid has a thread a slot.  A shard of more than MAX_LAUNCH elements
takes several launches, each its own run of the window.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

_DTYPES = (torch.float32, torch.bfloat16)
_MASK32 = 0xFFFFFFFF
THREADS = 256            # threads a block (csrc/dropout.cu kThreads)
VEC_BYTES = 16           # bytes a slot: one 16-byte access where aligned
MAX_LAUNCH = 2 ** 29     # elements a launch, whose slots the kernel counts
                         # in 32 bits
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


class Window(NamedTuple):
    """Where a shard lies in the unsharded tensor, on its last two dims:
    its first row ``row0`` of ``rows`` unsharded rows (dim -2) and its
    first column ``col0`` of ``cols`` unsharded columns (dim -1).  A zero
    ``rows`` or ``cols`` is the shard's own size: ``Window()`` is the whole
    tensor."""
    row0: int = 0
    rows: int = 0
    col0: int = 0
    cols: int = 0


def window_segments(shape, window: Window) -> Tuple[int, int, int, int, int]:
    """The window as csrc/dropout.cu takes it: (seg_len, seg_per_outer,
    outer_stride, row_stride, base), where segment s of ``seg_len``
    contiguous elements starts at the unsharded index (s // seg_per_outer)
    * outer_stride + (s % seg_per_outer) * row_stride + base.  Raises when
    the shard does not fit in the unsharded tensor."""
    shape = tuple(int(n) for n in shape)
    cols_l = shape[-1] if shape else 1
    rows_l = shape[-2] if len(shape) >= 2 else 1
    numel = int(np.prod(shape))
    rows = window.rows or rows_l
    cols = window.cols or cols_l
    if (window.row0 < 0 or window.col0 < 0 or window.row0 + rows_l > rows
            or window.col0 + cols_l > cols):
        raise ValueError(f"dropout: a shard {shape} does not fit the window "
                         f"{tuple(window)}")
    base = window.row0 * cols + window.col0
    if cols_l != cols:                          # a shard of columns
        return cols_l, rows_l, rows * cols, cols, base
    if rows_l != rows:                          # a shard of rows
        return rows_l * cols_l, 1, rows * cols, 0, base
    return max(numel, 1), 1, 0, 0, 0            # the whole tensor


class Launch(NamedTuple):
    """One launch of csrc/dropout.cu: ``numel`` elements of the shard from
    its element ``offset``, in segments (``window_segments``'s form, the
    bases those of this launch's first segment), ``vec`` elements a slot,
    ``slots_per_seg`` slots a segment (slot 0 its head, the last its tail,
    either possibly empty), ``slots`` in all, ``blocks`` of THREADS
    threads, and whether both pointers allow 16-byte accesses."""
    offset: int
    numel: int
    segments: Tuple[int, int, int, int, int]
    vec: int
    slots_per_seg: int
    slots: int
    blocks: int
    vectors: bool


def pieces(shape, window: Window):
    """(offset, numel, segments) of each launch of a shard: whole segments,
    at most MAX_LAUNCH elements a launch, or a segment longer than that in
    runs of MAX_LAUNCH, so the kernel counts a segment and a launch's
    slots in 32 bits."""
    seg_len, per_outer, outer_stride, row_stride, base = window_segments(
        shape, window)
    numel = max(int(np.prod(shape)), 1)
    group = seg_len * per_outer                 # elements an outer index
    out = []
    if seg_len > MAX_LAUNCH:                    # a segment in runs
        for s in range(numel // seg_len):
            u = (s // per_outer * outer_stride + s % per_outer * row_stride
                 + base)
            for o in range(0, seg_len, MAX_LAUNCH):
                n = min(MAX_LAUNCH, seg_len - o)
                out.append((s * seg_len + o, n, (n, 1, 0, 0, u + o)))
    elif group > MAX_LAUNCH:                    # an outer index's segments
        run = MAX_LAUNCH // seg_len
        for o in range(numel // group):
            for r in range(0, per_outer, run):
                k = min(run, per_outer - r)
                out.append(((o * per_outer + r) * seg_len, k * seg_len,
                            (seg_len, k, 0, row_stride,
                             base + o * outer_stride + r * row_stride)))
    else:                                       # whole outer indices
        run = MAX_LAUNCH // group
        for o in range(0, numel // group, run):
            k = min(run, numel // group - o)
            out.append((o * group, k * group, (seg_len, per_outer,
                                               outer_stride, row_stride,
                                               base + o * outer_stride)))
    return out


def plan(shape, window: Window, elem: int, vectors: bool,
         blocks_per_sm: int, sm_count: int) -> Tuple[Launch, ...]:
    """The launches for a contiguous shard of ``shape`` (elements of
    ``elem`` bytes) at ``window``, whose pointers allow 16-byte accesses
    where ``vectors`` (``pieces``; one launch below MAX_LAUNCH elements).
    A segment of L elements takes ceil(L / vec) + 1 slots (its ragged head
    and tail in partial slots).  bf16: one slot a thread until the grid
    fills the card (blocks_per_sm * sm_count blocks), then those threads
    stride over the slots; f32, whose slot takes one Philox call where
    bf16's takes two, gives every slot its own thread and leaves the
    balance to the block scheduler.  Each grid was the faster for its
    dtype on an H100 (PERF.md section 6)."""
    vec = VEC_BYTES // elem
    launches = []
    for offset, numel, segments in pieces(shape, window):
        per_seg = -(-segments[0] // vec) + 1
        slots = numel // segments[0] * per_seg
        blocks = -(-slots // THREADS)
        if elem == 2:
            blocks = max(1, min(blocks, blocks_per_sm * sm_count))
        launches.append(Launch(offset, numel, segments, vec, per_seg, slots,
                               blocks, bool(vectors)
                               and offset * elem % VEC_BYTES == 0))
    return tuple(launches)


def window_indices(shape, window: Window, device=None) -> torch.Tensor:
    """The unsharded flat index (int64) of each element of a contiguous
    shard of ``shape``."""
    seg_len, per_outer, outer_stride, row_stride, base = window_segments(
        shape, window)
    numel = int(np.prod(shape))
    seg = torch.arange(max(numel // seg_len, 1), dtype=torch.int64,
                       device=device)
    start = (seg // per_outer) * outer_stride + (seg % per_outer) * row_stride
    idx = (start[:, None] + base
           + torch.arange(seg_len, dtype=torch.int64, device=device))
    return idx.reshape(-1)[:numel]


def keep_mask(seed: int, shape, rate: float, device=None,
              window: Window = Window()) -> torch.Tensor:
    """Bool keep mask of a contiguous tensor of ``shape``, a shard at
    ``window`` of a larger one (default: the tensor itself)."""
    numel = int(np.prod(shape))
    if window == Window():
        bits = philox_bits(seed, numel, device)
    else:
        idx = window_indices(shape, window, device)
        ctr = idx >> 2
        zero = torch.zeros_like(ctr)
        words = torch.stack(philox4x32_10(
            (ctr & _MASK32, ctr >> 32, zero, zero),
            (int(seed) & _MASK32, 0)), dim=-1)
        bits = words.gather(-1, (idx & 3)[:, None])[:, 0]
    return (bits >= dropout_threshold(rate)).reshape(shape)


def plain_dropout(x: torch.Tensor, rate: float, seed: int,
                  window: Window = Window()) -> torch.Tensor:
    """What the kernel computes, in plain torch."""
    keep = keep_mask(seed, x.shape, rate, x.device, window)
    scaled = (x.float() * dropout_scale(rate)).to(x.dtype)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype,
                                                 device=x.device))


def dropout_cuda(x: torch.Tensor, rate: float, seed: int,
                 window: Window = Window()) -> torch.Tensor:
    check_kernel_inputs("dropout", x)
    if x.dtype not in _DTYPES:
        raise ValueError(f"dropout: unsupported dtype {x.dtype}")
    if not 0.0 < rate < 1.0 or not 0 <= seed < 2 ** 32:
        raise ValueError(f"dropout: rate {rate} or seed {seed} out of range")
    segments = window_segments(x.shape, window)  # raises on a misfit one
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    kernel = (kernel_lib.DROPOUT if segments == (x.numel(), 1, 0, 0, 0)
              else kernel_lib.DROPOUT_WINDOW)
    elem = x.element_size()
    with torch.cuda.device(x.device):
        for p in launch_plan(x, window, y):
            kernel(
                x.data_ptr() + p.offset * elem, y.data_ptr() + p.offset * elem,
                p.numel, *p.segments, p.blocks, int(p.vectors), int(seed),
                dropout_threshold(rate), dropout_scale(rate),
                int(x.dtype == torch.bfloat16), kernel_lib.stream_handle(x))
    return y


def launch_plan(x: torch.Tensor, window: Window = Window(),
                y: Optional[torch.Tensor] = None) -> Tuple[Launch, ...]:
    """``plan`` for x (a CUDA tensor) and its output y (x's alignment where
    not given), from the occupancy the kernel reports on x's card."""
    y = x if y is None else y
    return _launch_plan(torch.cuda.current_device(), tuple(x.shape),
                        Window(*window), x.element_size(),
                        x.data_ptr() % VEC_BYTES == 0 == y.data_ptr()
                        % VEC_BYTES)


@functools.lru_cache(maxsize=1024)
def _launch_plan(device: int, shape, window: Window, elem: int,
                 vectors: bool) -> Tuple[Launch, ...]:
    """launch_plan, once a shape: a step asks again for the same ones."""
    return plan(shape, window, elem, vectors,
                *occupancy(device, int(elem == 2)))


@functools.lru_cache(maxsize=None)
def occupancy(device: int, is_bf16: int) -> Tuple[int, int]:
    """(blocks an SM, SMs) of csrc/dropout.cu on card ``device``."""
    out = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        err = kernel_lib.library().tethys_dropout_occupancy(is_bf16, out)
    if err != 0:
        raise RuntimeError(f"tethys_dropout_occupancy: CUDA error {err}")
    return tuple(out)


def _dropout(x: torch.Tensor, rate: float, seed: int,
             window: Window) -> torch.Tensor:
    if x.is_cuda:
        return dropout_cuda(x, rate, seed, window)
    cpu_or_raise("dropout", x)
    return plain_dropout(x, rate, seed, window)


class FusedDropout(torch.autograd.Function):
    """y = dropout(x); dx = dropout(dy) with the same seed and window (the
    same mask)."""

    @staticmethod
    def forward(ctx, x, rate: float, seed: int, window: Window):
        ctx.rate, ctx.seed, ctx.window = rate, seed, window
        return _dropout(x.contiguous(), rate, seed, window)

    @staticmethod
    def backward(ctx, dy):
        return (_dropout(dy.contiguous(), ctx.rate, ctx.seed, ctx.window),
                None, None, None)


def fused_dropout(x: torch.Tensor, rate: float, seed: int,
                  window: Window = Window()) -> torch.Tensor:
    """Dropout of any tensor, a shard at ``window`` of a larger one
    (default: the tensor itself); the identity at rate 0."""
    if rate <= 0.0:
        return x
    return FusedDropout.apply(x, float(rate), int(seed), Window(*window))


def seed_from_generator(generator: torch.Generator) -> int:
    """A 31-bit seed drawn on the host (pallas_dropout.seed_from_rng)."""
    if generator.device.type != "cpu":
        raise ValueError("dropout seeds come from a CPU torch.Generator, so "
                         "drawing one never waits on the device")
    return int(torch.randint(0, SEED_MAX, (), generator=generator))


def module_dropout(x: torch.Tensor, rate: float, training: bool,
                   generator: Optional[torch.Generator],
                   window: Window = Window()) -> torch.Tensor:
    """Dropout at a module site: the identity unless training with a
    nonzero rate, then ``fused_dropout`` with a seed from ``generator``
    (and ``window`` when ``x`` is a shard)."""
    if not training or rate <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    return fused_dropout(x, rate, seed_from_generator(generator), window)
