"""Fused log-mel (tethys_tpu/audio/pallas_logmel.py ``fused_log_mel``).

For a CUDA waveform the wrapper launches csrc/logmel.cu, which frames the
audio itself: it takes the waveform's storage with (base offset, row
stride, rows, frames per row, n_fft, hop) (``kernel_framing``), so neither
a ``[B, T]`` batch nor ``stream_log_mel``'s overlapping windows are copied
into frames first.  In the kernel the window-folded real DFT, the power and
the mel product run on the tensor cores in 3xTF32 (each f32 operand split
into a TF32 high and low part, three products summed in f32), and the log
comes last.  For a CPU waveform it takes ``plain_log_mel`` on
``frame_signal``'s frames: the same products as exact f32 torch matmuls.
The DFT and mel matrices are built in numpy once and uploaded once per
device; the kernel's copies are split into high and low parts on the host,
in the order its fragments load them (``_kernel_operands``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tethys_tpu_torch.audio.frontend import (
    frame_signal,
    hann_window,
    linear_to_mel_weight_matrix,
)
from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import cpu_or_raise

MAX_BINS = 256  # the kernel's limit on n_fft // 2 + 1
BIN_SLICE = 16  # bins per warp of the kernel (one m16n8k8 row tile)


@functools.lru_cache(maxsize=4)
def dft_matrices(n_fft: int = 400) -> Tuple[np.ndarray, np.ndarray]:
    """Window-folded real-DFT matrices [n_fft, n_fft // 2 + 1]:
    C[n, k] = w[n] cos(-2 pi n k / N), S[n, k] = w[n] sin(-2 pi n k / N).
    (The TPU kernel pads the rows to 512; a CUDA block needs no padding.)"""
    n = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_fft // 2 + 1)[None, :].astype(np.float64)
    ang = -2.0 * np.pi * n * k / n_fft
    w = hann_window(n_fft).astype(np.float64)[:, None]
    return ((w * np.cos(ang)).astype(np.float32),
            (w * np.sin(ang)).astype(np.float32))


def folded_dft_matrices(n_fft: int = 400) -> Tuple[np.ndarray, np.ndarray]:
    """The DFT matrices over folded taps n = 0 .. n_fft / 2, [n_fft / 2 + 1,
    n_bins]: the periodic Hann window is symmetric (w[N - n] = w[n]), so
    re = sum_n (x[n] + x[N - n]) Cf[n] and im = sum_n (x[n] - x[N - n]) Sf[n]
    with Cf[n] = C[n] and Sf[n] = S[n], but Cf halved at n = 0 and n_fft / 2,
    where the mirror N - n (mod N) is n itself, and Sf 0 there."""
    cos_m, sin_m = dft_matrices(n_fft)
    half = n_fft // 2
    cos_f, sin_f = cos_m[:half + 1].copy(), sin_m[:half + 1].copy()
    cos_f[[0, half]] *= 0.5
    sin_f[[0, half]] = 0.0
    return cos_f, sin_f


def _mel_matrix(n_fft: int, n_mels: int, sample_rate: int) -> np.ndarray:
    return linear_to_mel_weight_matrix(
        n_mels, n_fft // 2 + 1, sample_rate, 0.0, float(sample_rate // 2))


@functools.lru_cache(maxsize=8)
def _device_matrices(n_fft: int, n_mels: int, sample_rate: int,
                     device: torch.device):
    cos_m, sin_m = dft_matrices(n_fft)
    mel_m = _mel_matrix(n_fft, n_mels, sample_rate)
    return tuple(torch.from_numpy(m).to(device) for m in (cos_m, sin_m, mel_m))


def plain_log_mel(frames: torch.Tensor, cos_m: torch.Tensor,
                  sin_m: torch.Tensor, mel_m: torch.Tensor) -> torch.Tensor:
    """[..., n_fft] f32 frames -> [..., n_mels] log-mel."""
    re = frames @ cos_m
    im = frames @ sin_m
    return torch.log((re * re + im * im) @ mel_m + 1e-6)


class Framing(NamedTuple):
    """Where the kernel finds frame f of row r: tap k is element
    ``offset + r * row_stride + f * hop + k`` of the waveform's storage."""
    offset: int
    row_stride: int
    rows: int
    frames_per_row: int
    n_fft: int
    hop: int


def kernel_framing(waveform: torch.Tensor, n_fft: int,
                   hop: int) -> Optional[Framing]:
    """The kernel's framing arguments for ``frame_signal(waveform, n_fft,
    hop)`` read straight from the waveform's storage, or None where its
    leading dimensions are not rows of one stride (the caller then copies
    it).  Samples must be adjacent (last stride 1)."""
    *lead, t = waveform.shape
    rows = int(np.prod(lead, dtype=np.int64))
    frames = (t - n_fft) // hop + 1 if t >= n_fft else 0
    if t > 1 and waveform.stride(-1) != 1:
        return None
    row_stride, expect = t, None
    for size, stride in reversed(list(zip(lead, waveform.stride()[:-1]))):
        if size == 1:
            continue
        if expect is None:
            row_stride, expect = stride, stride * size
        elif stride != expect:
            return None
        else:
            expect = stride * size
    return Framing(waveform.storage_offset(), row_stride, rows, frames,
                   n_fft, hop)


def split_tf32(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """x -> (hi, lo), both TF32 values (10 mantissa bits) with hi + lo ~= x
    to about 21 bits: hi = rna(x), lo = rna(x - hi), rounding to nearest
    with ties away from zero as ``cvt.rna.tf32.f32`` does."""
    def rna(v):
        bits = np.ascontiguousarray(v, np.float32).view(np.uint32)
        return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
            np.float32)

    hi = rna(x)
    return hi, rna(x.astype(np.float32) - hi)


def _a_fragments(a: np.ndarray) -> np.ndarray:
    """A [M, K] (M a multiple of 16, K of 8) in mma.m16n8k8's A-fragment
    order: [M / 16, K / 8, 32 lanes, 4], lane l = 4 g + t holding (g, t),
    (g + 8, t), (g, t + 4), (g + 8, t + 4) of each 16 x 8 tile."""
    m, k = a.shape
    tiles = a.reshape(m // 16, 2, 8, k // 8, 2, 4)   # [mt, hi8, g, ks, hi4, t]
    # -> [mt, ks, g, t, hi4, hi8]: element (hi4, hi8) is register
    # 2 * hi4 + hi8 of the fragment.
    return tiles.transpose(0, 3, 2, 5, 4, 1).reshape(m // 16, k // 8, 32, 4)


@functools.lru_cache(maxsize=8)
def _kernel_operands(n_fft: int, n_mels: int, sample_rate: int,
                     device: torch.device):
    """The kernel's constant operands, split into TF32 high and low parts
    in fragment order:

    dft [W, ceil((n_fft / 2 + 1) / 8), 4, 32, 4]: warp w's bins [16 w, 16 w
      + 16) of Cf^T and Sf^T over the folded taps n = 0 .. n_fft / 2 (A of
      re^T = Cf^T (x[n] + x[N - n])^T, im^T = Sf^T (x[n] - x[N - n])^T),
      chunks Cf hi, Cf lo, Sf hi, Sf lo (``folded_dft_matrices``);
    mel [M / 16, 2 W, 2, 32, 4]: mel^T (A of out^T = mel^T power^T), chunks
      hi, lo, over bins padded to 16 W;
    mel_steps [M / 16, 2] int32: each mel row tile's first and last + 1
      step of 8 bins that holds a nonzero weight (the filters are bands)."""
    cos_f, sin_f = folded_dft_matrices(n_fft)
    taps, n_bins = cos_f.shape
    warps = -(-n_bins // BIN_SLICE)
    bins = warps * BIN_SLICE
    chunks = []
    for m in (cos_f, sin_f):
        at = np.zeros((bins, -(-taps // 8) * 8), np.float32)
        at[:n_bins, :taps] = m.T
        chunks += [_a_fragments(part) for part in split_tf32(at)]
    dft = np.stack(chunks, axis=2)                    # [W, ks, 4, 32, 4]

    mel = _mel_matrix(n_fft, n_mels, sample_rate)
    mels = -(-n_mels // 16) * 16
    mel_t = np.zeros((mels, bins), np.float32)
    mel_t[:n_mels, :n_bins] = mel.T
    mel_frag = np.stack([_a_fragments(p) for p in split_tf32(mel_t)], axis=2)
    steps = []
    for tile in mel_t.reshape(mels // 16, 16, bins // 8, 8):
        nz = np.flatnonzero(tile.any(axis=(0, 2)))
        steps.append((nz[0], nz[-1] + 1) if nz.size else (0, 0))
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                 for x in (dft, mel_frag, np.asarray(steps, np.int32)))


def log_mel_cuda(waveform: torch.Tensor, n_mels: int = 80, n_fft: int = 400,
                 hop_length: int = 160, sample_rate: int = 16000
                 ) -> torch.Tensor:
    """[..., T] f32 CUDA waveform -> [..., F, n_mels] log-mel, framed in
    the kernel (a view whose rows are not of one stride is copied first)."""
    if not waveform.is_cuda:
        raise ValueError(f"log_mel: expected a CUDA tensor, got "
                         f"{waveform.device}")
    if waveform.dtype != torch.float32:
        raise ValueError("log_mel: the kernel takes float32 only")
    n_bins = n_fft // 2 + 1
    if n_bins > MAX_BINS:
        raise ValueError(f"log_mel: {n_bins} bins > {MAX_BINS}")
    if n_fft % 8 or hop_length % 8:
        raise ValueError(f"log_mel: n_fft {n_fft} and hop {hop_length} must "
                         "be multiples of 8")
    framing = kernel_framing(waveform, n_fft, hop_length)
    if framing is None:
        waveform = waveform.contiguous()
        framing = kernel_framing(waveform, n_fft, hop_length)
    out = torch.empty(waveform.shape[:-1] + (framing.frames_per_row, n_mels),
                      dtype=torch.float32, device=waveform.device)
    if out.numel() == 0:
        return out
    dft, mel, mel_steps = _kernel_operands(n_fft, n_mels, sample_rate,
                                           waveform.device)
    base = waveform.untyped_storage().data_ptr() + 4 * framing.offset
    with torch.cuda.device(waveform.device):
        kernel_lib.LOG_MEL(
            base, dft.data_ptr(), mel.data_ptr(), mel_steps.data_ptr(),
            out.data_ptr(), framing.rows, framing.row_stride,
            framing.frames_per_row, n_fft, hop_length, n_bins, n_mels,
            kernel_lib.stream_handle(waveform))
    return out


def fused_log_mel(
    waveform: torch.Tensor,   # [..., T]
    sample_rate: int = 16000,
    n_mels: int = 80,
    n_fft: int = 400,
    hop_length: int = 160,
) -> torch.Tensor:
    """[..., T] -> [..., num_frames, n_mels] log-mel."""
    waveform = waveform.float()
    if waveform.is_cuda:
        return log_mel_cuda(waveform, n_mels, n_fft, hop_length, sample_rate)
    cpu_or_raise("log_mel", waveform)
    frames = frame_signal(waveform, n_fft, hop_length)
    return plain_log_mel(frames, *_device_matrices(n_fft, n_mels, sample_rate,
                                                   frames.device))
