"""Fused log-mel (tethys_tpu/audio/pallas_logmel.py ``fused_log_mel``).

The framing stays outside the kernel.  For CUDA frames the wrapper
launches csrc/logmel.cu (window-folded real DFT as two products, power,
mel product, log in one pass, f32 FFMA); for CPU frames it takes
``plain_log_mel``, the same products as torch matmuls.  The DFT and mel
matrices are built in numpy once and uploaded once per device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from tethys_tpu_torch.audio.frontend import (
    frame_signal,
    hann_window,
    linear_to_mel_weight_matrix,
)
from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

MAX_BINS = 256  # the kernel's limit on n_fft // 2 + 1


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


@functools.lru_cache(maxsize=8)
def _device_matrices(n_fft: int, n_mels: int, sample_rate: int,
                     device: torch.device):
    cos_m, sin_m = dft_matrices(n_fft)
    mel_m = linear_to_mel_weight_matrix(
        n_mels, n_fft // 2 + 1, sample_rate, 0.0, float(sample_rate // 2))
    return tuple(torch.from_numpy(m).to(device) for m in (cos_m, sin_m, mel_m))


def plain_log_mel(frames: torch.Tensor, cos_m: torch.Tensor,
                  sin_m: torch.Tensor, mel_m: torch.Tensor) -> torch.Tensor:
    """[..., n_fft] f32 frames -> [..., n_mels] log-mel."""
    re = frames @ cos_m
    im = frames @ sin_m
    return torch.log((re * re + im * im) @ mel_m + 1e-6)


def log_mel_cuda(frames: torch.Tensor, cos_m: torch.Tensor,
                 sin_m: torch.Tensor, mel_m: torch.Tensor) -> torch.Tensor:
    check_kernel_inputs("log_mel", frames, cos_m, sin_m, mel_m)
    if any(t.dtype != torch.float32 for t in (frames, cos_m, sin_m, mel_m)):
        raise ValueError("log_mel: the kernel takes float32 only")
    n_fft = frames.shape[-1]
    n_bins, n_mels = mel_m.shape
    if cos_m.shape != (n_fft, n_bins) or sin_m.shape != cos_m.shape:
        raise ValueError(f"log_mel: DFT matrices {tuple(cos_m.shape)} do not "
                         f"fit frames of {n_fft} taps and {n_bins} bins")
    if n_bins > MAX_BINS:
        raise ValueError(f"log_mel: {n_bins} bins > {MAX_BINS}")
    n_rows = frames.numel() // n_fft
    out = torch.empty(frames.shape[:-1] + (n_mels,), dtype=torch.float32,
                      device=frames.device)
    if n_rows == 0:
        return out
    with torch.cuda.device(frames.device):
        kernel_lib.LOG_MEL(
            frames.data_ptr(), cos_m.data_ptr(), sin_m.data_ptr(),
            mel_m.data_ptr(), out.data_ptr(), n_rows, n_fft, n_bins, n_mels,
            kernel_lib.stream_handle(frames))
    return out


def fused_log_mel(
    waveform: torch.Tensor,   # [..., T]
    sample_rate: int = 16000,
    n_mels: int = 80,
    n_fft: int = 400,
    hop_length: int = 160,
) -> torch.Tensor:
    """[..., T] -> [..., num_frames, n_mels] log-mel."""
    frames = frame_signal(waveform.float(), n_fft, hop_length).contiguous()
    mats = _device_matrices(n_fft, n_mels, sample_rate, frames.device)
    if frames.is_cuda:
        return log_mel_cuda(frames, *mats)
    cpu_or_raise("log_mel", frames)
    return plain_log_mel(frames, *mats)
