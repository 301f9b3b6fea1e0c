"""STFT -> log-mel audio frontend (tethys_tpu/audio/frontend.py).

Same TF reference math: frame length 400, step 160, periodic Hann window,
pad_end=False, power spectrum, HTK mel matrix with the DC bin zeroed,
log(mel + 1e-6).  The window and mel matrix are numpy, computed once.
``extract_fbank_features`` is the plain rfft frontend;
``log_mel_features`` takes the fused log-mel kernel (audio/logmel.py),
which on a CPU tensor runs its plain version.  ``stream_log_mel`` is not
ported yet (ROADMAP.md).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hertz_to_mel(freq):
    """HTK mel scale (what tf.signal uses)."""
    return 2595.0 * np.log10(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


@functools.lru_cache(maxsize=8)
def linear_to_mel_weight_matrix(
    num_mel_bins: int = 80,
    num_spectrogram_bins: int = 201,
    sample_rate: int = 16000,
    lower_edge_hertz: float = 0.0,
    upper_edge_hertz: float = 8000.0,
) -> np.ndarray:
    """[num_spectrogram_bins, num_mel_bins] float32, TF semantics."""
    bands_to_zero = 1
    nyquist = sample_rate / 2.0
    linear_freqs = np.linspace(0.0, nyquist, num_spectrogram_bins)[bands_to_zero:]
    spectrogram_mels = hertz_to_mel(linear_freqs)[:, None]

    edges = np.linspace(
        hertz_to_mel(lower_edge_hertz), hertz_to_mel(upper_edge_hertz),
        num_mel_bins + 2,
    )
    lower = edges[:-2][None, :]
    center = edges[1:-1][None, :]
    upper = edges[2:][None, :]

    lower_slopes = (spectrogram_mels - lower) / (center - lower)
    upper_slopes = (upper - spectrogram_mels) / (upper - center)
    weights = np.maximum(0.0, np.minimum(lower_slopes, upper_slopes))
    return np.pad(weights, [[bands_to_zero, 0], [0, 0]]).astype(np.float32)


@functools.lru_cache(maxsize=4)
def hann_window(length: int = 400) -> np.ndarray:
    """Periodic Hann window (tf.signal.hann_window default)."""
    n = np.arange(length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / length)).astype(np.float32)


def frame_signal(waveform: torch.Tensor, frame_length: int = 400,
                 frame_step: int = 160) -> torch.Tensor:
    """[..., T] -> [..., num_frames, frame_length] (a strided view),
    pad_end=False."""
    return waveform.unfold(-1, frame_length, frame_step)


def extract_fbank_features(
    waveform: torch.Tensor,
    sample_rate: int = 16000,
    n_mels: int = 80,
    n_fft: int = 400,
    hop_length: int = 160,
) -> torch.Tensor:
    """[..., T] waveform -> [..., num_frames, n_mels] log-mel features by
    rfft (the plain frontend)."""
    frames = frame_signal(waveform.float(), n_fft, hop_length)
    window = torch.from_numpy(hann_window(n_fft)).to(frames.device)
    stft = torch.fft.rfft(frames * window, n=n_fft)
    power = stft.abs().square()
    mel_matrix = torch.from_numpy(linear_to_mel_weight_matrix(
        n_mels, n_fft // 2 + 1, sample_rate, 0.0, float(sample_rate // 2)
    )).to(frames.device)
    return torch.log(power @ mel_matrix + 1e-6)


def log_mel_features(waveform: torch.Tensor, sample_rate: int = 16000,
                     n_mels: int = 80, n_fft: int = 400,
                     hop_length: int = 160) -> torch.Tensor:
    """[..., T] -> [..., F, n_mels] through the fused log-mel kernel."""
    from tethys_tpu_torch.audio.logmel import fused_log_mel

    return fused_log_mel(waveform, sample_rate, n_mels, n_fft, hop_length)


def prepare_input_features(waveform: torch.Tensor, n_frames: int = 3000,
                           n_mels: int = 80) -> torch.Tensor:
    """Waveform [T] or [B, T] -> encoder input [B, n_mels, n_frames]:
    log-mel, transposed to the encoder layout and padded with log(1e-6)
    (or trimmed) to the 30 s frame budget."""
    if waveform.dim() == 1:
        waveform = waveform[None]
    feats = log_mel_features(waveform, n_mels=n_mels).transpose(1, 2)
    f = feats.shape[-1]
    if f < n_frames:
        feats = torch.nn.functional.pad(
            feats, (0, n_frames - f), value=float(np.log(1e-6)))
    else:
        feats = feats[..., :n_frames]
    return feats.contiguous()
