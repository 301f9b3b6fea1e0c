"""Transcription and text preprocessing (tethys_tpu/inference.py).

``preprocess_text`` tokenizes and wraps the tokens in BOS/EOS (reference
speech_jobs/whisper_dist.py:770-780).  Transcription:

waveform -> log-mel features (audio/frontend.py) -> greedy decode
(models/whisper.py) on the model's device.  ``transcribe_batch`` serves a
few requests in one call: [B, T] waveforms decode as one batch.
``transcribe_long_audio`` serves audio of any length as one batch of
exact-seam 30 s windows (audio.frontend.prepare_streaming_features).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tethys_tpu_torch.audio.frontend import (
    prepare_input_features,
    prepare_streaming_features,
)
from tethys_tpu_torch.models.whisper import greedy_generate


def preprocess_text(text: str, tokenizer) -> list:
    """Tokenize and add BOS/EOS (tokenizer: any object with encode and
    bos_token_id/eos_token_id, e.g. a transformers tokenizer)."""
    tokens = tokenizer.encode(text)
    return [tokenizer.bos_token_id] + list(tokens) + [tokenizer.eos_token_id]


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def transcribe_batch(model, waveforms, max_length: int = 448) -> np.ndarray:
    """[B, T] waveforms -> token ids [B, length] (numpy int32), where
    length is the batch's greedy length (start token included)."""
    wav = torch.as_tensor(waveforms, dtype=torch.float32).to(
        _model_device(model))
    if wav.dim() == 1:
        wav = wav[None]
    cfg = model.config
    features = prepare_input_features(wav, n_frames=cfg.n_ctx * 2,
                                      n_mels=cfg.n_mels)
    tokens, length = greedy_generate(model, features, max_length=max_length)
    return tokens[:, : int(length)].cpu().numpy()


def transcribe_audio(
    model,
    waveform=None,
    tokenizer=None,
    max_length: int = 448,
    sample_rate: int = 16000,
    generator: Optional[torch.Generator] = None,
):
    """Waveform [T] -> token ids (or text when a tokenizer is given).

    Like the reference, a missing waveform falls back to 30 s of random
    audio, drawn from ``generator``."""
    if waveform is None:
        waveform = torch.randn(sample_rate * 30, generator=generator)
    ids = transcribe_batch(model, torch.as_tensor(waveform)[None],
                           max_length=max_length)[0]
    if tokenizer is not None:
        return tokenizer.decode(ids)
    return ids


@torch.inference_mode()
def transcribe_long_audio(model, waveform, tokenizer=None,
                          max_length: int = 448, sample_rate: int = 16000):
    """Waveform [T] of any length -> per-window token ids (numpy int32,
    start token included, EOS excluded), or with a tokenizer the windows'
    texts joined by ' '.

    The window is n_ctx mel-frame pairs at a 160-sample hop (30 s at
    n_ctx 1500).  The windows decode as one batch, padded with all-zero
    feature rows up to the next power of two as in JAX (the padded rows
    take part in the all-EOS stop).  Each window is cut at its own first
    EOS: the batch stops only when every row is done, so a window that
    finished early carries tokens after its EOS."""
    cfg = model.config
    wav = torch.as_tensor(waveform, dtype=torch.float32).to(
        _model_device(model))
    window_seconds = cfg.n_ctx * 2 * 160 / sample_rate
    features = prepare_streaming_features(
        wav, n_mels=cfg.n_mels, sample_rate=sample_rate,
        window_seconds=window_seconds)
    n_windows = features.shape[0]
    bucket = 1 << (n_windows - 1).bit_length()
    if bucket > n_windows:
        features = torch.cat([features, features.new_zeros(
            (bucket - n_windows,) + features.shape[1:])])
    tokens, length = greedy_generate(model, features, max_length=max_length)
    toks = tokens[:n_windows].cpu().numpy()
    n = int(length)
    per_window = []
    for row in toks[:, :n]:
        hits = np.nonzero(row == cfg.eos_token_id)[0]
        per_window.append(row[: hits[0]] if hits.size else row)
    if tokenizer is not None:
        return " ".join(tokenizer.decode(ids) for ids in per_window)
    return per_window
