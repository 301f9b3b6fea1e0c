"""Transcription (tethys_tpu/inference.py ``transcribe_audio``).

waveform -> log-mel features (audio/frontend.py) -> greedy decode
(models/whisper.py) on the model's device.  ``transcribe_batch`` serves a
few requests in one call: [B, T] waveforms decode as one batch.
``transcribe_long_audio`` waits for the streaming frontend (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tethys_tpu_torch.audio.frontend import prepare_input_features
from tethys_tpu_torch.models.whisper import greedy_generate


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
