"""Synthetic data with the reference's shapes (tethys_tpu/data.py).

* Whisper: 50 samples of random log-mel features [80, 3000] and labels of
  length 100: BOS = 1, random ids in [3, 100), EOS = 2 at a random length
  in [50, 90), zero padding after (reference
  speech_jobs/whisper_dist.py:784-815); the short final batch is padded
  cyclically to keep shapes static.
* Wav2Vec2: 50 random waveforms of 32000 samples (2 s at 16 kHz; the
  base-only jobs use 80000) with scalar 0.0 labels, batched with
  drop_remainder (reference speech_jobs/wav2vec2_dist.py:1123-1153).

Pure numpy from the same seed as the JAX package, so both give the same
batches.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


class DummyBatcher:
    """Infinite batch iterator over a fixed in-memory sample set."""

    def __init__(self, arrays: Tuple[np.ndarray, ...], batch_size: int,
                 drop_remainder: bool):
        self.arrays = arrays
        self.num_samples = arrays[0].shape[0]
        self.batch_size = batch_size
        self.drop_remainder = drop_remainder
        if drop_remainder and self.num_samples < batch_size:
            raise ValueError(
                f"batch_size {batch_size} exceeds dataset size "
                f"{self.num_samples} with drop_remainder=True"
            )

    def __iter__(self) -> Iterator[Tuple[np.ndarray, ...]]:
        n, b = self.num_samples, self.batch_size
        while True:  # .repeat()
            num_full = n // b
            for i in range(num_full):
                yield tuple(a[i * b:(i + 1) * b] for a in self.arrays)
            rem = n - num_full * b
            if rem and not self.drop_remainder:
                idx = np.concatenate(
                    [np.arange(num_full * b, n), np.arange(b - rem)]
                )
                yield tuple(a[idx] for a in self.arrays)


def create_whisper_dummy_dataset(
    batch_size: int,
    n_mels: int = 80,
    seq_len: int = 3000,
    max_target_length: int = 100,
    num_samples: int = 50,
    seed: int = 0,
) -> DummyBatcher:
    rng = np.random.default_rng(seed)
    features = rng.standard_normal(
        (num_samples, n_mels, seq_len), dtype=np.float32
    )
    labels = np.zeros((num_samples, max_target_length), dtype=np.int32)
    lengths = rng.integers(50, 90, size=num_samples)
    for i in range(num_samples):
        length = int(lengths[i])
        labels[i, 0] = 1  # BOS
        labels[i, 1:length - 1] = rng.integers(3, 100, size=length - 2)
        labels[i, length - 1] = 2  # EOS
    return DummyBatcher((features, labels), batch_size, drop_remainder=False)


def create_wav2vec2_dummy_dataset(
    batch_size: int,
    audio_length: int = 32000,
    num_samples: int = 50,
    seed: int = 0,
) -> DummyBatcher:
    rng = np.random.default_rng(seed)
    audio = rng.standard_normal((num_samples, audio_length), dtype=np.float32)
    labels = np.zeros((num_samples,), dtype=np.float32)
    return DummyBatcher((audio, labels), batch_size, drop_remainder=True)
