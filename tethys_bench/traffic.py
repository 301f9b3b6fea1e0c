"""The one traffic generator: a mix's data file (``traffic/<mix>.json``)
gives its parameters, and this turns them and the run's seed into a pool
of distinct batches, as numpy arrays (what a training job's dataset
yields).  Training is a closed loop: the next step is dispatched as soon
as the loop has dispatched this one and fetched the previous one's loss,
so there are no arrival times.

Input kinds (``inputs``):
- ``log_mel_and_labels``: features [batch, n_mels, frames] float32 drawn
  N(0, 1) (log-mel frames at 100 a second), labels [batch, label_len]
  int32: the configuration's BOS id, ids uniform in ``label_ids`` [lo,
  hi), its EOS id at a length uniform in ``eos_length`` [lo, hi), its pad
  id after;
- ``waveform``: audio [batch, samples] float32 drawn N(0, 1) times
  ``amplitude`` (16 kHz), labels [batch] float32 zeros.

Every seed gives the same shapes; only the values move with it.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

SAMPLE_RATE = 16000
FRAME_RATE = 100


def pool(traffic: dict, config: dict, seed: int) -> List[Tuple[np.ndarray,
                                                               ...]]:
    """``traffic["pool"]`` distinct batches from ``seed``."""
    rng = np.random.default_rng(int(seed))
    b = traffic["batch"]
    out = []
    for _ in range(traffic["pool"]):
        if traffic["inputs"] == "log_mel_and_labels":
            features = rng.standard_normal(
                (b, config["n_mels"], traffic["frames"]), dtype=np.float32)
            lo, hi = traffic["label_ids"]
            n = traffic["label_len"]
            labels = rng.integers(lo, hi, size=(b, n), dtype=np.int32)
            lengths = rng.integers(*traffic["eos_length"], size=b)
            col = np.arange(n)[None, :]
            labels = np.where(col == lengths[:, None] - 1,
                              config["eos_token_id"], labels)
            labels = np.where(col >= lengths[:, None],
                              config["pad_token_id"], labels)
            labels[:, 0] = config["bos_token_id"]
            out.append((features, labels.astype(np.int32)))
        elif traffic["inputs"] == "waveform":
            audio = rng.standard_normal((b, traffic["samples"]),
                                        dtype=np.float32)
            audio *= np.float32(traffic["amplitude"])
            out.append((audio, np.zeros((b,), dtype=np.float32)))
        else:
            raise ValueError(f"unknown input kind {traffic['inputs']!r}")
    return out


def audio_seconds(traffic: dict) -> float:
    """Seconds of audio in one batch."""
    if traffic["inputs"] == "log_mel_and_labels":
        return traffic["batch"] * traffic["frames"] / FRAME_RATE
    return traffic["batch"] * traffic["samples"] / SAMPLE_RATE


class Feed:
    """The batches of a pool in turn, endlessly, from batch ``start``."""

    def __init__(self, batches, start: int = 0):
        self.batches = batches
        self.start = start

    def __iter__(self):
        i = self.start
        while True:
            yield self.batches[i % len(self.batches)]
            i += 1
