"""The port's streaming metrics (tethys_tpu_torch/metrics.py) against the
JAX package's (tethys_tpu/metrics.py) on the same numpy inputs, on the CPU:
accumulated results equal exactly (counts of integers), ties included
(both take the first maximal index)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu import metrics as jax_metrics
from tethys_tpu_torch import metrics


def test_mean_matches_jax():
    ours, theirs = metrics.Mean("loss"), jax_metrics.Mean("loss")
    rng = np.random.default_rng(0)
    values = rng.standard_normal(7).astype(np.float32)
    for value, weight in zip(values, [1, 2, 1, 0.5, 1, 3, 1]):
        ours.update_state(torch.tensor(value), weight)
        theirs.update_state(jnp.asarray(value), weight)
        assert ours.result() == theirs.result()
    assert ours.name == "loss"
    ours.reset_state()
    assert ours.result() == 0.0 and ours.count == 0


@pytest.mark.parametrize("ties", [False, True])
def test_sparse_categorical_accuracy_matches_jax(ties):
    rng = np.random.default_rng(1)
    ours, theirs = (metrics.SparseCategoricalAccuracy(),
                    jax_metrics.SparseCategoricalAccuracy())
    for _ in range(3):
        logits = rng.standard_normal((4, 5, 6)).astype(np.float32)
        if ties:
            logits = np.round(logits)        # many equal maxima
        labels = rng.integers(0, 6, size=(4, 5)).astype(np.int32)
        ours.update_state(torch.from_numpy(labels), torch.from_numpy(logits))
        theirs.update_state(jnp.asarray(labels), jnp.asarray(logits))
        assert (ours.correct, ours.count) == (theirs.correct, theirs.count)
        assert ours.result() == theirs.result()
    ours.reset_state()
    assert ours.result() == 0.0


@pytest.mark.parametrize("shift", [True, False])
def test_token_accuracy_matches_jax(shift):
    rng = np.random.default_rng(2)
    logits = np.round(rng.standard_normal((3, 9, 5))).astype(np.float32)
    labels = rng.integers(0, 5, size=(3, 9)).astype(np.int32)
    correct, total = metrics.token_accuracy(
        torch.from_numpy(logits), torch.from_numpy(labels), shift=shift)
    want_correct, want_total = jax_metrics.token_accuracy(
        jnp.asarray(logits), jnp.asarray(labels), shift=shift)
    assert correct.dtype == total.dtype == torch.int32
    assert (int(correct), int(total)) == (int(want_correct), int(want_total))
