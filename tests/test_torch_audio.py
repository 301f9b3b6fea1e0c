"""The port's audio frontend and log-mel plain version against the JAX
package, on the CPU, from numpy-seeded waveforms.

Tolerances, in the log domain: 1e-4 between two f32 computations of the
same DFT (rfft against the window-folded DFT products sum in different
orders); the JAX fused kernel in interpret mode keeps its bf16x3 split
products, so it is held to 2e-3 as tests/test_audio.py holds it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.audio import frontend as jfe
from tethys_tpu.audio import pallas_logmel
from tethys_tpu_torch.audio import frontend, logmel

torch.set_num_threads(2)


def _wave(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_constants_equal_jax():
    np.testing.assert_array_equal(frontend.hann_window(400),
                                  jfe.hann_window(400))
    for n_mels in (80, 128, 8):
        np.testing.assert_array_equal(
            frontend.linear_to_mel_weight_matrix(n_mels, 201, 16000, 0.0,
                                                 8000.0),
            jfe.linear_to_mel_weight_matrix(n_mels, 201, 16000, 0.0, 8000.0))
    cos_m, sin_m = logmel.dft_matrices(400)
    j_cos, j_sin = pallas_logmel._dft_matrices(400, 512)
    np.testing.assert_array_equal(cos_m, j_cos[:400])
    np.testing.assert_array_equal(sin_m, j_sin[:400])
    assert not j_cos[400:].any() and not j_sin[400:].any()


@pytest.mark.parametrize("n_mels", [80, 128])
def test_plain_log_mel_matches_jax_frontend(n_mels):
    wave = _wave(0, 2, 16000)
    want = np.asarray(jfe.extract_fbank_features(jnp.asarray(wave),
                                                 n_mels=n_mels))
    got = logmel.fused_log_mel(torch.from_numpy(wave), n_mels=n_mels)
    assert got.shape == want.shape == (2, 98, n_mels)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    plain = frontend.extract_fbank_features(torch.from_numpy(wave),
                                            n_mels=n_mels)
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-4, atol=1e-4)


def test_plain_log_mel_matches_pallas_interpret(monkeypatch):
    monkeypatch.setattr(pallas_logmel, "_INTERPRET", True)
    wave = _wave(1, 2, 12000)
    want = np.asarray(pallas_logmel.fused_log_mel(jnp.asarray(wave)))
    got = logmel.fused_log_mel(torch.from_numpy(wave))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("seconds,n_frames", [(1.0, 120), (1.0, 64)])
def test_prepare_input_features_matches_jax(seconds, n_frames):
    """Padding with log(1e-6) past the audio (98 frames -> 120) and
    trimming (-> 64), in the [B, n_mels, T] encoder layout."""
    wave = _wave(2, int(16000 * seconds))
    want = np.asarray(jfe.prepare_input_features(jnp.asarray(wave),
                                                 n_frames=n_frames))
    got = frontend.prepare_input_features(torch.from_numpy(wave),
                                          n_frames=n_frames)
    assert got.shape == want.shape == (1, 80, n_frames)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    batched = frontend.prepare_input_features(
        torch.from_numpy(np.stack([wave, wave])), n_frames=n_frames)
    np.testing.assert_array_equal(batched[1].numpy(), got[0].numpy())


def test_thirty_seconds_is_2998_frames_padded_to_3000():
    wave = torch.from_numpy(_wave(3, 16000 * 30))
    feats = frontend.prepare_input_features(wave, n_frames=3000, n_mels=80)
    assert feats.shape == (1, 80, 3000)
    assert (feats[0, :, :2998] > np.log(1e-6) + 1).all()
    np.testing.assert_allclose(feats[0, :, 2998:].numpy(), np.log(1e-6),
                               rtol=1e-6)
