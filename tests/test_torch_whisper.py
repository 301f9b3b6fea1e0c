"""The port's Whisper serving slice against the JAX model, on the CPU.

Same tiny config as tests/test_whisper_model.py, the JAX model's own
initialised parameters converted to the port (convert.params_from_flax),
the same numpy-seeded inputs, all in f32.  Tolerances: per-layer encoder
states and teacher-forced logits to 1e-4 (two f32 implementations that sum
in different orders); greedy tokens and length identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.configs import WhisperConfig as JaxConfig
from tethys_tpu.inference import transcribe_audio as jax_transcribe
from tethys_tpu.models.whisper import (
    WhisperForConditionalGeneration as JaxWhisper,
    greedy_generate as jax_greedy,
)
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.inference import (
    transcribe_audio,
    transcribe_batch,
    transcribe_long_audio,
)
from tethys_tpu_torch.models.whisper import (
    WhisperForConditionalGeneration,
    greedy_generate,
)
from tethys_tpu_torch.utils import kernel_lib

torch.set_num_threads(2)

TINY = dict(
    d_model=64, encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4, d_ff=128,
    n_mels=8, n_ctx=32, vocab_size=50, max_target_positions=16,
    decoder_start_token_id=47,
)
TOL = 1e-4


def _port(params, **overrides):
    model = WhisperForConditionalGeneration(WhisperConfig(**{**TINY, **overrides}))
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model.eval()


@pytest.fixture(scope="module")
def tiny():
    config = JaxConfig(**TINY)
    model = JaxWhisper(config)
    rng = jax.random.PRNGKey(0)
    features = np.random.default_rng(0).standard_normal(
        (2, 8, 64), dtype=np.float32)
    labels = np.random.default_rng(1).integers(3, 40, size=(2, 10)).astype(
        np.int32)
    params = model.init({"params": rng, "dropout": rng}, jnp.asarray(features),
                        labels=jnp.asarray(labels), deterministic=True)["params"]
    return model, params, features, labels, _port(params)


def test_encoder_states_per_layer_match_jax(tiny):
    model, params, features, _, port = tiny
    want, inter = model.apply(
        {"params": params}, jnp.asarray(features), method=model.encode,
        capture_intermediates=True, mutable=["intermediates"])
    enc_inter = inter["intermediates"]["model"]["encoder"]
    with torch.inference_mode():
        got, states = port.model.encoder(torch.from_numpy(features),
                                         output_hidden_states=True)
    assert len(states) == TINY["encoder_layers"] + 1
    for i, state in enumerate(states[1:]):
        ref = np.asarray(enc_inter[f"layers_{i}"]["__call__"][0])
        np.testing.assert_allclose(state.numpy(), ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_teacher_forced_logits_match_jax(tiny):
    model, params, features, labels, port = tiny
    ids = np.concatenate(
        [np.full((2, 1), TINY["decoder_start_token_id"], np.int32),
         labels[:, :-1]], axis=1)
    want = model.apply({"params": params}, jnp.asarray(features),
                       decoder_input_ids=jnp.asarray(ids))
    with torch.inference_mode():
        got = port(torch.from_numpy(features), torch.from_numpy(ids))
    assert got["logits"].shape == (2, 10, TINY["vocab_size"])
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got["encoder_last_hidden_state"].numpy(),
                               np.asarray(want["encoder_last_hidden_state"]),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("max_length", [16, 5])
def test_greedy_tokens_identical_to_jax(tiny, max_length):
    model, params, features, _, port = tiny
    want_tokens, want_len = jax_greedy(model, {"params": params},
                                       jnp.asarray(features),
                                       max_length=max_length)
    tokens, length = greedy_generate(port, torch.from_numpy(features),
                                     max_length=max_length)
    assert tokens.dtype == torch.int32
    assert tokens.shape == (2, max_length + 1)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    assert int(length) == int(want_len)


def test_greedy_done_mask_matches_jax(tiny):
    """Every row emits the same first token; declaring it EOS exercises the
    global stop: pad afterwards, length frozen at 2."""
    model, params, features, _, _ = tiny
    same = np.broadcast_to(features[:1], features.shape).copy()
    probe, _ = jax_greedy(model, {"params": params}, jnp.asarray(same),
                          max_length=2)
    eos = int(np.asarray(probe)[0, 1])
    jax_model = JaxWhisper(dataclasses.replace(JaxConfig(**TINY),
                                               eos_token_id=eos))
    want_tokens, want_len = jax_greedy(jax_model, {"params": params},
                                       jnp.asarray(same), max_length=8)
    port = _port(params, eos_token_id=eos)
    tokens, length = greedy_generate(port, torch.from_numpy(same),
                                     max_length=8)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(want_tokens))
    assert int(length) == int(want_len) == 2
    assert (tokens.numpy()[:, 2:] == TINY.get("pad_token_id", 0)).all()


def test_transcribe_audio_matches_jax(tiny):
    model, params, _, _, port = tiny
    wave = np.random.default_rng(7).standard_normal(8000).astype(np.float32)
    want = jax_transcribe(model, {"params": params}, wave, max_length=12)
    got = transcribe_audio(port, wave, max_length=12)
    np.testing.assert_array_equal(got, np.asarray(want))
    both = transcribe_batch(port, np.stack([wave, wave]), max_length=12)
    np.testing.assert_array_equal(both[0], got)
    np.testing.assert_array_equal(both[1], got)


def test_cpu_slice_launches_no_kernel(tiny, monkeypatch):
    """CPU tensors take every kernel's plain version: the whole slice, and
    the int8 long-audio slice with the fused projections, leave every
    launch counter at 0."""
    port = tiny[4]
    kernel_lib.reset_launch_counts()
    wave = np.random.default_rng(8).standard_normal(4000).astype(np.float32)
    transcribe_audio(port, wave, max_length=4)
    monkeypatch.setenv("TETHYS_FUSED_QKV", "1")
    transcribe_long_audio(_port(tiny[1], kv_quant="int8"), wave, max_length=4)
    assert kernel_lib.launch_counts() == {
        "log_mel": 0, "split_heads": 0, "merge_heads": 0, "flash_fwd": 0,
        "flash_fwd_dropout": 0, "flash_bwd": 0, "dropout": 0,
        "decode_self": 0, "gn_stats": 0, "gn_grad_sums": 0, "gn_apply": 0,
        "gn_apply_bwd": 0, "q8_cross": 0, "proj_split": 0, "merge_proj": 0}
