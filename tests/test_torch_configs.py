"""The port's WhisperConfig and flax -> torch weight converter."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.configs import WhisperConfig as JaxConfig
from tethys_tpu.models.whisper import WhisperForConditionalGeneration as JaxWhisper
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import params_from_flax, torch_name
from tethys_tpu_torch.models.whisper import (
    WhisperForConditionalGeneration,
    create_whisper_model,
    greedy_generate,
)

torch.set_num_threads(2)

PRESETS = ["tiny", "base", "small", "medium", "large", "large-v3"]


@pytest.mark.parametrize("size", PRESETS)
def test_presets_match_jax_field_for_field(size):
    port = dataclasses.asdict(WhisperConfig.from_size(size))
    ref = dataclasses.asdict(JaxConfig.from_size(size))
    assert port == ref
    assert [f.name for f in dataclasses.fields(WhisperConfig)] == [
        f.name for f in dataclasses.fields(JaxConfig)]


def test_remat_layers_is_refused_until_ported():
    """remat_layers=True raises, naming its ROADMAP item; remat_policy is
    kept as a field (as in the JAX config) and the default builds."""
    with pytest.raises(ValueError, match="queue 1 item 7"):
        WhisperConfig(remat_layers=True)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        WhisperConfig.from_size("base", remat_layers=True)
    cfg = WhisperConfig.from_size("base", remat_policy="nothing")
    assert (cfg.remat_layers, cfg.remat_policy) == (False, "nothing")


@pytest.mark.parametrize("name,dtype", [("float32", torch.float32),
                                        ("bfloat16", torch.bfloat16)])
def test_dtype_resolves_to_torch(name, dtype):
    assert WhisperConfig(compute_dtype=name).dtype == dtype


def test_kv_quant_int8_builds_and_decodes():
    """kv_quant="int8" builds, holds its cross caches as int8 with f32
    per-column scales, and decodes; any other value than "none" or "int8"
    raises."""
    kw = dict(d_model=16, encoder_attention_heads=2, decoder_attention_heads=2,
              encoder_layers=1, decoder_layers=1, d_ff=32, vocab_size=10,
              n_mels=8, n_ctx=8, max_target_positions=6,
              decoder_start_token_id=9)
    model, cfg = create_whisper_model(device="cpu", kv_quant="int8", **kw)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 16), dtype=np.float32))
    with torch.inference_mode():
        (k8, sk, v8, sv), = model.precompute_cross_kv(model.encode(feats))
    assert k8.dtype == v8.dtype == torch.int8 and k8.shape == (2, 2, 8, 8)
    assert sk.dtype == sv.dtype == torch.float32 and sk.shape == (2, 2, 1, 8)
    tokens, length = greedy_generate(model, feats, max_length=5)
    assert tokens.shape == (2, 6) and (tokens[:, 0] == 9).all()
    assert ((tokens >= 0) & (tokens < cfg.vocab_size)).all()
    assert 1 <= int(length) <= 6
    with pytest.raises(ValueError, match="kv_quant"):
        WhisperForConditionalGeneration(WhisperConfig(**kw, kv_quant="int4"))


def test_converter_names_and_shapes():
    kw = dict(d_model=32, encoder_layers=2, encoder_attention_heads=4,
              decoder_layers=1, decoder_attention_heads=4, d_ff=48, n_mels=8,
              n_ctx=16, vocab_size=40, max_target_positions=8)
    jmodel = JaxWhisper(JaxConfig(**kw))
    params = jmodel.init({"params": jax.random.PRNGKey(0)},
                         jnp.zeros((1, 8, 32)),
                         labels=jnp.zeros((1, 3), jnp.int32))["params"]
    params = jax.device_get(params)
    state = params_from_flax(params)
    port = WhisperForConditionalGeneration(WhisperConfig(**kw))
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    assert all(v.dtype == torch.float32 for v in state.values())
    enc = params["model"]["encoder"]
    q = enc["layers_1"]["self_attn"]["q_proj"]["kernel"]
    np.testing.assert_array_equal(
        state["model.encoder.layers.1.self_attn.q_proj.weight"].numpy(), q.T)
    conv = enc["conv1"]["kernel"]                        # [k, in, out]
    np.testing.assert_array_equal(
        state["model.encoder.conv1.weight"].numpy(), conv.transpose(2, 1, 0))
    np.testing.assert_array_equal(
        state["lm_head.weight"].numpy(), params["lm_head"]["kernel"].T)
    assert torch_name(("model", "decoder", "layers_0", "encoder_attn_layer_norm",
                       "scale")) == "model.decoder.layers.0.encoder_attn_layer_norm.weight"
    assert torch_name(("model", "decoder", "embed_tokens", "embedding")) == \
        "model.decoder.embed_tokens.weight"


def test_create_model_is_seeded_and_held_in_compute_dtype():
    kw = dict(d_model=32, encoder_layers=1, encoder_attention_heads=4,
              decoder_layers=1, decoder_attention_heads=4, d_ff=48, n_mels=8,
              n_ctx=16, vocab_size=40, max_target_positions=8)
    a, _ = create_whisper_model(seed=3, device="cpu", **kw)
    b, _ = create_whisper_model(seed=3, device="cpu", **kw)
    c, cfg = create_whisper_model(seed=3, device="cpu",
                                  compute_dtype="bfloat16", **kw)
    for (name, pa), pb, pc in zip(a.state_dict().items(),
                                  b.state_dict().values(),
                                  c.state_dict().values()):
        assert torch.equal(pa, pb), name
        assert pc.dtype == torch.bfloat16
        torch.testing.assert_close(pc, pa.bfloat16(), rtol=0, atol=0)
    w = a.model.encoder.layers[0].feed_forward.fc1.weight
    assert w.abs().max() <= (6.0 / (32 + 48)) ** 0.5
    assert not a.training
