"""The port's int8 cross-attention serving against the JAX package, on the
CPU.

``quantize_kv_cols`` on the same f32 inputs; the plain q8 cross-attention
against the Pallas ``_pallas_q8_cross`` in interpret mode (as
tests/test_pallas_decode.py runs it) and, in f32, against the XLA einsum
``_q8_xla_math``; int8 greedy decoding against JAX's on the tiny config of
tests/test_pallas_decode.py with the JAX model's own weights.  Tolerances
are stated at each check.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.configs import WhisperConfig as JaxConfig
from tethys_tpu.models.whisper import (
    WhisperForConditionalGeneration as JaxWhisper,
    greedy_generate as jax_greedy,
)
from tethys_tpu.ops import pallas_decode as pd
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.models.whisper import (
    WhisperForConditionalGeneration,
    greedy_generate,
    init_kv_caches,
)
from tethys_tpu_torch.ops import decode

torch.set_num_threads(2)

TINY = dict(
    d_model=64, encoder_layers=2, encoder_attention_heads=4,
    decoder_layers=2, decoder_attention_heads=4, d_ff=128,
    n_mels=8, n_ctx=32, vocab_size=50, max_target_positions=16,
    decoder_start_token_id=47,
)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(
        np.float32)


def test_quantize_kv_cols_matches_jax():
    """int8 values equal but where x / scale lies within 1e-6 of a rounding
    boundary (two f32 divisions may land on either side), there +-1; no
    more than 0.1% of values may sit there.  Scales within 1e-6 relative."""
    x = _rand(0, 2, 4, 16, 40) * np.linspace(0.1, 5, 40, dtype=np.float32)
    want8, want_s = map(np.asarray, pd.quantize_kv_cols(jnp.asarray(x)))
    got8, got_s = decode.quantize_kv_cols(torch.from_numpy(x))
    assert got8.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got8.shape == (2, 4, 16, 40) and got_s.shape == (2, 4, 1, 40)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6, atol=0)
    gap = np.abs(got8.numpy().astype(np.int32) - want8.astype(np.int32))
    assert gap.max() <= 1
    frac = np.abs(x / want_s - np.round(x / want_s))
    assert np.all(np.abs(frac[gap > 0] - 0.5) < 1e-6)
    assert (gap > 0).mean() <= 1e-3
    # Round half to even, clipped to +-127, and 1e-30 guards a zero column.
    zeros = torch.zeros(1, 1, 3, 2)
    z8, zs = decode.quantize_kv_cols(zeros)
    assert not z8.any() and torch.allclose(zs, torch.full_like(zs, 1e-30 / 127))
    half = torch.tensor([2.5, -2.5, 127.0, 0.5]).reshape(1, 1, 4, 1)
    h8, _ = decode.quantize_kv_cols(half)
    assert h8.flatten().tolist() == [2, -2, 127, 0]


def _q8_args(seed, b, h, d, t, dtype):
    k8, sk = pd.quantize_kv_cols(jnp.asarray(_rand(seed + 1, b, h, d, t)))
    v8, sv = pd.quantize_kv_cols(jnp.asarray(_rand(seed + 2, b, h, d, t)))
    q = jnp.asarray(_rand(seed, b, h, 1, d, scale=d ** -0.5)).astype(dtype)
    return q, k8, sk, v8, sv


def _torch(args, dtype):
    q, *caches = args
    return (torch.from_numpy(np.array(q, np.float32)).to(dtype),
            *(torch.from_numpy(np.array(a)) for a in caches))


@pytest.mark.parametrize("kv_len", [None, 40])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_plain_q8_cross_matches_pallas_interpret(monkeypatch, kv_len, dtype, tol):
    """Against the TPU kernel in interpret mode (the numerics it follows):
    f32 to 2e-5 (two f32 sums in other orders); bf16 to 2e-2 (the output
    is bf16 below 2, where one bf16 step is at most 0.0078; p is rounded to
    bf16 on both sides)."""
    monkeypatch.setattr(pd, "_INTERPRET", True)
    monkeypatch.setattr(pd, "_Q8_XLA", False)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    args = _q8_args(0, 2, 4, 16, 48, jdt)
    eff = 48 if kv_len is None else kv_len
    want = np.asarray(pd._pallas_q8_cross(*args, kv_len=eff), np.float32)
    tdt = getattr(torch, dtype)
    got = decode.decode_cross_attention_q8(*_torch(args, tdt), kv_len=kv_len)
    assert got.dtype == tdt and got.shape == (2, 4, 1, 16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    if dtype == "float32":
        # In f32 the XLA einsum (JAX's default on the chip) keeps p * sv in
        # f32 as the kernel does: the same function, to 2e-5.
        xla = np.asarray(pd._q8_xla_math(*args, eff))
        np.testing.assert_allclose(got.numpy(), xla, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kv_len", [None, 1000])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_plain_q8_cross_matches_pallas_interpret_whisper_shape(
        monkeypatch, kv_len, dtype, tol):
    """The same check at whisper's own cross-attention shape: D 64 and
    Tk 1500 (1500 encoder frames), all of them valid or the first 1000."""
    monkeypatch.setattr(pd, "_INTERPRET", True)
    monkeypatch.setattr(pd, "_Q8_XLA", False)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    args = _q8_args(5, 2, 4, 64, 1500, jdt)
    eff = 1500 if kv_len is None else kv_len
    want = np.asarray(pd._pallas_q8_cross(*args, kv_len=eff), np.float32)
    tdt = getattr(torch, dtype)
    got = decode.decode_cross_attention_q8(*_torch(args, tdt), kv_len=kv_len)
    assert got.dtype == tdt and got.shape == (2, 4, 1, 64)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_q8_cross_refuses_other_devices():
    q = torch.empty(1, 2, 1, 4, device="meta")
    k8 = torch.empty(1, 2, 4, 8, dtype=torch.int8, device="meta")
    s = torch.empty(1, 2, 1, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        decode.decode_cross_attention_q8(q, k8, s, k8, s)


@pytest.fixture(scope="module")
def tiny():
    config = JaxConfig(**TINY)
    model = JaxWhisper(config)
    features = _rand(3, 2, 8, 64)
    labels = np.random.default_rng(4).integers(3, 40, size=(2, 10)).astype(
        np.int32)
    rng = jax.random.PRNGKey(5)
    params = model.init({"params": rng, "dropout": rng},
                        jnp.asarray(features), labels=jnp.asarray(labels),
                        deterministic=True)["params"]
    return params, features


def _port(params, **overrides):
    model = WhisperForConditionalGeneration(
        WhisperConfig(**{**TINY, **overrides}))
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model.eval()


def test_int8_greedy_tokens_equal_jax(tiny):
    """f32, the JAX model's weights: tokens and length identical."""
    params, features = tiny
    jmodel = JaxWhisper(dataclasses.replace(JaxConfig(**TINY), kv_quant="int8"))
    want, want_len = jax_greedy(jmodel, {"params": params},
                                jnp.asarray(features), max_length=8)
    port = _port(params, kv_quant="int8")
    got, length = greedy_generate(port, torch.from_numpy(features),
                                  max_length=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(length) == int(want_len)


def test_int8_step_logits_track_the_full_precision_cache(tiny):
    """Step-1 logits through the int8 caches against kv_quant="none":
    relative error below 5e-3 and the same argmax."""
    params, features = tiny
    feats = torch.from_numpy(features)
    logits = {}
    for quant in ("none", "int8"):
        port = _port(params, kv_quant=quant)
        with torch.inference_mode():
            kvs = port.precompute_cross_kv(port.encode(feats))
            caches = init_kv_caches(port.config, 2, 4, feats.device)
            start = torch.full((2, 1), TINY["decoder_start_token_id"],
                               dtype=torch.int32)
            logits[quant] = port.decode_step(start, caches, 0, kvs)[:, -1]
        assert len(kvs[0]) == (4 if quant == "int8" else 2)
    ref, q8 = logits["none"], logits["int8"]
    rel = ((q8 - ref).norm() / ref.norm()).item()
    assert rel < 5e-3
    assert torch.equal(q8.argmax(-1), ref.argmax(-1))


def test_int8_cache_takes_no_bias(tiny):
    params, features = tiny
    port = _port(params, kv_quant="int8")
    attn = port.model.decoder.layers[0].encoder_attn
    with torch.inference_mode():
        kv = attn.project_kv(port.encode(torch.from_numpy(features)))
        x = torch.zeros(2, 1, TINY["d_model"])
        assert attn.decode_cross(x, kv).shape == (2, 1, TINY["d_model"])
        with pytest.raises(ValueError, match="no attention bias"):
            attn.decode_cross(x, kv, bias=torch.zeros(1, 1, 1, 64))
