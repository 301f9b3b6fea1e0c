"""The port's long-audio serving against the JAX package, on the CPU: the
exact-seam streaming frontend, ``transcribe_long_audio`` (kv_quant "none"
and "int8"), both early-stop forms of greedy decoding, and the serving
bench's twin.

Tolerances: log-mel features 1e-4 against JAX (two f32 DFTs: rfft against
the window-folded DFT products, as tests/test_torch_audio.py holds them);
the seam property inside the port 1e-5 (the same frames through the same
products, batched differently); token ids identical.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.audio import stream_log_mel as jax_stream_log_mel
from tethys_tpu.configs import WhisperConfig as JaxConfig
from tethys_tpu.inference import transcribe_long_audio as jax_transcribe_long
from tethys_tpu.models.whisper import WhisperForConditionalGeneration as JaxWhisper
import tethys_tpu_torch.inference as inference
from tethys_tpu_torch.audio import frontend
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.models.whisper import (
    WhisperForConditionalGeneration,
    create_whisper_model,
    greedy_generate,
    make_chunked_greedy,
)
from tethys_tpu_torch.scripts import bench_generate

torch.set_num_threads(2)

# tests/test_audio.py's long-audio config: a 1.28 s window (n_ctx 64).
LONG = dict(d_model=32, encoder_layers=1, encoder_attention_heads=2,
            decoder_layers=1, decoder_attention_heads=2, d_ff=64, n_mels=80,
            n_ctx=64, vocab_size=64, max_target_positions=16,
            decoder_start_token_id=60)
TINY = dict(d_model=64, encoder_layers=2, encoder_attention_heads=4,
            decoder_layers=2, decoder_attention_heads=4, d_ff=128, n_mels=8,
            n_ctx=32, vocab_size=50, max_target_positions=16,
            decoder_start_token_id=47)


def _wave(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_stream_log_mel_matches_jax_and_has_exact_seams():
    t = 125 * 16000
    wave = _wave(0, t)
    got = frontend.stream_log_mel(torch.from_numpy(wave))
    assert got.shape == (5, 3000, 80)
    want = np.asarray(jax_stream_log_mel(jnp.asarray(wave)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # Every window frame, the seam-straddling ones included, is the frame
    # of one STFT over the whole zero-padded signal.
    padded = torch.nn.functional.pad(torch.from_numpy(wave),
                                     (0, 5 * 480000 + 240 - t))
    mono = frontend.log_mel_features(padded)
    assert mono.shape == (15000, 80)
    np.testing.assert_allclose(got.reshape(15000, 80).numpy(), mono.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_stream_log_mel_short_input_and_128_mels():
    short = frontend.prepare_streaming_features(
        torch.from_numpy(_wave(1, 4 * 16000)))
    assert short.shape == (1, 80, 3000)
    # The frames the 4 s signal covers equal the padded single request's.
    n_valid = (4 * 16000 - 400) // 160 + 1
    ref = frontend.prepare_input_features(torch.from_numpy(_wave(1, 4 * 16000)))
    np.testing.assert_allclose(short[0, :, :n_valid].numpy(),
                               ref[0, :, :n_valid].numpy(), rtol=1e-6, atol=1e-6)
    v3 = frontend.prepare_streaming_features(torch.zeros(32 * 16000),
                                             n_mels=128)
    assert v3.shape == (2, 128, 3000)
    with pytest.raises(ValueError, match="one \\[T\\] waveform"):
        frontend.stream_log_mel(torch.zeros(2, 100))


@pytest.fixture(scope="module")
def long_params():
    model = JaxWhisper(JaxConfig(**LONG))
    rng = jax.random.PRNGKey(0)
    return model.init({"params": rng, "dropout": rng}, jnp.zeros((1, 80, 128)),
                      labels=jnp.zeros((1, 4), dtype=jnp.int32),
                      deterministic=True)["params"]


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_transcribe_long_audio_matches_jax(long_params, kv_quant):
    """3.3 s at a 1.28 s window: 3 windows (padded to a batch of 4); the
    per-window ids equal JAX's in f32."""
    config = JaxConfig(**LONG, kv_quant=kv_quant)
    wave = _wave(0, int(3.3 * 16000))
    want = jax_transcribe_long(JaxWhisper(config), {"params": long_params},
                               wave, max_length=8)
    port = WhisperForConditionalGeneration(WhisperConfig(**LONG,
                                                         kv_quant=kv_quant))
    port.load_state_dict(params_from_flax(jax.device_get(long_params)))
    got = inference.transcribe_long_audio(port.eval(), wave, max_length=8)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g[0] == 60


def test_transcribe_long_audio_cuts_each_window_at_its_eos(monkeypatch):
    """Each window is cut at its own first EOS, the batch of 3 windows is
    padded to 4 with zero features, and the padded row never reaches the
    result; a tokenizer joins the windows' texts with ' '."""
    model, _ = create_whisper_model(device="cpu", seed=0, **LONG)
    seen = {}

    def fake_generate(model, features, max_length=None):
        seen["features"] = features
        return torch.tensor([[60, 5, 2, 7, 7], [60, 5, 6, 7, 2],
                             [60, 1, 1, 1, 1], [60, 2, 0, 0, 0]],
                            dtype=torch.int32), torch.tensor(5)

    monkeypatch.setattr(inference, "greedy_generate", fake_generate)
    wave = np.zeros(int(3.3 * 16000), dtype=np.float32)
    windows = inference.transcribe_long_audio(model, wave)
    assert seen["features"].shape == (4, 80, 128)
    assert not seen["features"][3].any()
    assert [list(w) for w in windows] == [[60, 5], [60, 5, 6, 7],
                                          [60, 1, 1, 1, 1]]

    class Tok:
        def decode(self, ids):
            return "-".join(map(str, ids))

    text = inference.transcribe_long_audio(model, wave, tokenizer=Tok())
    assert text == "60-5 60-5-6-7 60-1-1-1-1"


@pytest.fixture(scope="module")
def tiny_model():
    model, _ = create_whisper_model(device="cpu", seed=1, **TINY)
    feats = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 64), dtype=np.float32))
    return model, feats


@pytest.mark.parametrize("chunk", [1, 4, 8])
def test_early_stop_forms_equal_the_plain_loop(tiny_model, chunk):
    model, feats = tiny_model
    want, want_len = greedy_generate(model, feats, max_length=8)
    got, length = greedy_generate(model, feats, max_length=8,
                                  early_stop_chunk=chunk, temperature=0.5,
                                  top_k=3)
    assert torch.equal(got, want) and int(length) == int(want_len)
    gen = make_chunked_greedy(model, max_length=8, chunk=chunk)
    got, length = gen(feats)
    assert torch.equal(got, want) and int(length) == int(want_len)
    assert gen.chunks_run == 8 // chunk      # no global EOS: every chunk ran


def test_chunk_must_divide_max_length(tiny_model):
    model, feats = tiny_model
    with pytest.raises(ValueError, match="must divide"):
        greedy_generate(model, feats, max_length=8, early_stop_chunk=3)
    with pytest.raises(ValueError, match="must divide"):
        make_chunked_greedy(model, max_length=8, chunk=3)


def test_chunks_stop_early_after_a_global_eos(tiny_model):
    """Identical rows whose first token is declared EOS: the plain loop
    writes pad for 7 more steps, the chunked forms stop after one chunk,
    with the same tokens and length 2."""
    model, feats = tiny_model
    same = feats[:1].expand_as(feats).contiguous()
    probe, _ = greedy_generate(model, same, max_length=2)
    eos = int(probe[0, 1])
    eos_model, _ = create_whisper_model(device="cpu", seed=1, eos_token_id=eos,
                                        **TINY)
    want, want_len = greedy_generate(eos_model, same, max_length=8)
    assert int(want_len) == 2
    gen = make_chunked_greedy(eos_model, max_length=8, chunk=2)
    got, length = gen(same)
    assert gen.chunks_run == 1
    assert torch.equal(got, want) and int(length) == 2
    got, length = greedy_generate(eos_model, same, max_length=8,
                                  early_stop_chunk=4)
    assert torch.equal(got, want) and int(length) == 2


BENCH_KEYS = {"metric", "value", "unit", "per_token_latency_ms", "encode_ms",
              "rtf_e2e", "batch_size", "decode_len", "dtype", "kv_quant",
              "backend", "device"}


def test_bench_twin_prints_one_json_line(capsys):
    argv = ["--device", "cpu", "--model", "tiny", "--batch_size", "1",
            "--length", "4", "--iters", "1"]
    bench_generate.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    result = json.loads(lines[0])
    assert BENCH_KEYS <= set(result)
    assert result["metric"] == "whisper_tiny_decode_tokens_per_sec_per_chip"
    assert result["decode_len"] == 4 and result["kv_quant"] == "int8"
    assert result["backend"] == "cpu" and result["value"] > 0
    chunked = bench_generate.main(argv + ["--host_chunk", "2", "--force_eos"])
    assert chunked["chunks_run"] == 1 and chunked["decode_len"] == 1


def test_bench_twin_refuses_no_fused_decode(capsys):
    with pytest.raises(SystemExit):
        bench_generate.parse_args(["--no_fused_decode"])
    assert "not ported" in capsys.readouterr().err
