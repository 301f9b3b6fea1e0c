"""The port's FLOP count (tethys_tpu_torch/profiling/flops.py) against the
JAX package's (tethys_tpu/profiling/flops.py), on the CPU.

The kernels' analytic FLOPs equal JAX's exactly, with JAX's gate forced as
tests/test_flops.py forces it and the port's gate told it runs on a card;
``step_flops`` of a tiny Whisper and a tiny Wav2Vec2 step equals a hand
count of their products and convs within 1%; ``steady_state_step_time``
equals JAX's on the same lists.
"""

import numpy as np
import pytest
import torch

from tethys_tpu import configs as jax_configs
from tethys_tpu.ops import attention as jax_attention
from tethys_tpu.profiling import flops as jax_flops
from tethys_tpu.train import loop as jax_loop
from tethys_tpu_torch import configs
from tethys_tpu_torch.ops import qkv
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.profiling import flops
from tethys_tpu_torch.train import jobs
from tethys_tpu_torch.train import loop
from _torch_wav2vec2_common import AUDIO, NO_DROPOUT as W2V_NO_DROPOUT
from _torch_wav2vec2_common import TINY as W2V_TINY

torch.set_num_threads(2)

WHISPER_TINY = dict(
    d_model=32, encoder_layers=1, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=64, vocab_size=128, max_target_positions=128,
    decoder_start_token_id=101, dropout=0.0, attention_dropout=0.0,
    activation_dropout=0.0)
FRAMES = 64
LABELS = 100                # the dummy dataset's label length


@pytest.fixture()
def force_flash(monkeypatch):
    # JAX's gate asks for a TPU target; take the escape hatch its own tests
    # take (tests/test_flops.py).
    monkeypatch.setattr(jax_attention, "_FLASH_FORCE", True)


@pytest.mark.parametrize("size", ["base", "tiny", "large-v3"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_whisper_custom_call_flops_equal_jax(force_flash, size, remat,
                                             training):
    kw = dict(training=training, whole_loss_remat=remat)
    want = jax_flops.whisper_custom_call_flops(
        jax_configs.WhisperConfig.from_size(size), 16, label_len=100, **kw)
    got = flops.whisper_custom_call_flops(
        configs.WhisperConfig.from_size(size), 16, label_len=100,
        is_cuda=True, **kw)
    assert want > 0 and got == want
    # The CPU runs the plain attention, which the counter sees.
    assert flops.whisper_custom_call_flops(
        configs.WhisperConfig.from_size(size), 16, label_len=100,
        is_cuda=False, **kw) == 0.0


def test_whisper_gate_off_equals_jax(force_flash):
    want = jax_flops.whisper_custom_call_flops(
        jax_configs.WhisperConfig.from_size("base", use_flash_attention=False),
        16, label_len=100)
    got = flops.whisper_custom_call_flops(
        configs.WhisperConfig.from_size("base", use_flash_attention=False),
        16, label_len=100, is_cuda=True)
    assert got == want == 0.0


@pytest.mark.parametrize("samples,flash", [(32000, False), (None, True)])
def test_wav2vec2_custom_call_flops_equal_jax(force_flash, samples, flash):
    """Short clips (T = 100) never take the flash kernel; long ones would,
    where a config asks for it (frames 1000, ~30 s)."""
    jcfg = jax_configs.Wav2Vec2Config.from_size("base")
    cfg = configs.Wav2Vec2Config.from_size("base")
    if flash:
        object.__setattr__(jcfg, "use_flash_attention", True)
        object.__setattr__(cfg, "use_flash_attention", True)
    frames = cfg.downsampled_length(samples) if samples else 1000
    assert frames == (jcfg.downsampled_length(samples) if samples else 1000)
    want = jax_flops.wav2vec2_custom_call_flops(jcfg, 32, frames)
    got = flops.wav2vec2_custom_call_flops(cfg, 32, frames, is_cuda=True)
    assert got == want
    assert (want > 0) == flash


def _whisper_hand_count(cfg, b, frames, labels) -> float:
    """Products of one Whisper train step with the plain attention: the
    forward once, its backward twice (input and weight gradients), except
    conv1, whose input (the features) takes no gradient."""
    d, f, v, m = cfg.d_model, cfg.d_ff, cfg.vocab_size, cfg.n_mels
    te = frames // 2
    conv1 = 2 * b * frames * d * m * 3
    conv2 = 2 * b * te * d * d * 3
    enc = cfg.encoder_layers * (
        4 * 2 * b * te * d * d + 2 * 2 * b * te * te * d
        + 2 * 2 * b * te * d * f)
    dec = cfg.decoder_layers * (
        4 * 2 * b * labels * d * d + 2 * 2 * b * labels * labels * d
        + 2 * 2 * b * labels * d * d + 2 * 2 * b * te * d * d
        + 2 * 2 * b * labels * te * d + 2 * 2 * b * labels * d * f)
    logits = 2 * b * labels * d * v
    return 2 * conv1 + 3 * (conv2 + enc + dec + logits)


def _whisper_step(fused: bool, monkeypatch):
    if fused:
        monkeypatch.setenv("TETHYS_FUSED_QKV", "1")
    else:
        monkeypatch.delenv("TETHYS_FUSED_QKV", raising=False)
    job = jobs.make_whisper_job("tiny", 2, 1e-4, "float32", seed=0,
                                data_seq_len=FRAMES,
                                config_overrides=WHISPER_TINY, device="cpu")
    batch = job.prepare_batch(next(iter(job.dataset)))
    return job, batch


@pytest.mark.parametrize("fused", [False, True])
def test_whisper_step_flops_match_a_hand_count(monkeypatch, fused):
    """The tiny step's count equals the hand count, with or without the
    fused projections (their plain versions are products the counter
    sees); on the CPU no kernel is counted analytically."""
    job, batch = _whisper_step(fused, monkeypatch)
    result = flops.step_flops(job.step_fn, job.state, batch,
                              dp.step_generator(0, 0))
    want = _whisper_hand_count(job.config, 2, FRAMES, LABELS)
    assert result.custom == 0.0
    assert result.counted == pytest.approx(want, rel=0.01)
    assert result.total == result.counted
    assert np.isfinite(result.loss.item()) and result.state is job.state


def test_fused_projection_flops_equal_what_the_plain_versions_run(
        monkeypatch):
    """whisper_fused_projection_flops, which the card adds for
    csrc/qkv_proj.cu's forward, equals the FLOPs of every call of the
    fused projections' plain versions in one tiny step's forward."""
    from torch.utils.flop_counter import FlopCounterMode

    job, batch = _whisper_step(True, monkeypatch)
    seen = []

    def counting(fn):
        def wrapped(*args):
            counter = FlopCounterMode(display=False)
            with counter:
                out = fn(*args)
            seen.append(counter.get_total_flops())
            return out
        return wrapped

    monkeypatch.setattr(qkv, "plain_project_split_fused",
                        counting(qkv.plain_project_split_fused))
    monkeypatch.setattr(qkv, "plain_merge_project_fused",
                        counting(qkv.plain_merge_project_fused))
    job.step_fn(job.state, batch, dp.step_generator(0, 0))
    # A projection and a merge per encoder layer; per decoder layer the
    # self-attention's two, and the cross-attention's q, k and v, merge.
    assert len(seen) == 2 * job.config.encoder_layers \
        + 5 * job.config.decoder_layers
    assert sum(seen) == flops.whisper_fused_projection_flops(
        job.config, 2, LABELS, FRAMES)


def test_card_counts_the_fused_projections_it_cannot_see(monkeypatch):
    """custom_call_flops on CUDA tensors adds the flash kernels and, with
    TETHYS_FUSED_QKV=1, the projections' forward: the card's total does not
    depend on the variable.  (Stand-ins with a shape and ``is_cuda`` take
    the card's tensors' place: nothing else of them is read.)"""
    cfg = configs.WhisperConfig.from_size("base")

    class Cuda:
        def __init__(self, *shape):
            self.shape, self.is_cuda = shape, True

    batch = (Cuda(16, 80, 3000), Cuda(16, 100))
    monkeypatch.delenv("TETHYS_FUSED_QKV", raising=False)
    plain = flops.custom_call_flops(cfg, batch)
    monkeypatch.setenv("TETHYS_FUSED_QKV", "1")
    fused = flops.custom_call_flops(cfg, batch)
    assert plain == flops.whisper_custom_call_flops(cfg, 16, 100, 3000)
    assert fused - plain == flops.whisper_fused_projection_flops(
        cfg, 16, 100, 3000) > 0


def _wav2vec2_hand_count(cfg, b, samples) -> float:
    """Products of one pretraining step.  Backward: twice the forward, but
    the first conv (the audio takes no gradient) and project_q (the
    quantized targets take none) once, and the quantizer's projection and
    its two products not at all (argmin passes no gradient and the
    codevectors are frozen)."""
    lengths = [samples]
    for stride in cfg.conv_stride:
        lengths.append(-(-lengths[-1] // stride))
    t = lengths[-1]
    h, i, p, k = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.proj_codevector_dim, cfg.num_negatives)
    dc, v = cfg.codevector_dim, cfg.num_codevectors_per_group
    c_in, convs = 1, []
    for c_out, kernel, n in zip(cfg.conv_dim, cfg.conv_kernel, lengths[1:]):
        convs.append(2 * b * n * c_out * c_in * kernel)
        c_in = c_out
    groups = cfg.num_conv_pos_embedding_groups
    pos = 2 * b * t * c_in * (c_in // groups) * cfg.num_conv_pos_embeddings
    projection = 2 * b * t * c_in * h
    encoder = cfg.num_hidden_layers * (
        4 * 2 * b * t * h * h + 2 * 2 * b * t * t * h + 2 * 2 * b * t * h * i)
    quantizer = 2 * b * t * h * dc + 2 * (2 * b * t * v * dc)
    project_hid = 2 * b * t * h * p
    project_q = 2 * b * t * dc * p
    negatives = 2 * b * t * k * p
    twice = sum(convs[1:]) + pos + projection + encoder + project_hid \
        + negatives
    return 3 * twice + 2 * (convs[0] + project_q) + quantizer


def test_wav2vec2_step_flops_match_a_hand_count():
    job = jobs.make_wav2vec2_job(
        "pretraining", "tiny", 2, 3e-5, "float32", seed=0, audio_length=AUDIO,
        config_overrides={**W2V_TINY, **W2V_NO_DROPOUT}, device="cpu")
    batch = job.prepare_batch(next(iter(job.dataset)))
    result = flops.step_flops(job.step_fn, job.state, batch,
                              dp.step_generator(0, 0))
    assert result.custom == 0.0
    assert result.counted == pytest.approx(
        _wav2vec2_hand_count(job.config, 2, AUDIO), rel=0.01)


@pytest.mark.parametrize("times", [
    [], [0.5], [3.0, 1.0], [9.0, 4.0, 2.0, 1.0, 1.5, 1.25],
    list(np.random.default_rng(0).random(20))])
@pytest.mark.parametrize("warmup", [0, 1, 3])
def test_steady_state_step_time_equals_jax(times, warmup):
    want = jax_loop.steady_state_step_time(times, warmup=warmup)
    assert loop.steady_state_step_time(times, warmup=warmup) == want
    assert loop.steady_state_step_time(times) == \
        jax_loop.steady_state_step_time(times)
