"""Activation checkpointing in the port (ops/remat.py, WhisperConfig's
remat_layers, make_train_step(remat=True)), on the CPU.

A tiny Whisper (2 + 2 layers) with the config's dropout 0.1, numpy-seeded
inputs.  Per-layer and whole-loss remat recompute the same ops on the same
inputs with the replayed dropout seeds, so the loss, every gradient and the
generator's state after the step are compared bit for bit; against the JAX
package's remat_layers gradients (rates 0) rtol 1e-4 / atol 1e-6, as
tests/test_torch_train.py.  FLOP counts are exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu.configs import WhisperConfig as JaxConfig
from tethys_tpu.models.whisper import WhisperForConditionalGeneration as JaxWhisper
from tethys_tpu_torch import data
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.models.whisper import (
    WhisperForConditionalGeneration,
    create_whisper_model,
    greedy_generate,
)
from tethys_tpu_torch.ops import attention, flash_attention, remat
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.profiling import flops
from tethys_tpu_torch.train import jobs

torch.set_num_threads(2)

TINY = dict(
    d_model=32, encoder_layers=2, encoder_attention_heads=2,
    decoder_layers=2, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=64, vocab_size=128, max_target_positions=128,
    decoder_start_token_id=101,
)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
SEQ_LEN = 64          # mel frames: 32 encoder positions
LABELS = 20
POLICIES = ["save_flash", "none"]


def _inputs(batch=2, seed=0):
    rng = np.random.default_rng(seed)
    features = rng.standard_normal((batch, TINY["n_mels"], SEQ_LEN),
                                   dtype=np.float32)
    labels = rng.integers(3, 100, size=(batch, LABELS)).astype(np.int64)
    return torch.from_numpy(features), torch.from_numpy(labels)


def _loss_and_grads(seed=5, **overrides):
    """(loss, {name: grad}, generator state after the step) of one
    forward and backward of the seed-0 tiny model in train mode."""
    model, _ = create_whisper_model(device="cpu", seed=0,
                                    param_dtype=torch.float32,
                                    **{**TINY, **overrides})
    model.train()
    generator = torch.Generator().manual_seed(seed)
    features, labels = _inputs()
    loss = model(features, labels=labels, generator=generator)["loss"]
    loss.backward()
    return (loss.detach(), {n: p.grad for n, p in model.named_parameters()},
            generator.get_state())


def _assert_bitwise(got, want):
    assert torch.equal(got[0], want[0]), (got[0], want[0])
    assert set(got[1]) == set(want[1])
    for name, g in want[1].items():
        assert torch.equal(got[1][name], g), name
    assert torch.equal(got[2], want[2]), "generator state after the step"


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_layers_is_bitwise_with_dropout(policy):
    """Dropout 0.1 at every site: remat_layers on and off give the same
    loss and gradients bit for bit, and leave the generator where the
    plain forward leaves it (the recompute replays the seeds from a
    clone)."""
    assert WhisperConfig(**TINY).dropout == 0.1
    plain = _loss_and_grads()
    _assert_bitwise(_loss_and_grads(remat_layers=True, remat_policy=policy),
                    plain)
    # Another generator seed draws other masks: the check sees dropout.
    assert not torch.equal(_loss_and_grads(seed=6)[0], plain[0])


def test_a_recompute_without_the_replay_draws_other_seeds(monkeypatch):
    """The trap the replay closes: torch's checkpoint restores only the
    default generators, so a recompute that draws from the caller's
    generator takes fresh seeds, other masks and another gradient, and
    moves the generator on."""
    plain = _loss_and_grads()

    def no_replay(fn, *args, generator, policy):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, generator, use_reentrant=False)

    monkeypatch.setattr(remat, "checkpoint", no_replay)
    got = _loss_and_grads(remat_layers=True)
    assert torch.equal(got[0], plain[0])     # the forward is the same
    assert not all(torch.equal(got[1][n], g) for n, g in plain[1].items())
    assert not torch.equal(got[2], plain[2])


@pytest.fixture(scope="module")
def jax_tiny():
    config = JaxConfig(**TINY, **NO_DROPOUT, remat_layers=True)
    model = JaxWhisper(config)
    features, labels = _inputs()
    params = jax.jit(lambda rng: model.init(
        {"params": rng, "dropout": rng},
        jnp.zeros((1, TINY["n_mels"], 16), jnp.float32),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32),
        deterministic=True)["params"])(jax.random.PRNGKey(0))
    return model, params, features.numpy(), labels.numpy().astype(np.int32)


def test_remat_layers_gradients_match_jax(jax_tiny):
    """Rates 0: the port's remat_layers gradients against jax.grad of the
    JAX model with remat_layers (tests/test_whisper_model.py's
    test_remat_layers_matches_plain on the JAX side)."""
    model, params, features, labels = jax_tiny

    def loss_fn(p):
        return model.apply({"params": p}, jnp.asarray(features),
                           labels=jnp.asarray(labels), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = WhisperForConditionalGeneration(
        WhisperConfig(**TINY, **NO_DROPOUT, remat_layers=True))
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    port.train()
    out = port(torch.from_numpy(features),
               labels=torch.from_numpy(labels).long(),
               generator=torch.Generator().manual_seed(0))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(want_loss),
                               rtol=1e-5)
    want = params_from_flax(jax.device_get(want_grads))
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def _force_flash(monkeypatch):
    """Every attention site with a query of >= 16 rows takes the flash op
    (its plain version on CPU tensors), as tests/test_flash_partition.py
    forces the JAX gate with _FLASH_FORCE; returns the list the plain
    forward appends to on each call."""
    monkeypatch.setattr(
        attention, "flash_active",
        lambda use_flash, tq, tk, is_cuda: (use_flash
                                            and tq >= attention.FLASH_MIN_TQ))
    calls = []
    real = flash_attention.plain_flash_fwd

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(flash_attention, "plain_flash_fwd", counting)
    return calls


@pytest.mark.parametrize("overrides,forwards", [
    ({}, 1),
    ({"remat_layers": True, "remat_policy": "save_flash"}, 1),
    ({"remat_layers": True, "remat_policy": "none"}, 2)])
def test_flash_forward_runs_once_a_site_under_save_flash(monkeypatch,
                                                         overrides, forwards):
    """With the flash op on every bias-free site (2 encoder self, 2 cross;
    the causal decoder self-attention takes a bias and the plain path),
    one training step runs the flash forward once a site under
    save_flash, as without remat, and twice under none; the loss and the
    gradients stay those of the model without remat, bit for bit."""
    calls = _force_flash(monkeypatch)
    plain = _loss_and_grads()
    sites = TINY["encoder_layers"] + TINY["decoder_layers"]
    assert len(calls) == sites
    calls.clear()
    got = _loss_and_grads(**overrides)
    assert len(calls) == forwards * sites
    _assert_bitwise(got, plain)


def test_unknown_policy_raises_when_the_model_is_built():
    with pytest.raises(ValueError, match="unknown remat_policy"):
        create_whisper_model(device="cpu", remat_layers=True,
                             remat_policy="dots_saveable", **TINY)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        remat.checkpoint(lambda x, g: x, torch.ones(1), generator=None,
                         policy="everything")


def test_greedy_decode_unchanged_with_remat_layers():
    """Serving never checkpoints: the same weights decode the same tokens
    with remat_layers on."""
    features, _ = _inputs()
    plain, _ = create_whisper_model(device="cpu", seed=0, **TINY)
    rematted, _ = create_whisper_model(device="cpu", seed=0,
                                       remat_layers=True, **TINY)
    want = greedy_generate(plain, features, max_length=8)
    got = greedy_generate(rematted, features, max_length=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _job(family, **kw):
    if family == "whisper":
        job = jobs.make_whisper_job("tiny", 2, data_seq_len=SEQ_LEN,
                                    config_overrides=TINY, device="cpu", **kw)
    else:
        from _torch_wav2vec2_common import AUDIO
        from _torch_wav2vec2_common import TINY as W2V_TINY

        job = jobs.make_wav2vec2_job("pretraining", "tiny", 2,
                                     audio_length=AUDIO,
                                     config_overrides=W2V_TINY, device="cpu",
                                     **kw)
    return job, job.prepare_batch(next(iter(job.dataset)))


@pytest.mark.parametrize("family", ["whisper", "wav2vec2"])
def test_whole_loss_remat_is_bitwise(family):
    """make_train_step(remat=True), dropout on (and Wav2Vec2's negatives
    drawn from the same generator): the loss, the gradients and the
    generator's state after the step equal the plain step's."""
    runs = []
    for remat_on in (False, True):
        job, batch = _job(family, remat=remat_on)
        generator = dp.step_generator(0, 0)
        grads = {}
        real_step = job.state.optimizer.step

        def spy():
            grads.update({n: p.grad.clone() for n, p in
                          job.state.model.named_parameters()
                          if p.grad is not None})
            real_step()

        job.state.optimizer.step = spy
        _, loss = job.step_fn(job.state, batch, generator)
        runs.append((loss, grads, generator.get_state()))
        assert job.step_fn.remat is remat_on
    _assert_bitwise(runs[1], runs[0])


def test_whole_loss_remat_flops_against_the_analytic_figure():
    """Under the whole-loss remat (dots saved) the counter, on through the
    backward, sees the products that are not 2-D dots run again: the
    attention's two bmm a site and the two stem convolutions, exactly."""
    counted = {}
    for remat_on in (False, True):
        job, batch = _job("whisper", remat=remat_on)
        result = flops.step_flops(job.step_fn, job.state, batch,
                                  dp.step_generator(0, 0))
        assert result.custom == 0.0
        counted[remat_on] = result.counted
    b, d, h, t_enc = 2, TINY["d_model"], TINY["encoder_attention_heads"], \
        SEQ_LEN // 2
    head = d // h

    def attn(tq, tk):             # QK^T and PV
        return 2 * 2.0 * b * h * tq * tk * head

    convs = (2.0 * b * SEQ_LEN * d * TINY["n_mels"] * 3
             + 2.0 * b * t_enc * d * d * 3)
    label_len = data_labels()
    want = (TINY["encoder_layers"] * attn(t_enc, t_enc)
            + TINY["decoder_layers"] * (attn(label_len, label_len)
                                        + attn(label_len, t_enc))
            + convs)
    assert counted[True] - counted[False] == want


def test_remat_layers_flops_count_the_recompute():
    """Under remat_layers the counter sees each layer's products run again
    in the backward: every product of the layers' forward but fc2, whose
    output no backward needs (the recompute stops once the saved tensors
    it needs are back)."""
    counted = {}
    for overrides in ({}, {"remat_layers": True}):
        job = jobs.make_whisper_job(
            "tiny", 2, data_seq_len=SEQ_LEN,
            config_overrides={**TINY, **overrides}, device="cpu")
        batch = job.prepare_batch(next(iter(job.dataset)))
        counted[bool(overrides)] = flops.step_flops(
            job.step_fn, job.state, batch, dp.step_generator(0, 0)).counted
    b, d, ff = 2, TINY["d_model"], TINY["d_ff"]
    h, t, lab = TINY["encoder_attention_heads"], SEQ_LEN // 2, data_labels()
    head = d // h

    def mm(rows, k, n):
        return 2.0 * b * rows * k * n

    def attn(tq, tk):
        return 2 * 2.0 * b * h * tq * tk * head

    encoder = 4 * mm(t, d, d) + mm(t, d, ff) + attn(t, t)
    decoder = (4 * mm(lab, d, d) + 2 * mm(lab, d, d) + 2 * mm(t, d, d)
               + mm(lab, d, ff) + attn(lab, lab) + attn(lab, t))
    want = (TINY["encoder_layers"] * encoder
            + TINY["decoder_layers"] * decoder)
    assert counted[True] - counted[False] == want


def data_labels() -> int:
    """The synthetic dataset's label length."""
    return next(iter(data.create_whisper_dummy_dataset(
        1, n_mels=TINY["n_mels"], seq_len=SEQ_LEN)))[1].shape[1]


def test_flash_recomputes_counted_per_policy():
    """The analytic flash FLOPs add one forward a site under the
    whole-loss remat and under remat_layers with none, none under
    save_flash (the JAX count leaves the second case out)."""
    base = WhisperConfig.from_size("base")
    kw = dict(batch=16, label_len=100, is_cuda=True)
    plain = flops.whisper_custom_call_flops(base, **kw)
    for config, whole, extra in (
            (dataclasses.replace(base, remat_layers=True), False, 0),
            (dataclasses.replace(base, remat_layers=True,
                                 remat_policy="none"), False, 1),
            (base, True, 1)):
        got = flops.whisper_custom_call_flops(config, whole_loss_remat=whole,
                                              **kw)
        sites = base.encoder_layers * 1500 * 1500 + base.decoder_layers * \
            100 * 1500
        head = base.d_model // base.encoder_attention_heads
        assert got - plain == extra * 2 * 2.0 * 16 * 8 * head * sites
    # Eval never checkpoints a layer.
    none = dataclasses.replace(base, remat_layers=True, remat_policy="none")
    assert (flops.whisper_custom_call_flops(none, training=False, **kw)
            == flops.whisper_custom_call_flops(base, training=False, **kw))


def test_decode_path_never_checkpoints(monkeypatch):
    """The layers call remat.checkpoint only in training with gradients
    on: not in eval, not under no_grad."""
    calls = []
    real = remat.checkpoint
    monkeypatch.setattr(remat, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model, _ = create_whisper_model(device="cpu", seed=0, remat_layers=True,
                                    param_dtype=torch.float32, **TINY)
    features, labels = _inputs()
    model(features, labels=labels)
    model.train()
    with torch.no_grad():
        model(features, labels=labels,
              generator=torch.Generator().manual_seed(0))
    assert not calls
    model(features, labels=labels, generator=torch.Generator().manual_seed(0))
    layers = TINY["encoder_layers"] + TINY["decoder_layers"]
    assert len(calls) == layers
