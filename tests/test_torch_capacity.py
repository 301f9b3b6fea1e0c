"""The single-card capacity modes in the port against the JAX package, on
the CPU: gradient accumulation (make_train_step(grad_accum=N)), bf16
master weights (the jobs' master_dtype), GroupNorm with bf16 parameters,
a bf16 checkpoint, and the bench and convergence twins with the capacity
flags.

Tiny configs and the JAX models' own parameters as in
tests/test_torch_train.py and tests/test_torch_wav2vec2_jobs.py, rates 0
where the two packages are compared.  Tolerances: f32 losses 1e-5 and
parameters after a step rtol 1e-4 / atol 1e-6 (two f32 implementations
summing in other orders); under bf16 master weights the forward runs in
f32 on the same bf16 values, so losses agree to 1e-5, and each parameter
after a step lies within one bf16 step (2^-7, 2^-8 rounding on either
side) of the larger of its magnitude and the update's (lr) from JAX's:
Keras Adam's moments and update are rounded to bf16 on both sides, JAX
once for the update, the port twice, and p + update once more.
"""

import ast
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu import losses as jax_losses
from tethys_tpu.configs import WhisperConfig as JaxConfig
from tethys_tpu.models.whisper import WhisperForConditionalGeneration as JaxWhisper
from tethys_tpu.parallel import dp as jax_dp
from tethys_tpu.parallel.mesh import make_data_mesh
from tethys_tpu_torch import data, losses
from tethys_tpu_torch.checkpoint import CheckpointManager
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.models.whisper import (
    WhisperForConditionalGeneration,
    create_whisper_model,
)
from tethys_tpu_torch.ops.norms import ReferenceGroupNorm
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.scripts import bench, convergence_check
from tethys_tpu_torch.train import jobs
from tethys_tpu_torch.utils import kernel_lib
from _torch_wav2vec2_common import AUDIO
from _torch_wav2vec2_common import TINY as W2V_TINY
from _torch_wav2vec2_common import negatives as w2v_negatives
from _torch_wav2vec2_common import pair as w2v_pair
from _torch_wav2vec2_common import t as _t

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(
    d_model=32, encoder_layers=1, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=64, vocab_size=128, max_target_positions=128,
    decoder_start_token_id=101,
)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
SEQ_LEN = 64
BF16_STEP = 2.0 ** -7


@pytest.fixture(scope="module")
def whisper_pair():
    """(JAX model, its f32 params) of the tiny config at rates 0."""
    model = JaxWhisper(JaxConfig(**TINY, **NO_DROPOUT))
    params = jax.jit(lambda rng: model.init(
        {"params": rng, "dropout": rng},
        jnp.zeros((1, TINY["n_mels"], 16), jnp.float32),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32),
        deterministic=True)["params"])(jax.random.PRNGKey(0))
    return model, jax.device_get(params)


def _whisper_batch(batch_size):
    features, labels = next(iter(data.create_whisper_dummy_dataset(
        batch_size, n_mels=TINY["n_mels"], seq_len=SEQ_LEN)))
    return features, labels


def _jax_whisper_step(model, params, batch, lr, grad_accum=1,
                      hardened=False):
    """(loss, params after one step) of JAX's make_train_step."""
    mesh_1 = make_data_mesh(1)

    def loss_fn(p, b, rng):
        return model.apply({"params": p}, b[0], labels=b[1],
                           deterministic=False,
                           rngs={"dropout": rng})["loss"], {}

    opt = jax_dp.whisper_optimizer(lr)
    step = jax_dp.make_train_step(loss_fn, opt, mesh_1, hardened=hardened,
                                  grad_accum=grad_accum)
    state = jax_dp.replicate_state(
        jax_dp.TrainState(params, opt.init(params)), mesh_1)
    state, loss = step(state, jax_dp.shard_batch(batch, mesh_1),
                       jax.random.PRNGKey(0))
    return float(loss), params_from_flax(jax.device_get(state.params))


def _port_whisper_step(params, batch, lr, dtype=torch.float32, **kw):
    """(loss, the model after one step of the port's make_train_step, its
    optimizer)."""
    model = WhisperForConditionalGeneration(WhisperConfig(**TINY,
                                                          **NO_DROPOUT))
    model.load_state_dict(params_from_flax(params))
    model = model.to(dtype).train()
    opt = dp.whisper_optimizer(model.parameters(), lr)
    step = dp.make_train_step(
        lambda m, b, g: (m(b[0], labels=b[1], generator=g)["loss"], {}), opt,
        **kw)
    _, loss = step(dp.TrainState(model, opt),
                   tuple(torch.from_numpy(x) for x in batch),
                   dp.step_generator(0, 0))
    return loss.item(), model, opt


@pytest.mark.parametrize("hardened", [False, True])
def test_grad_accum_matches_jax(whisper_pair, hardened):
    """grad_accum=2 against JAX's make_train_step(grad_accum=2), plain and
    hardened (the NaN scrub and 1/N on each microbatch, the global-norm
    clip once on the accumulated gradients), rates 0, one Keras Adam step
    on a batch of 4 (tests/test_dp.py's accumulation tests, against JAX
    itself here)."""
    model, params = whisper_pair
    batch = _whisper_batch(4)
    want_loss, want = _jax_whisper_step(model, params, batch, 1e-3,
                                        grad_accum=2, hardened=hardened)
    got_loss, port, _ = _port_whisper_step(params, batch, 1e-3,
                                           grad_accum=2, hardened=hardened)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    for name, p in port.named_parameters():
        if name.endswith("k_proj.bias"):   # zero but for rounding
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_grad_accum_rejects_an_indivisible_batch():
    job = jobs.make_whisper_job("tiny", 3, data_seq_len=SEQ_LEN,
                                config_overrides=TINY, device="cpu",
                                grad_accum=2)
    batch = job.prepare_batch(next(iter(job.dataset)))
    with pytest.raises(ValueError, match="not divisible"):
        job.step_fn(job.state, batch, dp.step_generator(0, 0))
    with pytest.raises(ValueError, match="at least 1"):
        dp.make_train_step(lambda m, b, g: None, job.state.optimizer,
                           grad_accum=0)


def test_accumulation_is_f32_under_bf16_parameters():
    """tests/test_dp.py's case: microbatch gradients 256, then 1 seven
    times, on a bf16 parameter.  The f32 sum is 263, its mean 32.875, a tie
    between 32.75 and 33 in bf16 that rounds to the even 33, as JAX's
    scan_grad_accum gives on the same inputs; a bf16 running sum would
    absorb every +1 into 256 and give 32.0."""
    from tethys_tpu.parallel.dp import scan_grad_accum

    def jax_vg(p, mb, rng):
        g = jnp.where(mb[0, 0] == 0, 256.0, 1.0).astype(jnp.bfloat16)
        return (jnp.float32(0.0), {}), {"w": g[None]}

    _, jax_grads, _ = scan_grad_accum(
        jax_vg, {"w": jnp.zeros((1,), jnp.bfloat16)},
        jnp.arange(8, dtype=jnp.float32)[:, None], jax.random.PRNGKey(0),
        grad_accum=8)
    model = torch.nn.Linear(1, 1, bias=False).to(torch.bfloat16)
    batch = (torch.arange(8, dtype=torch.float32)[:, None],)

    def value_and_grad(m, mb, generator):
        m.weight.grad = torch.full_like(m.weight,
                                        256.0 if mb[0][0, 0] == 0 else 1.0)
        return torch.zeros(()), {}

    loss, aux = dp.accumulate(model, batch, dp.step_generator(0, 0), 8,
                              value_and_grad)
    assert model.weight.grad.dtype == torch.bfloat16
    assert model.weight.grad.item() == float(jax_grads["w"][0]) == 33.0
    assert loss.item() == 0.0 and aux == {}


def test_wav2vec2_negatives_per_microbatch(monkeypatch):
    """Each microbatch draws its own negatives from its own generator (JAX
    splits each chunk's rng); grad_accum=1 draws from the step's generator
    what the step draws without accumulation."""
    drawn = []
    real = losses.sample_negative_indices

    def spy(generator, *args):
        out = real(generator, *args)
        drawn.append(out.clone())
        return out

    monkeypatch.setattr(losses, "sample_negative_indices", spy)

    def step_draws(**kw):
        drawn.clear()
        job = jobs.make_wav2vec2_job("pretraining", "tiny", 4,
                                     audio_length=AUDIO,
                                     config_overrides=W2V_TINY, device="cpu",
                                     **kw)
        batch = job.prepare_batch(next(iter(job.dataset)))
        _, loss = job.step_fn(job.state, batch, dp.step_generator(0, 0))
        return list(drawn), loss

    (one,), loss_default = step_draws()
    (again,), loss_one = step_draws(grad_accum=1)
    assert torch.equal(one, again) and torch.equal(loss_default, loss_one)
    frames = w2v.Wav2Vec2Config(**W2V_TINY).downsampled_length(AUDIO)
    assert torch.equal(one, real(dp.step_generator(0, 0), 4, frames,
                                 W2V_TINY["num_negatives"]))
    first, second = step_draws(grad_accum=2)[0]
    assert first.shape == second.shape == (2, W2V_TINY["num_negatives"])
    assert not torch.equal(first, second)
    for i, got in enumerate((first, second)):
        want = real(dp.microbatch_generator(dp.step_generator(0, 0), i), 2,
                    frames, W2V_TINY["num_negatives"])
        assert torch.equal(got, want)


def test_microbatch_generators_are_distinct_and_repeatable():
    step = dp.step_generator(3, 7)
    seeds = [dp.microbatch_generator(step, i).initial_seed()
             for i in range(4)]
    assert len(set(seeds + [step.initial_seed()])) == 5
    assert seeds == [dp.microbatch_generator(dp.step_generator(3, 7),
                                             i).initial_seed()
                     for i in range(4)]


def _bf16_bits(state):
    return {n: t.to(torch.bfloat16).view(torch.int16) for n, t in
            state.items()}


def test_master_cast_equals_jax_astype(whisper_pair):
    """The port's cast of f32 weights to bf16 master weights (init in f32,
    one cast: create_whisper_model's param_dtype) equals JAX's
    astype(bfloat16) bit for bit; the job's bf16 weights are its f32
    weights cast so."""
    _, params = whisper_pair
    want = params_from_flax(jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x).astype(jnp.bfloat16)), params))
    model = WhisperForConditionalGeneration(WhisperConfig(**TINY))
    model.load_state_dict(params_from_flax(params))
    got = {n: p for n, p in model.to(torch.bfloat16).state_dict().items()}
    want_bits = _bf16_bits(want)
    for name, p in got.items():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.view(torch.int16), want_bits[name]), name
    job = jobs.make_whisper_job("tiny", 2, config_overrides=TINY,
                                device="cpu", master_dtype="bfloat16")
    f32, _ = create_whisper_model("tiny", device="cpu", seed=42,
                                  param_dtype=torch.float32, **TINY)
    f32_bits = _bf16_bits(f32.state_dict())
    for name, p in job.state.model.state_dict().items():
        assert torch.equal(p.view(torch.int16), f32_bits[name]), name


def _within_a_bf16_step(got, want, name, lr):
    got, want = got.detach().float(), want.float()
    bound = BF16_STEP * (torch.maximum(got.abs(), want.abs()) + lr)
    assert bool(((got - want).abs() <= bound).all()), (
        name, (got - want).abs().max().item())


def test_whisper_bf16_master_step_matches_jax(whisper_pair):
    """One Keras Adam step on bf16 master weights (f32 compute, rates 0)
    against JAX's step on params.astype(bfloat16): the loss to 1e-5, every
    parameter within one bf16 step, the moments kept in bf16."""
    model, params = whisper_pair
    bf16 = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16), params)
    batch = _whisper_batch(2)
    lr = 1e-3
    want_loss, want = _jax_whisper_step(model, bf16, batch, lr)
    got_loss, port, opt = _port_whisper_step(params, batch, lr,
                                             dtype=torch.bfloat16)
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    moved = 0
    start = params_from_flax(params)
    for name, p in port.named_parameters():
        assert p.dtype == torch.bfloat16
        moved += int(not torch.equal(p, start[name].to(torch.bfloat16)))
        if name.endswith("k_proj.bias"):   # zero but for rounding
            continue
        _within_a_bf16_step(p, want[name], name, lr)
    # lr 1e-3 moves every tensor but the LayerNorm scales of 1.0, whose
    # steps of 1e-3 are below bf16's step there (2^-7).
    assert moved == len(start) - sum(n.endswith("layer_norm.weight")
                                     for n in start)
    for s in opt.state.values():
        assert s["m"].dtype == s["v"].dtype == torch.bfloat16


def test_wav2vec2_hardened_bf16_master_step_matches_jax():
    """One hardened step with wav2vec2_optimizer on bf16 master weights
    (f32 compute, rates 0, the same fixed negatives; GroupNorm's gamma
    and beta bf16) against JAX's hardened step on params.astype(bfloat16):
    the loss to 1e-5, every parameter within one bf16 step but the two
    whose gradient is zero up to rounding (tests/test_torch_wav2vec2_jobs's
    trajectory test leaves them out too); Adam's moments bf16."""
    jmodel, params, port, cfg = w2v_pair("pretraining")
    neg = w2v_negatives(cfg)
    scale, lr = 50.0, 1e-3
    bf16 = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(jnp.bfloat16), params)

    def jax_loss(p, batch, rng):
        out = jmodel.apply({"params": p}, batch[0], training=True,
                           deterministic=True)
        _, c = jax_losses.contrastive_loss(
            out["projected_states"], out["projected_quantized_features"],
            None, num_negatives=cfg.num_negatives,
            temperature=cfg.contrastive_logits_temperature,
            negative_indices=jnp.asarray(neg))
        loss = c + cfg.diversity_loss_weight * jax_losses.diversity_loss(
            out["codevector_perplexity"])
        return loss * scale, {}

    mesh_1 = make_data_mesh(1)
    opt = jax_dp.wav2vec2_optimizer(lr)
    jstep = jax_dp.make_train_step(jax_loss, opt, mesh_1, hardened=True)
    jstate = jax_dp.replicate_state(jax_dp.TrainState(bf16, opt.init(bf16)),
                                    mesh_1)
    audio = next(iter(data.create_wav2vec2_dummy_dataset(
        2, audio_length=AUDIO)))[0]
    jstate, want_loss = jstep(jstate, jax_dp.shard_batch((audio,), mesh_1),
                              jax.random.PRNGKey(0))
    want = params_from_flax(jax.device_get(jstate.params))

    port = port.to(torch.bfloat16)
    gn = port.wav2vec2.feature_extractor.norm_0
    assert gn.gamma.dtype == torch.bfloat16

    def port_loss(model, batch, generator):
        loss, aux = w2v.pretraining_loss(cfg, model(batch[0],
                                                    generator=generator),
                                         negative_indices=_t(neg))
        return loss * scale, aux

    topt = dp.wav2vec2_optimizer(port.parameters(), lr)
    step = dp.make_train_step(port_loss, topt, hardened=True)
    _, loss = step(dp.TrainState(port, topt), (_t(audio),),
                   dp.step_generator(0, 0))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert gn.gamma.grad.dtype == torch.bfloat16
    for name, p in port.named_parameters():
        assert p.dtype == torch.bfloat16
        if name.endswith(("k_proj.bias", "project_q.layer_norm.bias")):
            continue
        _within_a_bf16_step(p, want[name], name, lr)
    for s in topt.state.values():
        assert s["m"].dtype == s["v"].dtype == torch.bfloat16


def test_group_norm_with_bf16_gamma_and_beta():
    """Under bf16 master weights GroupNorm's gamma and beta are bf16: the
    module promotes them to f32 (the JAX _gn_core's f32), so the output
    and dx equal the f32 module's on the same values bit for bit, and
    dgamma and dbeta are the f32 ones rounded to bf16."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 40, 16), dtype=np.float32))
    dy = torch.from_numpy(rng.standard_normal((2, 40, 16), dtype=np.float32))
    gamma = torch.from_numpy(rng.standard_normal(16, dtype=np.float32))
    beta = torch.from_numpy(rng.standard_normal(16, dtype=np.float32))
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        gn = ReferenceGroupNorm(16, 4, dtype=torch.float32)
        with torch.no_grad():
            gn.gamma.copy_(gamma.bfloat16())
            gn.beta.copy_(beta.bfloat16())
        gn = gn.to(dtype)
        xs = x.clone().requires_grad_()
        y = gn(xs)
        y.backward(dy)
        runs[dtype] = (y, xs.grad, gn.gamma.grad, gn.beta.grad)
    y32, dx32, dg32, db32 = runs[torch.float32]
    y16, dx16, dg16, db16 = runs[torch.bfloat16]
    assert torch.equal(y16, y32) and torch.equal(dx16, dx32)
    assert dg16.dtype == db16.dtype == torch.bfloat16
    assert torch.equal(dg16, dg32.bfloat16())
    assert torch.equal(db16, db32.bfloat16())


def test_bf16_checkpoint_round_trip(tmp_path):
    """save and restore_like keep bf16 parameters and bf16 Adam moments
    bit for bit, with Adam's count."""
    def job():
        return jobs.make_whisper_job("tiny", 2, data_seq_len=SEQ_LEN,
                                     config_overrides=TINY, device="cpu",
                                     master_dtype="bfloat16")

    first = job()
    batch = first.prepare_batch(next(iter(first.dataset)))
    state, _ = first.step_fn(first.state, batch, dp.step_generator(0, 0))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save("whisper_tiny_step_1", state)
    fresh = job()
    restored = mgr.restore_like("whisper_tiny_step_1", fresh.state)
    want = dict(state.model.named_parameters())
    for name, p in restored.model.named_parameters():
        assert p.dtype == torch.bfloat16 and torch.equal(p, want[name]), name
    for p, ref_p in zip(restored.model.parameters(),
                        state.model.parameters()):
        got, ref = restored.optimizer.state[p], state.optimizer.state[ref_p]
        assert got["step"] == ref["step"] == 1
        for key in ("m", "v"):
            assert got[key].dtype == torch.bfloat16
            assert torch.equal(got[key], ref[key])


def _capture_job_kwargs(monkeypatch):
    seen = {}
    for name in ("make_whisper_job", "make_wav2vec2_job"):
        real = getattr(jobs, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            seen[_name] = kwargs
            return _real(*args, **kwargs)

        monkeypatch.setattr(jobs, name, spy)
    return seen


def test_bench_twin_runs_the_capacity_modes(monkeypatch, capsys):
    """The bench twin at the tiny size on the CPU with --master_dtype
    bfloat16 --remat --remat_layers --remat_policy none: each family's job
    gets the flags bench.py applies to it (remat_layers and its policy to
    Whisper alone), the rows hold finite values and, under --remat, the
    counter's FLOPs exceed the plain step's."""
    monkeypatch.setattr(bench, "WHISPER_FRAMES", 64)
    monkeypatch.setattr(bench, "WAV2VEC2_SAMPLES", 1600)
    seen = _capture_job_kwargs(monkeypatch)
    argv = ["--device", "cpu", "--model", "tiny", "--steps", "1", "--warmup",
            "1", "--batch_size", "2"]
    plain = bench.main(argv)
    rows = bench.main(argv + ["--master_dtype", "bfloat16", "--remat",
                              "--remat_layers", "--remat_policy", "none"])
    capsys.readouterr()
    assert seen["make_whisper_job"]["config_overrides"] == dict(
        remat_layers=True, remat_policy="none")
    for name in ("make_whisper_job", "make_wav2vec2_job"):
        assert (seen[name]["remat"], seen[name]["master_dtype"]) == (
            True, "bfloat16")
    for row, base in zip(rows, plain):
        assert math.isfinite(row["loss"]) and row["step_time_s"] > 0
        assert row["flops_counted"] > base["flops_counted"]
    kernel_lib.reset_launch_counts()


def _jax_record_keys():
    tree = ast.parse((ROOT / "scripts" / "convergence_check.py").read_text())
    return [[k.value for k in node.keys] for node in ast.walk(tree)
            if isinstance(node, ast.Dict) and node.keys
            and all(isinstance(k, ast.Constant) for k in node.keys)
            and "verdict" in [k.value for k in node.keys]][0]


def test_convergence_twin_on_the_cpu(monkeypatch, capsys):
    """The convergence twin at the tiny size: both master dtypes run the
    bench's step on the same batch and generators; one JSON record with
    scripts/convergence_check.py's keys, and a summary line per curve on
    stderr."""
    monkeypatch.setattr(bench, "WHISPER_FRAMES", 64)
    monkeypatch.setattr(bench, "FAMILY_DEFAULT_BATCH",
                        {"whisper": 2, "wav2vec2": 2})
    seen = _capture_job_kwargs(monkeypatch)
    record = convergence_check.main(["--steps", "4", "--model", "tiny",
                                     "--device", "cpu"])
    out, err = capsys.readouterr()
    assert json.loads(out.splitlines()[-1]) == record
    assert list(record) == _jax_record_keys()
    assert record["metric"] == "whisper_tiny_bf16_master_convergence"
    assert record["backend"] == "cpu" and record["steps"] == 4
    assert len(record["f32_curve_every5"]) == 1
    assert all(math.isfinite(v) for v in record["f32_first_last"]
               + record["bf16_first_last"])
    assert record["verdict"] in ("match", "gap", "diverged")
    assert [line.split(":")[0] for line in err.splitlines()
            if line.startswith(("float32", "bfloat16"))] == [
        "float32", "bfloat16"]
    assert seen["make_whisper_job"]["master_dtype"] == "bfloat16"
