"""The port's Whisper training slice against the JAX package, on the CPU.

A tiny config (as tests/test_jobs_e2e.py's), the JAX model's own initialised
parameters converted to the port (convert.params_from_flax), numpy-seeded
inputs, f32, every dropout rate 0 where the two are compared (the JAX
package's dropout bits come from another generator).  Tolerances: loss
1e-5 relative and gradients rtol 1e-4 / atol 1e-6 (two f32 implementations
summing in different orders); the 20-step Keras-Adam trajectory 1e-4
relative per step.
"""

import dataclasses
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu import data as jax_data
from tethys_tpu.configs import WhisperConfig as JaxConfig
from tethys_tpu.losses import seq2seq_shifted_ce as jax_ce
from tethys_tpu.models.whisper import WhisperForConditionalGeneration as JaxWhisper
from tethys_tpu.parallel import dp as jax_dp
from tethys_tpu.parallel.mesh import make_data_mesh
from tethys_tpu_torch import data
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.jobs import _common, whisper_dist
from tethys_tpu_torch.losses import seq2seq_shifted_ce
from tethys_tpu_torch.models.whisper import (
    WhisperForConditionalGeneration,
    create_whisper_model,
)
from tethys_tpu_torch.parallel import dp, mesh
from tethys_tpu_torch.train import jobs
from tethys_tpu_torch.utils import kernel_lib

torch.set_num_threads(2)

TINY = dict(
    d_model=32, encoder_layers=1, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=64, vocab_size=128, max_target_positions=128,
    decoder_start_token_id=101,
)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
SEQ_LEN = 64
LOG_RE = re.compile(
    r"Step \d+, Loss: -?\d+\.\d{4}, Time: \d{2}:\d{2}:\d{2} "
    r"\(경과: \d+\.\d{2}초, 스텝 시간: \d+\.\d{2}초\)"
)


def _jax_init(config):
    model = JaxWhisper(config)
    init = jax.jit(lambda rng: model.init(
        {"params": rng, "dropout": rng},
        jnp.zeros((1, config.n_mels, 16), jnp.float32),
        decoder_input_ids=jnp.zeros((1, 4), jnp.int32),
        deterministic=True)["params"])
    return model, init(jax.random.PRNGKey(0))


def _port(params, **overrides):
    model = WhisperForConditionalGeneration(
        WhisperConfig(**{**TINY, **overrides}))
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def _batch(batch_size=2, seed=0):
    features, labels = next(iter(data.create_whisper_dummy_dataset(
        batch_size, n_mels=TINY["n_mels"], seq_len=SEQ_LEN, seed=seed)))
    return features, labels


@pytest.fixture(scope="module")
def tiny():
    config = JaxConfig(**TINY, **NO_DROPOUT)
    model, params = _jax_init(config)
    return model, params


def test_dummy_dataset_matches_jax():
    ours = iter(data.create_whisper_dummy_dataset(16, n_mels=8, seq_len=32))
    theirs = iter(jax_data.create_whisper_dummy_dataset(16, n_mels=8,
                                                        seq_len=32))
    for _ in range(5):  # three full batches, the padded one, a repeat
        for a, b in zip(next(ours), next(theirs)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_seq2seq_shifted_ce_matches_jax(masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 7, 11)).astype(np.float32) * 2
    labels = rng.integers(0, 11, size=(3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.7).astype(np.int32) if masked else None
    want = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                  None if mask is None else jnp.asarray(mask))
    got = seq2seq_shifted_ce(torch.from_numpy(logits).bfloat16().float(),
                             torch.from_numpy(labels),
                             None if mask is None else torch.from_numpy(mask))
    want_bf = jax_ce(jnp.asarray(logits).astype(jnp.bfloat16),
                     jnp.asarray(labels),
                     None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.item(), float(want_bf), rtol=1e-5)
    got32 = seq2seq_shifted_ce(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got32.item(), float(want), rtol=1e-5)


def test_keras_adam_matches_jax():
    """Five updates of two tensors, Keras eps placement, to 1e-6."""
    rng = np.random.default_rng(4)
    shapes = [(5, 3), (7,)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 1e-3 for s in shapes]
             for _ in range(5)]
    opt = jax_dp.whisper_optimizer(1e-2)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    topt = dp.whisper_optimizer(tp, 1e-2)
    for g in grads:
        updates, state = opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = [p + u for p, u in zip(jp, updates)]
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        topt.step()
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-6, atol=1e-7)


def test_loss_and_gradients_match_jax(tiny):
    model, params = tiny
    features, labels = _batch()

    def loss_fn(p):
        return model.apply({"params": p}, jnp.asarray(features),
                           labels=jnp.asarray(labels),
                           deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(1)})["loss"]

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    port = _port(params, **NO_DROPOUT).train()
    out = port(torch.from_numpy(features), labels=torch.from_numpy(labels),
               generator=torch.Generator().manual_seed(0))
    out["loss"].backward()
    np.testing.assert_allclose(out["loss"].item(), float(want_loss),
                               rtol=1e-5)
    want = params_from_flax(jax.device_get(want_grads))
    got = dict(port.named_parameters())
    assert set(want) == set(got)
    for name, g in want.items():
        assert got[name].grad is not None, name
        np.testing.assert_allclose(got[name].grad.numpy(), g.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_train_trajectory_matches_jax(tiny):
    """20 f32 steps of the port's step + Keras Adam against the JAX DP step
    with whisper_optimizer on a one-device mesh; every loss within 1e-4."""
    model, params = tiny
    lr = 1e-3
    mesh_1 = make_data_mesh(1)

    def jax_loss(p, batch, rng):
        f, l = batch
        return model.apply({"params": p}, f, labels=l, deterministic=False,
                           rngs={"dropout": rng})["loss"], {}

    opt = jax_dp.whisper_optimizer(lr)
    jstep = jax_dp.make_train_step(jax_loss, opt, mesh_1)
    jstate = jax_dp.replicate_state(
        jax_dp.TrainState(params, opt.init(params)), mesh_1)

    port = _port(params, **NO_DROPOUT).train()
    topt = dp.whisper_optimizer(port.parameters(), lr)
    tstep = dp.make_train_step(
        lambda m, b, g: (m(b[0], labels=b[1], generator=g)["loss"], {}), topt)
    tstate = dp.TrainState(port, topt)

    dataset = iter(data.create_whisper_dummy_dataset(
        4, n_mels=TINY["n_mels"], seq_len=SEQ_LEN))
    rng = jax.random.PRNGKey(0)
    jl, tl = [], []
    for i in range(20):
        f, l = next(dataset)
        jstate, loss = jstep(jstate, jax_dp.shard_batch((f, l), mesh_1),
                             jax.random.fold_in(rng, i))
        jl.append(float(loss))
        tstate, tloss = tstep(tstate, (torch.from_numpy(f),
                                       torch.from_numpy(l)),
                              dp.step_generator(0, i))
        assert not tloss.requires_grad
        tl.append(tloss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_dropout_live_only_in_train_mode():
    """Eval ignores dropout; train draws it from the generator alone:
    the same generator seed gives the same loss, another seed another."""
    model, _ = create_whisper_model(seed=1, device="cpu",
                                    param_dtype=torch.float32, **TINY)
    f, l = (torch.from_numpy(a) for a in _batch())

    def loss(train, seed):
        model.train(train)
        with torch.no_grad():
            return model(f, labels=l, generator=torch.Generator().manual_seed(
                seed))["loss"].item()

    assert loss(False, 0) == loss(False, 1)
    assert loss(True, 0) == loss(True, 0)
    assert loss(True, 0) != loss(True, 1)
    assert loss(True, 0) != loss(False, 0)
    model.train()
    with pytest.raises(ValueError, match="Generator"):
        model(f, labels=l)


def test_master_weights_stay_f32_under_bf16_compute():
    model, config = create_whisper_model(seed=2, device="cpu",
                                         param_dtype=torch.float32,
                                         compute_dtype="bfloat16", **TINY)
    model.train()
    f, l = (torch.from_numpy(a) for a in _batch())
    out = model(f, labels=l, generator=torch.Generator().manual_seed(0))
    assert out["logits"].dtype == torch.bfloat16
    assert out["loss"].dtype == torch.float32
    out["loss"].backward()
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        assert p.grad.dtype == torch.float32, name
        assert torch.isfinite(p.grad).all(), name
    serving, _ = create_whisper_model(seed=2, device="cpu",
                                      compute_dtype="bfloat16", **TINY)
    assert {p.dtype for p in serving.parameters()} == {torch.bfloat16}


def test_step_generator_is_a_function_of_seed_and_step():
    def draw(seed, step):
        return torch.randint(0, 2 ** 31 - 1, (4,),
                             generator=dp.step_generator(seed, step)).tolist()

    assert draw(42, 3) == draw(42, 3)
    assert len({tuple(draw(s, i)) for s in (0, 42) for i in range(4)}) == 8


def test_job_writes_log_lines_jct_and_checkpoints(tmp_path, capsys):
    ws = os.environ["TETHYS_WORKSPACE"]
    res = os.environ["TETHYS_RESULT"]
    with open(os.path.join(ws, "model.txt"), "w") as fh:
        fh.write("run1")
    os.makedirs(os.path.join(res, "run1"))
    kernel_lib.reset_launch_counts()
    result, model, config = jobs.train_whisper(
        model_type="small", batch_size_per_replica=2, num_batches=3,
        data_seq_len=SEQ_LEN, config_overrides=TINY, device="cpu")
    jobs.finalize_job(result, "whisper_small_model", 12.345)
    out = capsys.readouterr().out
    assert out.splitlines()[0] == "Epoch 1/1"
    assert len(LOG_RE.findall(out)) == 3
    assert [int(m) for m in re.findall(r"Step (\d+),", out)] == [0, 1, 2]
    assert "Training completed." in out
    assert result.total_steps == 3 and len(result.losses) == 3
    assert all(np.isfinite(result.losses))
    with open(os.path.join(res, "run1", "worker_0_jct.txt")) as fh:
        assert fh.read() == "12.35"
    ckpt = os.path.join(ws, "checkpoints", "whisper_small_epoch_1")
    state = torch.load(os.path.join(ckpt, "model.pt"))
    assert set(state) == set(model.state_dict())
    assert os.path.exists(os.path.join(ckpt, "optimizer.pt"))
    assert os.path.exists(os.path.join(ws, "model_cache",
                                       "whisper_small_model", "model.pt"))
    # CPU tensors launch no kernel.
    assert all(n == 0 for n in kernel_lib.launch_counts().values())


def test_whisper_job_builds_the_step_train_whisper_runs():
    """make_whisper_job (which the profiler drives too) gives the model in
    train mode, the batch as tensors on the job's device, and the step that
    train_whisper runs."""
    job = jobs.make_whisper_job(batch_size_per_replica=2,
                                data_seq_len=SEQ_LEN, config_overrides=TINY,
                                device="cpu", seed=0)
    features, labels = next(iter(job.dataset))
    batch = job.prepare_batch((features, labels))
    assert [t.dtype for t in batch] == [torch.float32, torch.int32]
    assert all(t.device.type == "cpu" for t in batch)
    assert np.array_equal(batch[0].numpy(), features)
    assert np.array_equal(batch[1].numpy(), labels)
    assert job.config.d_model == TINY["d_model"] and job.state.model.training
    state, loss = job.step_fn(job.state, batch, dp.step_generator(0, 0))
    assert np.isfinite(loss.item())


def test_step_profile_categories_and_card_only(monkeypatch):
    """The profiler files the flash kernels under their own names and the
    loss's log-softmax under the loss (not attention), and needs a card."""
    from tethys_tpu_torch.profiling import step_profile

    assert step_profile.categorise(
        "void (anonymous namespace)::flash_bwd_mma_kernel<64, true, true>()",
        ["FlashAttentionBackward"]) == "flash_bwd kernel"
    assert step_profile.categorise(
        "void (anonymous namespace)::flash_fwd_f32_kernel<64, false>()",
        []) == "flash_fwd kernel"
    assert step_profile.categorise(
        "cunn_SoftMaxBackward", ["aten::_log_softmax_backward_data",
                                 "LogSoftmaxBackward0"]) == "cross-entropy loss"
    assert step_profile.categorise(
        "softmax_warp_forward", ["aten::_softmax", "aten::softmax"]
    ) == "attention (bmm, softmax)"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        step_profile.main(["--model", "whisper", "--model_size", "tiny"])


@pytest.mark.parametrize("argv,where", [
    (["--tp", "2"], "queue 1 item 7"), (["--sp", "2"], "queue 1 item 7"),
    (["--pp", "2"], "queue 1 item 7"), (["--remat"], "queue 1 item 7"),
    (["--remat_layers"], "queue 1 item 7"),
    (["--grad_accum", "2"], "queue 1 item 7"),
    (["--resume"], "queue 1 item 4"),
    (["--master_dtype", "bfloat16"], "queue 1 item 7"),
    (["--microbatches", "4"], "queue 1 item 7"),
    (["--jax_profile", "/tmp/x"], "queue 1 item 6"),
])
def test_cli_refuses_unported_flags(capsys, argv, where):
    with pytest.raises(SystemExit) as exc:
        whisper_dist.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and where in err


def test_cli_defaults_match_the_jax_job():
    args = whisper_dist.build_parser().parse_args([])
    assert (args.num_batches, args.batch_size, args.dtype,
            args.model_size) == (40, 1, "float32", "small")
    assert (args.microbatches, args.jax_profile) == (2, None)
    # The defaults (and the supported values spelled out) are not refused.
    assert _common.parse(whisper_dist.build_parser(),
                         ["--microbatches", "2"]).microbatches == 2


def test_job_identity_and_multi_process_refusal(monkeypatch):
    monkeypatch.delenv("TF_CONFIG", raising=False)
    assert mesh.job_identity() == ("worker", 0)
    one = {"cluster": {"worker": ["localhost:2222"]},
           "task": {"type": "worker", "index": 0}}
    monkeypatch.setenv("TF_CONFIG", json.dumps(one))
    assert mesh.job_identity() == ("worker", 0)
    assert mesh.multi_process_spec() is None
    two = {"cluster": {"chief": ["a:1"], "worker": ["b:1", "c:1"]},
           "task": {"type": "worker", "index": 1}}
    monkeypatch.setenv("TF_CONFIG", json.dumps(two))
    assert mesh.job_identity() == ("worker", 1)
    assert mesh.multi_process_spec() == ("a:1", 3, 2)
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        jobs.train_whisper(config_overrides=TINY, device="cpu")


def test_hardened_step_waits_for_wav2vec2():
    """The hardened step is ported with Wav2Vec2 (this test once pinned its
    refusal): a NaN loss is scrubbed to 0 and takes a zero gradient, and
    gradients are clipped to a global norm of 1 before the optimizer."""
    model = torch.nn.Linear(3, 1, bias=False)
    with torch.no_grad():
        model.weight.fill_(1.0)
    seen = []

    class Record(torch.optim.Optimizer):
        def __init__(self, params):
            super().__init__(params, {})

        def step(self, closure=None):
            seen.append(model.weight.grad.clone())

    step = dp.make_train_step(
        lambda m, b, g: ((m(b) ** 2).sum() * b.sum() / b.sum(), {}),
        Record(model.parameters()), hardened=True)
    state = dp.TrainState(model, None)
    _, loss = step(state, torch.full((1, 3), 10.0), None)
    assert loss.item() == 900.0
    torch.testing.assert_close(seen[-1].norm(), torch.tensor(1.0))
    _, loss = step(state, torch.full((1, 3), float("nan")), None)
    assert loss.item() == 0.0 and torch.isnan(seen[-1]).all()
    _, loss = step(state, torch.zeros(1, 3), None)
    assert loss.item() == 0.0


def test_dataclass_configs_agree():
    """The training rates default as in the JAX config."""
    jax_fields = dataclasses.asdict(JaxConfig())
    ours = dataclasses.asdict(WhisperConfig())
    for key in ("dropout", "attention_dropout", "activation_dropout"):
        assert ours[key] == jax_fields[key]
