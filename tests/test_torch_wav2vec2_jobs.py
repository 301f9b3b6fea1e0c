"""The port's Wav2Vec2 training job against the JAX package, on the CPU:
the hardened step's 10-step trajectory, the two gradient clips, the
resilient loop, the dataset, the default device and the four job CLIs.

Set-up and tolerances as in tests/test_torch_wav2vec2.py: a tiny config,
the JAX model's own parameters, f32, dropout off where the two are
compared, injected negatives; a trajectory at 1e-4 relative per step.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tethys_tpu import data as jax_data
from tethys_tpu import losses as jax_losses
from tethys_tpu.parallel import dp as jax_dp
from tethys_tpu.parallel.mesh import make_data_mesh
from tethys_tpu_torch import data
from tethys_tpu_torch.checkpoint import CheckpointManager
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.jobs import wav2vec2_dist, wav2vec2_single, whisper_single
from tethys_tpu_torch.jobs.stable import wav2vec2_dist as stable_dist
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.models.whisper import create_whisper_model
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.train import jobs
from tethys_tpu_torch.train.loop import run_training
from tethys_tpu_torch.utils import kernel_lib
from _torch_wav2vec2_common import (
    AUDIO,
    LOG_RE,
    NO_DROPOUT,
    TINY,
)
from _torch_wav2vec2_common import close as _close
from _torch_wav2vec2_common import negatives as _negatives
from _torch_wav2vec2_common import pair as _pair
from _torch_wav2vec2_common import t as _t

torch.set_num_threads(2)


def test_hardened_trajectory_matches_jax():
    """10 hardened steps with wav2vec2_optimizer against the JAX
    make_train_step(hardened=True) on a one-device CPU mesh, the same
    fixed negatives, at 1e-4 relative per step.  The loss is scaled by 50
    so that the gradients pass both clip norms (checked at step 0), and a
    NaN is added at step 4: both steps scrub it to 0, take a zero
    gradient and move the weights by Adam's momentum alone."""
    jmodel, params, port, cfg = _pair("pretraining")
    lr, scale, nan_step = 1e-3, 50.0, 4
    neg = _negatives(cfg)

    def jax_loss(p, batch, rng):
        audio, poison = batch
        out = jmodel.apply({"params": p}, audio, training=True,
                           deterministic=True)
        _, c = jax_losses.contrastive_loss(
            out["projected_states"], out["projected_quantized_features"],
            None, num_negatives=cfg.num_negatives,
            temperature=cfg.contrastive_logits_temperature,
            negative_indices=jnp.asarray(neg))
        loss = c + cfg.diversity_loss_weight * jax_losses.diversity_loss(
            out["codevector_perplexity"])
        return loss * scale + jnp.sum(poison), {}

    mesh_1 = make_data_mesh(1)
    opt = jax_dp.wav2vec2_optimizer(lr)
    jstep = jax_dp.make_train_step(jax_loss, opt, mesh_1, hardened=True)
    jstate = jax_dp.replicate_state(
        jax_dp.TrainState(params, opt.init(params)), mesh_1)

    norms_seen = []

    def port_loss(model, batch, generator):
        audio, poison = batch
        loss, aux = w2v.pretraining_loss(cfg, model(audio, generator=generator),
                                         negative_indices=_t(neg))
        return loss * scale + poison.sum(), aux

    topt = dp.wav2vec2_optimizer(port.parameters(), lr)
    inner = dp.make_train_step(port_loss, topt, hardened=True)

    def tstep(state, batch, gen):
        real_clip = dp.clip_by_global_norm

        def spy(grads, max_norm):
            norms_seen.append([g.norm().item() for g in grads])
            return real_clip(grads, max_norm)

        dp.clip_by_global_norm = spy
        try:
            return inner(state, batch, gen)
        finally:
            dp.clip_by_global_norm = real_clip

    tstate = dp.TrainState(port, topt)
    batches = iter(data.create_wav2vec2_dummy_dataset(2, audio_length=AUDIO))
    jl, tl = [], []
    for i in range(10):
        audio, _ = next(batches)
        poison = np.full((2,), np.nan if i == nan_step else 0.0, np.float32)
        jstate, loss = jstep(jstate, jax_dp.shard_batch((audio, poison),
                                                        mesh_1),
                             jax.random.PRNGKey(i))
        jl.append(float(loss))
        tstate, tloss = tstep(tstate, (_t(audio), _t(poison)),
                              dp.step_generator(0, i))
        tl.append(tloss.item())
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[nan_step] == 0.0
    step0 = norms_seen[0]
    assert sum(n * n for n in step0) ** 0.5 > 1.0 and max(step0) > 1.0
    assert not any(norms_seen[nan_step])
    # Parameters after 10 steps, but for the two whose gradient is zero up
    # to rounding (a key bias; project_q's LayerNorm bias): Adam turns that
    # noise into steps of +-lr whose sign differs between the two.
    want = params_from_flax(jax.device_get(jstate.params))
    for name, p in tstate.model.named_parameters():
        if name.endswith(("k_proj.bias", "project_q.layer_norm.bias")):
            continue
        _close(p, want[name], rtol=1e-4, atol=1e-5, msg=name)
    assert torch.equal(tstate.model.wav2vec2.quantizer.codevectors,
                       _t(params["wav2vec2"]["quantizer"]["codevectors"]))


def test_clip_helpers_match_optax():
    rng = np.random.default_rng(12)
    grads = [rng.standard_normal(s).astype(np.float32) * 3
             for s in ((4, 5), (7,), (1,))]
    grads[2] *= 0.0
    want, _ = jax_dp.per_variable_clipnorm(1.0).update(
        [jnp.asarray(g) for g in grads], None)
    got = [_t(g) for g in grads]
    dp.per_variable_clipnorm(got, 1.0)
    for a, b in zip(got, want):
        _close(a, b)
    want, _ = optax.clip_by_global_norm(1.0).update(
        [jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [_t(g) for g in grads]
    dp.clip_by_global_norm(got, 1.0)
    for a, b in zip(got, want):
        _close(a, b)
    small = [torch.full((3,), 0.1)]
    dp.clip_by_global_norm(small, 1.0)
    assert torch.equal(small[0], torch.full((3,), 0.1))


class _Loss:
    """A loss handle whose fetch fails, as a poisoned device result."""

    def item(self):
        raise RuntimeError("device fault")


def test_resilient_loop_logs_errors_and_saves_every_n_steps(tmp_path, capsys):
    """A step that raises at dispatch (step 2) and one whose fetch fails
    (step 4) print ``Error at step N: ...``; the loop goes on to the end,
    and the step cadence saves model_step_3 and model_step_6."""
    model = torch.nn.Linear(2, 2)
    state = dp.TrainState(model, torch.optim.SGD(model.parameters(), 0.1))
    calls = []

    def step_fn(state, batch, gen):
        calls.append(len(calls))
        if len(calls) == 3:
            raise ValueError("bad batch")
        if len(calls) == 5:
            return state, _Loss()
        return state, torch.tensor(float(len(calls)))

    ckpt = CheckpointManager(str(tmp_path))
    result = run_training(step_fn, [(1,), (2,)], state, 0, max_iterations=7,
                          checkpoint_manager=ckpt, checkpoint_every_steps=3,
                          resilient=True)
    out = capsys.readouterr().out
    assert "Error at step 2: bad batch" in out
    assert "Error at step 3: device fault" in out
    assert len(LOG_RE.findall(out)) == len(result.losses) == 5
    assert os.path.isdir(tmp_path / "model_step_3")
    assert os.path.isdir(tmp_path / "model_step_6")
    assert os.path.isdir(tmp_path / "model_epoch_1")
    with pytest.raises(ValueError, match="bad batch"):
        calls.clear()
        run_training(step_fn, [(1,)], state, 0, max_iterations=4)


def test_dataset_matches_jax():
    for kw in (dict(batch_size=16), dict(batch_size=7, audio_length=80)):
        ours = iter(data.create_wav2vec2_dummy_dataset(**kw))
        theirs = iter(jax_data.create_wav2vec2_dummy_dataset(**kw))
        for _ in range(9):       # past the dropped remainder and a repeat
            for a, b in zip(next(ours), next(theirs)):
                np.testing.assert_array_equal(a, b)


def test_entry_points_default_to_the_card():
    """create_whisper_model and create_full_model build on the card unless
    the caller passes a device; without one they raise through
    require_cuda instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_whisper_model("tiny")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        w2v.create_full_model("pretraining", "tiny")
    model, _ = w2v.create_full_model("pretraining", "tiny", device="cpu",
                                     **TINY)
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert not model.training


def _workspace(name):
    ws, res = os.environ["TETHYS_WORKSPACE"], os.environ["TETHYS_RESULT"]
    with open(os.path.join(ws, "model.txt"), "w") as fh:
        fh.write(name)
    os.makedirs(os.path.join(res, name))
    return ws, res


@pytest.fixture
def tiny_jobs(monkeypatch):
    """The job CLIs at the tiny size: every config gets TINY with a conv
    stack that divides the clips by 320, as base's does (2 s -> 25 frames,
    5 s -> 63), and the dropout rates of the JAX config (live: the Philox
    dropout on the CPU)."""
    real = w2v.create_full_model
    tiny = dict(TINY, conv_dim=(16,) * 5, conv_stride=(5, 4, 4, 4, 4),
                conv_kernel=(10, 3, 3, 3, 2))

    def tiny_model(model_type, model_size, **kw):
        return real(model_type, "tiny", **{**kw, **tiny})

    monkeypatch.setattr(w2v, "create_full_model", tiny_model)


@pytest.mark.parametrize("cli,argv,lines,jct,saves", [
    (wav2vec2_dist, ["--model_size", "tiny"],
     ["selected model size: tiny", "batch size per replica: 2, global "
      "batch size: 2", "num_batches: 3", "Wav2Vec2 distributed training "
      "starting..."], "worker_0_jct.txt",
     ["checkpoints/model_epoch_1", "model_cache/wav2vec2_tiny_model"]),
    (wav2vec2_single, ["--model_size", "tiny", "--model_type",
                       "classification", "--num_epochs", "2"],
     ["Wav2Vec2 single-device training starting...",
      "selected model size: tiny", "selected model type: classification"],
     None, ["checkpoints/model_epoch_2",
            "./model_cache/wav2vec2_tiny_classification_model"]),
    (whisper_single, [],
     ["batch size: 2", "num_batches: 3",
      "Wav2Vec2 single-device training starting..."], "single_jct.txt",
     ["checkpoints/model_epoch_1", "model_cache/wav2vec2_model"]),
    (stable_dist, [],
     ["batch size per replica: 2, global batch size: 2", "num_batches: 3",
      "Wav2Vec2-base distributed training starting..."], "worker_0_jct.txt",
     ["checkpoints/model_epoch_1", "model_cache/wav2vec2_base_model"]),
])
def test_job_clis_on_the_cpu(tiny_jobs, tmp_path, monkeypatch, capsys, cli,
                             argv, lines, jct, saves):
    """Each Wav2Vec2 CLI at the tiny size with --device cpu: its stdout
    lines, the step lines, its JCT file (printed only, by
    wav2vec2_single), its checkpoints and final save; no kernel launched."""
    ws, res = _workspace("run1")
    monkeypatch.chdir(tmp_path)
    kernel_lib.reset_launch_counts()
    cli.main(["--batch_size", "2", "--num_batches", "3", "--device", "cpu",
              *argv])
    out = capsys.readouterr().out
    for line in lines:
        assert line in out.splitlines(), line
    epochs = 2 if "--num_epochs" in argv else 1
    assert len(LOG_RE.findall(out)) == 3 * epochs
    assert "Error at step" not in out
    losses_seen = [float(v) for v in re.findall(r"Loss: (-?\d+\.\d+)", out)]
    assert all(np.isfinite(losses_seen))
    assert "Training completed." in out
    if jct is None:
        assert re.search(r"^JCT: \d", out, re.M)
        assert not os.listdir(os.path.join(res, "run1"))
    else:
        with open(os.path.join(res, "run1", jct)) as fh:
            assert re.fullmatch(r"\d+\.\d\d", fh.read())
    for path in saves:
        root = tmp_path if path.startswith("./") else ws
        assert os.path.exists(os.path.join(root, path, "model.pt")), path
    assert all(n == 0 for n in kernel_lib.launch_counts().values())


@pytest.mark.parametrize("cli,argv,where", [
    (wav2vec2_dist, ["--tp", "2"], "queue 1 item 7"),
    (wav2vec2_dist, ["--sp", "2"], "queue 1 item 7"),
    (wav2vec2_dist, ["--remat"], "queue 1 item 7"),
    (wav2vec2_dist, ["--grad_accum", "2"], "queue 1 item 7"),
    (wav2vec2_dist, ["--resume"], "queue 1 item 4"),
    (wav2vec2_single, ["--resume"], "queue 1 item 4"),
    (whisper_single, ["--resume"], "queue 1 item 4"),
    (wav2vec2_dist, ["--jax_profile", "/tmp/x"], "queue 1 item 6"),
    (wav2vec2_single, ["--jax_profile", "/tmp/x"], "queue 1 item 6"),
    (whisper_single, ["--jax_profile", "/tmp/x"], "queue 1 item 6"),
    (stable_dist, ["--jax_profile", "/tmp/x"], "queue 1 item 6"),
])
def test_clis_refuse_unported_flags(capsys, cli, argv, where):
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP.md" in err and where in err


def test_cli_defaults_match_the_jax_jobs():
    assert (vars(wav2vec2_dist.build_parser().parse_args([]))
            | {"device": None}) == dict(
        num_batches=5, batch_size=1, dtype="float32", device=None,
        resume=False, tp=1, sp=1, remat=False, grad_accum=1,
        jax_profile=None, model_size="small")
    single = wav2vec2_single.build_parser().parse_args([])
    assert (single.model_type, single.learning_rate, single.num_epochs) == (
        "pretraining", 3e-5, 1)
    ws = whisper_single.build_parser().parse_args([])
    assert (ws.num_batches, ws.batch_size) == (40, 4)
    assert (whisper_single.MODEL_SIZE, whisper_single.AUDIO_LENGTH) == (
        "base", 80000)
    assert stable_dist.MODEL_SIZE == "base"


def test_train_wav2vec2_uses_the_hardened_chain(monkeypatch):
    """train_wav2vec2 builds the hardened step with the clipnorm Adam at
    lr 3e-5, draws the same negatives for a seed, and keeps the codebook
    frozen."""
    built = {}
    real = dp.make_train_step

    def spy(loss_fn, optimizer, hardened=False):
        built.update(hardened=hardened, optimizer=optimizer)
        return real(loss_fn, optimizer, hardened=hardened)

    monkeypatch.setattr(dp, "make_train_step", spy)
    result, model, config = jobs.train_wav2vec2(
        model_size="tiny", batch_size_per_replica=2, num_batches=2,
        audio_length=AUDIO, checkpointing=False,
        config_overrides={**TINY, **NO_DROPOUT}, device="cpu")
    assert built["hardened"]
    group = built["optimizer"].param_groups[0]
    assert (group["lr"], group["eps"], group["clipnorm"]) == (3e-5, 1e-8, 1.0)
    cv = model.wav2vec2.quantizer.codevectors
    assert not cv.requires_grad and cv.grad is None
    again, _, _ = jobs.train_wav2vec2(
        model_size="tiny", batch_size_per_replica=2, num_batches=2,
        audio_length=AUDIO, checkpointing=False,
        config_overrides={**TINY, **NO_DROPOUT}, device="cpu")
    assert again.losses == result.losses and len(result.losses) == 2
