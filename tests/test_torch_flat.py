"""The port's flat-buffer optimizer (tethys_tpu_torch/parallel/flat.py,
``--flat_opt``) against the JAX package's (tethys_tpu/parallel/flat.py,
tests/test_flat.py), on the CPU.

Tiny configs as tests/test_torch_train.py (Whisper) and
tests/_torch_wav2vec2_common.py (Wav2Vec2), the JAX model's own weights
converted to the port, f32, dropout 0 where the two packages are
compared, Wav2Vec2's negatives injected.  Tolerances: trajectories 1e-4
relative per step (tests/test_torch_train.py's); the flat port step
against the per-tensor port step, which differ only in the order f32
sums the clips' norms, 1e-5 per step; norms 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu import losses as jax_losses
from tethys_tpu.configs import WhisperConfig as JaxWhisperConfig
from tethys_tpu.parallel import dp as jax_dp
from tethys_tpu.parallel import flat as jax_flat
from tethys_tpu.parallel.mesh import make_data_mesh
from tethys_tpu_torch import data
from tethys_tpu_torch.configs import Wav2Vec2Config, WhisperConfig
from tethys_tpu_torch.convert import params_from_flax, torch_name
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.models.whisper import WhisperForConditionalGeneration
from tethys_tpu_torch.parallel import dp, flat, mesh
from tethys_tpu_torch.train import jobs
from _torch_parallel_ranks import torchrun_world, wait
from _torch_wav2vec2_common import AUDIO, NO_DROPOUT, TINY
from _torch_wav2vec2_common import close as _close
from _torch_wav2vec2_common import negatives as _negatives
from _torch_wav2vec2_common import pair as _pair
from _torch_wav2vec2_common import t as _t
from test_torch_train import NO_DROPOUT as WHISPER_NO_DROPOUT
from test_torch_train import SEQ_LEN, _jax_init
from test_torch_train import TINY as WHISPER_TINY

torch.set_num_threads(2)

# The two Wav2Vec2 parameters whose gradient is zero but for rounding:
# Adam turns that noise into steps of +-lr whose sign is the rounding's
# (tests/test_torch_wav2vec2_jobs.py).
ROUNDING_ONLY = ("k_proj.bias", "project_q.layer_norm.bias")
STEPS = 10


def _torch_names(tree) -> list:
    """The state-dict names of a flax tree's leaves, in the tree's order
    (JAX FlatSpec's)."""
    return [torch_name(tuple(k.key for k in path)) for path, _ in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def _whisper(dtype=torch.float32):
    """(JAX model, JAX params, port model in train mode)."""
    jmodel, params = _jax_init(JaxWhisperConfig(**WHISPER_TINY,
                                                 **WHISPER_NO_DROPOUT))
    port = WhisperForConditionalGeneration(
        WhisperConfig(**WHISPER_TINY, **WHISPER_NO_DROPOUT))
    port.load_state_dict(params_from_flax(jax.device_get(params)))
    return jmodel, jax.device_get(params), port.to(dtype).train()


def _whisper_losses(jmodel):
    def jax_loss(p, batch, rng):
        f, l = batch
        return jmodel.apply({"params": p}, f, labels=l, deterministic=False,
                            rngs={"dropout": rng})["loss"], {}

    def port_loss(m, batch, generator):
        return m(batch[0], labels=batch[1], generator=generator)["loss"], {}

    batches = iter(data.create_whisper_dummy_dataset(
        4, n_mels=WHISPER_TINY["n_mels"], seq_len=SEQ_LEN))
    return jax_loss, port_loss, [next(batches) for _ in range(STEPS)]


def _w2v_losses(jmodel, cfg, scale=50.0):
    """The hardened Wav2Vec2 losses, scaled so that both clips bite (as
    tests/test_torch_wav2vec2_jobs.py), on fixed negatives."""
    neg = _negatives(cfg)

    def jax_loss(p, batch, rng):
        out = jmodel.apply({"params": p}, batch[0], training=True,
                           deterministic=True)
        _, c = jax_losses.contrastive_loss(
            out["projected_states"], out["projected_quantized_features"],
            None, num_negatives=cfg.num_negatives,
            temperature=cfg.contrastive_logits_temperature,
            negative_indices=jnp.asarray(neg))
        return scale * (c + cfg.diversity_loss_weight
                        * jax_losses.diversity_loss(
                            out["codevector_perplexity"])), {}

    def port_loss(m, batch, generator):
        loss, aux = w2v.pretraining_loss(cfg, m(batch[0],
                                                generator=generator),
                                         negative_indices=_t(neg))
        return loss * scale, aux

    clips = iter(data.create_wav2vec2_dummy_dataset(2, audio_length=AUDIO))
    return jax_loss, port_loss, [(next(clips)[0],) for _ in range(STEPS)]


def _port_steps(model, loss_fn, batches, family, lr, flat_on,
                steps=STEPS, **step_kw):
    """The port's step, on the flat buffer or per tensor: the losses, the
    parameters after the steps, the step and its spec."""
    spec = None
    if flat_on:
        spec = flat.FlatSpec(model)
        spec.bind(model)
        opt = (flat.wav2vec2_optimizer if family == "wav2vec2"
               else flat.whisper_optimizer)(spec, lr)
    else:
        opt = (dp.wav2vec2_optimizer if family == "wav2vec2"
               else dp.whisper_optimizer)(model.parameters(), lr)
    step = dp.make_train_step(loss_fn, opt, hardened=family == "wav2vec2",
                              flat_spec=spec, **step_kw)
    state, losses, auxes = dp.TrainState(model, opt), [], []
    for i, batch in enumerate(batches[:steps]):
        out = step(state, tuple(torch.from_numpy(np.asarray(a))
                                for a in batch), dp.step_generator(0, i))
        losses.append(out[1].item())
        auxes.append(out[2] if len(out) > 2 else None)
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return losses, params, step, spec, auxes


def _jax_flat_steps(params, loss_fn, batches, family, lr, steps=STEPS):
    """JAX's flat step on a one-device mesh: the losses and the final
    parameters as a state dict."""
    mesh_1 = make_data_mesh(1)
    spec = jax_flat.FlatSpec(params)
    opt = jax_flat.flat_optimizer(spec, family, lr)
    vec = spec.flatten(params)
    state = jax_dp.replicate_state(jax_dp.TrainState(vec, opt.init(vec)),
                                   mesh_1)
    step = jax_dp.make_train_step(loss_fn, opt, mesh_1,
                                  hardened=family == "wav2vec2",
                                  flat_spec=spec)
    losses = []
    for i, batch in enumerate(batches[:steps]):
        state, loss = step(state, jax_dp.shard_batch(batch, mesh_1),
                           jax.random.PRNGKey(i))
        losses.append(float(loss))
    final = jax.device_get(spec.unflatten(state.params))
    return losses, params_from_flax(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), final))


def test_base_models_flat_sizes():
    """The flat sizes the JAX trees give (jax.eval_shape), on the port's
    own trees (meta tensors): wav2vec2-base 232 leaves, 92,297,728
    parameters padded to 92,340,224, one all-reduce of 369,360,900 bytes
    with the loss; stacked 56 leaves, 369,250,308 bytes; whisper-base 262
    leaves padded to 98,238,464, 392,953,860 bytes."""
    from tethys_tpu_torch.models.whisper import WhisperConfig as WCfg

    def spec_of(model_class, config):
        with torch.device("meta"):
            model = model_class(config)
        return flat.FlatSpec(model)

    w = spec_of(w2v.Wav2Vec2ForPreTraining, Wav2Vec2Config.from_size("base"))
    assert (w.n_vars, sum(w.sizes), w.total) == (232, 92297728, 92340224)
    assert 4 * w.total + 4 == 369360900
    s = spec_of(w2v.Wav2Vec2ForPreTraining,
                Wav2Vec2Config.from_size("base", scan_layers=True))
    assert (s.n_vars, sum(s.sizes)) == (56, 92297728)
    assert 4 * s.total + 4 == 369250308
    h = spec_of(WhisperForConditionalGeneration, WCfg.from_size("base"))
    assert (h.n_vars, h.total) == (262, 98238464)
    assert 4 * h.total + 4 == 392953860


@pytest.mark.parametrize("family", ["whisper", "wav2vec2"])
def test_layout_and_roundtrip_match_jax(family):
    """Each parameter's size, padded size and chunks as JAX's FlatSpec of
    the flax tree gives them (the port orders them as named_parameters,
    JAX as the tree); the flat vector of each name holds what JAX's holds;
    flatten -> unflatten is the identity, padding zero."""
    if family == "whisper":
        _, params, port = _whisper()
    else:
        _, params, port, _ = _pair("pretraining")
    jspec = jax_flat.FlatSpec(params)
    spec = flat.FlatSpec(port)
    assert (spec.total, spec.n_chunks, spec.n_vars) == (
        jspec.total, jspec.n_chunks, jspec.n_vars)
    jvec = np.asarray(jspec.flatten(params))
    state = params_from_flax(params)
    vec = spec.flatten(dict(port.named_parameters()))
    back = spec.unflatten(vec)
    for j, name in enumerate(_torch_names(params)):
        i = spec.names.index(name)
        assert (spec.sizes[i], spec.padded[i]) == (jspec.sizes[j],
                                                   jspec.padded[j])
        assert torch.equal(back[name], state[name]), name
        chunks = spec.chunk2var[spec.offsets[i] // flat.CHUNK:
                                spec.offsets[i + 1] // flat.CHUNK]
        assert (chunks == i).all() and len(chunks) == spec.padded[i] // 1024
        mine = vec[spec.offsets[i]:spec.offsets[i] + spec.sizes[i]]
        theirs = jvec[int(jspec.offsets[j]):int(jspec.offsets[j])
                      + jspec.sizes[j]]
        assert np.array_equal(np.sort(mine.numpy()), np.sort(theirs)), name
    padding = torch.ones(spec.total, dtype=torch.bool)
    for off, n in zip(spec.offsets, spec.sizes):
        padding[off:off + n] = False
    assert not vec[padding].any()


def test_per_variable_norms_and_clip_match():
    """per_variable_sumsq against each tensor's own squares and JAX's
    flat per_variable_sumsq; clipnorm_ against the per-tensor clip
    (dp.per_variable_clipnorm) and JAX's flat clip; broadcast_per_variable
    against JAX's."""
    _, params, port, _ = _pair("pretraining")
    rng = np.random.default_rng(3)
    named = {n: torch.from_numpy(rng.standard_normal(p.shape).astype(
        np.float32) * rng.uniform(0.01, 3.0)) for n, p in
        port.named_parameters()}
    spec = flat.FlatSpec(port)
    vec = spec.flatten(named)
    want = torch.stack([named[n].square().sum() for n in spec.names])
    _close(spec.per_variable_sumsq(vec), want.numpy(), rtol=1e-6)
    jspec = jax_flat.FlatSpec(params)
    names = _torch_names(params)
    grads_tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params),
        [_to_flax(named[n], n) for n in names])
    jvec = jspec.flatten(grads_tree)
    jsq = np.asarray(jspec.per_variable_sumsq(jvec))
    _close(spec.per_variable_sumsq(vec),
           np.array([jsq[names.index(n)] for n in spec.names]), rtol=1e-6)
    values = torch.from_numpy(rng.uniform(0.5, 2.0, spec.n_vars).astype(
        np.float32))
    scaled = spec.unflatten(spec.broadcast_per_variable(values, vec))
    jvalues = jnp.asarray([values[spec.names.index(n)].item()
                           for n in names])
    jscaled = jspec.unflatten(jspec.broadcast_per_variable(jvalues, jvec))
    for n, t in params_from_flax(jax.device_get(jscaled)).items():
        _close(scaled[n], t.numpy(), rtol=1e-6, msg=n)
    spec.clipnorm_(vec, 1.0)
    per_tensor = [named[n].clone() for n in spec.names]
    dp.per_variable_clipnorm(per_tensor, 1.0)
    clipped = spec.unflatten(vec)
    for n, t in zip(spec.names, per_tensor):
        _close(clipped[n], t.numpy(), rtol=1e-6, atol=1e-7, msg=n)
    jclipped, _ = jax_flat.per_variable_clipnorm(jspec, 1.0).update(
        jvec, None)
    for n, t in params_from_flax(jax.device_get(
            jspec.unflatten(jclipped))).items():
        _close(clipped[n], t.numpy(), rtol=1e-6, atol=1e-7, msg=n)


def _to_flax(t: torch.Tensor, name: str) -> np.ndarray:
    """A state-dict tensor back in its flax layout."""
    from tethys_tpu_torch.convert import flax_from_state_dict
    tree = flax_from_state_dict({name: t})
    while isinstance(tree, dict):
        (tree,) = tree.values()
    return tree


@pytest.mark.parametrize("family", ["whisper", "wav2vec2"])
def test_flat_trajectory_matches_jax_flat_step(family):
    """10 steps of the port's flat step against JAX's flat step
    (make_train_step(flat_spec=)) on a one-device mesh: Whisper's plain
    step, Wav2Vec2's hardened one; every loss within 1e-4, and the
    parameters after the steps."""
    lr = 1e-3
    if family == "whisper":
        jmodel, params, port = _whisper()
        jax_loss, port_loss, batches = _whisper_losses(jmodel)
    else:
        jmodel, params, port, cfg = _pair("pretraining")
        jax_loss, port_loss, batches = _w2v_losses(jmodel, cfg)
    want, want_params = _jax_flat_steps(params, jax_loss, batches, family,
                                        lr)
    got, got_params, step, spec, _ = _port_steps(port, port_loss, batches,
                                                 family, lr, True)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    for name, p in got_params.items():
        if not name.endswith(ROUNDING_ONLY):
            _close(p, want_params[name].numpy(), rtol=1e-4, atol=1e-5,
                   msg=name)
    assert step.reducer is None and spec.total % flat.CHUNK == 0


@pytest.mark.parametrize("family", ["whisper", "wav2vec2"])
def test_flat_step_matches_the_per_tensor_step(family):
    """The port's flat step against its per-tensor step from the same
    weights: the losses within 1e-5, the parameters within 1e-5 but the
    two that step on rounding alone; every parameter a view of the flat
    master, every gradient a view of the flat gradient, the frozen
    codevectors unchanged."""
    lr = 1e-3
    runs = []
    for flat_on in (False, True):
        if family == "whisper":
            jmodel, params, port = _whisper()
            _, port_loss, batches = _whisper_losses(jmodel)
        else:
            jmodel, params, port, cfg = _pair("pretraining")
            _, port_loss, batches = _w2v_losses(jmodel, cfg)
        runs.append(_port_steps(port, port_loss, batches, family, lr,
                                flat_on, steps=5) + (port,))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for name, p in runs[0][1].items():
        if not name.endswith(ROUNDING_ONLY):
            _close(runs[1][1][name], p.numpy(), rtol=1e-5, atol=1e-6,
                   msg=name)
    spec, port = runs[1][3], runs[1][5]
    master = spec.param.detach()
    grad = spec.param.grad
    for name, p in port.named_parameters():
        assert p.untyped_storage().data_ptr() == \
            master.untyped_storage().data_ptr(), name
        if p.requires_grad:
            assert p.grad.data_ptr() == grad[
                spec.offsets[spec.names.index(name)]:].data_ptr(), name
    if family == "wav2vec2":
        cv = "wav2vec2.quantizer.codevectors"
        assert torch.equal(runs[1][1][cv], runs[0][1][cv])


def test_grad_aux_fn_receives_gradients_by_name():
    """grad_aux_fn sees every parameter's gradient under its name (zeros
    for those that take none), as the per-tensor step hands them."""
    jmodel, params, port, cfg = _pair("pretraining")
    _, port_loss, batches = _w2v_losses(jmodel, cfg)
    seen = []
    for flat_on in (False, True):
        jmodel, params, port, cfg = _pair("pretraining")
        out = _port_steps(port, port_loss, batches, "wav2vec2", 1e-3,
                          flat_on, steps=1, return_aux=True,
                          grad_aux_fn=lambda g: {k: v.clone()
                                                 for k, v in g.items()})
        seen.append(out[4][0]["grad_aux"])
    assert list(seen[1]) == [n for n, _ in port.named_parameters()]
    assert set(seen[1]) == set(seen[0])
    for name, g in seen[0].items():
        _close(seen[1][name], g.numpy(), rtol=1e-5, atol=1e-7, msg=name)
    assert not seen[1]["wav2vec2.quantizer.codevectors"].any()


def test_bf16_masters_match_jax_flat():
    """bf16 master weights on the flat buffer: the model's parameters and
    gradients bf16 views of bf16 shadows, the master and Adam in f32,
    against JAX's bf16 params + flat_spec (whose flat master is f32):
    Whisper, 5 steps, losses within 1e-4."""
    lr = 1e-3
    jmodel, params, port = _whisper(torch.bfloat16)
    jax_loss, port_loss, batches = _whisper_losses(jmodel)
    bf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                  params)
    want, _ = _jax_flat_steps(bf16, jax_loss, batches, "whisper", lr,
                              steps=5)
    got, got_params, _, spec, _ = _port_steps(port, port_loss, batches,
                                              "whisper", lr, True, steps=5)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert spec.param.dtype == torch.float32 and spec.cast
    assert {p.dtype for p in got_params.values()} == {torch.bfloat16}
    state = spec.unflatten(spec.param.detach())
    for name, p in got_params.items():
        assert torch.equal(state[name].to(torch.bfloat16), p), name


def test_two_ranks_one_all_reduce_and_the_per_tensor_result(tmp_path):
    """Two gloo ranks, Wav2Vec2's hardened step, 2 steps: under the flat
    buffer each step hands all_reduce exactly two tensors, the flat
    gradient itself (4 * total bytes, in place) and the loss (4), as the
    collective report says; the losses and parameters equal the
    per-tensor step's within 1e-5 (the rounding-only two aside) and
    agree on both ranks."""
    jmodel, params, port, cfg = _pair("pretraining")
    clips = iter(data.create_wav2vec2_dummy_dataset(4, audio_length=AUDIO))
    batches = [(torch.from_numpy(next(clips)[0]),
                torch.from_numpy(_negatives(cfg, batch=4, seed=9 + i)))
               for i in range(2)]
    torch.save({"config": {**TINY, **NO_DROPOUT}, "lr": 1e-3, "scale": 50.0,
                "state_dict": port.state_dict(), "batches": batches},
               tmp_path / "spec.pt")
    wait(torchrun_world(tmp_path, 2, "flat"))
    ranks = [torch.load(tmp_path / f"rank_{r}.pt") for r in range(2)]
    for kind in ("per_tensor", "flat"):
        assert ranks[0][kind]["losses"] == ranks[1][kind]["losses"]
        for k, p in ranks[0][kind]["params"].items():
            assert torch.equal(ranks[1][kind]["params"][k], p), (kind, k)
    got, want = ranks[0]["flat"], ranks[0]["per_tensor"]
    total = got["total"]
    assert got["calls"] == [[(4 * total, True), (4, False)]] * 2
    assert got["collective_bytes"] == {"all-reduce": 4 * total + 4}
    # Per tensor: the tiny model's gradients fit one bucket, concatenated.
    assert [len(c) for c in want["calls"]] == [2, 2]
    assert want["calls"][0][0][0] < 4 * total
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    for k, p in want["params"].items():
        if not k.endswith(ROUNDING_ONLY):
            _close(got["params"][k], p.numpy(), rtol=1e-5, atol=1e-6, msg=k)


def test_refusals():
    """flat_spec takes no grad_accum > 1, no remat and no TP, SP or PP
    layout (dp.make_train_step), and the jobs refuse --flat_opt with a
    parallel flag, naming it."""
    _, _, port = _whisper()
    spec = flat.FlatSpec(port)
    spec.bind(port)
    opt = flat.whisper_optimizer(spec)
    layout = mesh.Layout(axis="model", data=1, inner=2, data_rank=0,
                         inner_rank=0)

    def loss_fn(m, b, g):
        return m(b[0], labels=b[1], generator=g)["loss"], {}

    for kw, flag in ((dict(grad_accum=2), "grad_accum"),
                     (dict(remat=True), "--remat"),
                     (dict(layout=layout), "TP, SP or PP")):
        with pytest.raises(ValueError, match=flag):
            dp.make_train_step(loss_fn, opt, flat_spec=spec, **kw)
    for axis in ("model", "seq", "stage"):
        with pytest.raises(ValueError, match="--flat_opt"):
            jobs._check_flat_opt(True, layout._replace(axis=axis))
    jobs._check_flat_opt(True, mesh.make_data_mesh())
    with pytest.raises(ValueError, match="bind"):
        flat.whisper_optimizer(flat.FlatSpec(port))
    mixed = torch.nn.Linear(2, 2)
    mixed.bias.data = mixed.bias.data.bfloat16()
    with pytest.raises(ValueError, match="one dtype"):
        flat.FlatSpec(mixed).bind(mixed)


def test_jobs_build_the_flat_step():
    """make_whisper_job / make_wav2vec2_job(flat_opt=True) bind the model
    to one flat master and run their step on it; scan_layers and flat_opt
    together."""
    job = jobs.make_whisper_job(batch_size_per_replica=2,
                                data_seq_len=SEQ_LEN,
                                config_overrides=WHISPER_TINY, device="cpu",
                                seed=0, flat_opt=True)
    (master,) = job.state.optimizer.param_groups[0]["params"]
    assert master.numel() == flat.FlatSpec(job.state.model).total
    _, loss = job.step_fn(job.state, job.prepare_batch(
        next(iter(job.dataset))), dp.step_generator(0, 0))
    assert np.isfinite(loss.item())
    tiny = {k: v for k, v in TINY.items() if k != "num_negatives"}
    job = jobs.make_wav2vec2_job("pretraining", "tiny", 2, device="cpu",
                                 seed=0, audio_length=AUDIO,
                                 config_overrides=tiny, flat_opt=True,
                                 scan_layers=True)
    assert job.config.scan_layers
    names = [n for n, _ in job.state.model.named_parameters()]
    assert "wav2vec2.encoder.layers.attention.q_proj.weight" in names
    _, loss = job.step_fn(job.state, job.prepare_batch(
        next(iter(job.dataset))), dp.step_generator(0, 0))
    assert np.isfinite(loss.item())
