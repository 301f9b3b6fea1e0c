"""Wav2Vec2's stacked ``scan_layers`` layout in the port against the JAX
package's (tests/test_w2v2_scan.py), on the CPU at the tiny config of
tests/_torch_wav2vec2_common.py.

The JAX model's own parameters, stacked by its ``stack_layer_params`` and
converted (``convert.params_from_flax`` on the stacked tree), go into the
port's scanned model; dropout off where the two packages are compared.
Tolerances: the loss 1e-5 relative; gradients, mapped back through the
unstacking, rtol 2e-4 and atol 1e-5 of the tensor's largest gradient
(test_w2v2_scan.py's 2e-4 / 1e-5; at temperature 0.1 the gradients reach
~16, so an absolute 1e-5 would hold the conv stack's f32 chain to 6e-7 of
its scale); a gradient that is zero but for rounding is held below 1e-6
of the largest on both sides, as tests/test_torch_wav2vec2.py holds it.
"""

import copy
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu import losses as jax_losses
from tethys_tpu.models import wav2vec2 as jax_w2v
from tethys_tpu.parallel import tp as jax_tp
from tethys_tpu.train.jobs import _init_wav2vec2
from tethys_tpu_torch import convert
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.ops import sharding
from tethys_tpu_torch.parallel import dp, mesh, tp
from _torch_wav2vec2_common import AUDIO
from _torch_wav2vec2_common import audio as _audio
from _torch_wav2vec2_common import close as _close
from _torch_wav2vec2_common import configs as _configs
from _torch_wav2vec2_common import negatives as _negatives
from _torch_wav2vec2_common import t as _t

torch.set_num_threads(2)


def _jax_stacked(**overrides):
    """(JAX scanned model, its stacked params, port config): the unrolled
    JAX model's initialised parameters, stacked."""
    jcfg, _ = _configs(**overrides)
    unrolled = jax_w2v.Wav2Vec2ForPreTraining(jcfg)
    params = jax.device_get(_init_wav2vec2(unrolled, jcfg,
                                           jax.random.PRNGKey(0),
                                           "pretraining"))
    jcfg_s, cfg = _configs(scan_layers=True, **overrides)
    return (jax_w2v.Wav2Vec2ForPreTraining(jcfg_s),
            jax_w2v.stack_layer_params(params), cfg)


def _port_scanned(params, cfg):
    port = w2v.Wav2Vec2ForPreTraining(cfg)
    port.load_state_dict(convert.params_from_flax(params))
    return port.train()


def test_scanned_loss_and_gradients_match_jax_scan():
    jmodel, params, cfg = _jax_stacked()
    audio, neg = _audio(), _negatives(cfg)

    def jax_loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(audio), training=True,
                           deterministic=True)
        _, c = jax_losses.contrastive_loss(
            out["projected_states"], out["projected_quantized_features"],
            None, num_negatives=cfg.num_negatives,
            temperature=cfg.contrastive_logits_temperature,
            negative_indices=jnp.asarray(neg))
        return c + cfg.diversity_loss_weight * jax_losses.diversity_loss(
            out["codevector_perplexity"])

    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(params)
    port = _port_scanned(params, cfg)
    loss, _ = w2v.pretraining_loss(cfg, port(_t(audio)),
                                   negative_indices=_t(neg))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    want = convert.params_from_flax(jax_w2v.unstack_layer_params(
        jax.device_get(want_grads)))
    got = w2v.unstack_layer_params({n: p.grad for n, p in
                                    port.named_parameters()})
    assert set(want) == set(got)
    top = max(g.abs().max().item() for g in want.values())
    for name, g in want.items():
        if "quantizer" in name:
            assert got[name] is None and not g.any(), name
            continue
        scale = g.abs().max().item()
        if scale < 1e-6 * top:
            assert got[name].abs().max() < 1e-6 * top, name
            continue
        _close(got[name], g, rtol=2e-4, atol=1e-5 * scale, msg=name)


def test_stacked_tree_round_trips_through_convert():
    """The JAX stacked tree -> state dict -> the same tree; each leaf's
    flax path and shape from its torch name; the port's stacking of the
    converted unrolled tree equals the conversion of JAX's stacking."""
    _, params, cfg = _jax_stacked(use_weighted_layer_sum=True)
    state = convert.params_from_flax(params)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(state) == len(leaves)
    q = state["wav2vec2.encoder.layers.attention.q_proj.weight"]
    jq = params["wav2vec2"]["encoder"]["layers"]["attention"]["q_proj"][
        "kernel"]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).transpose(0, 2, 1))
    for path, leaf in leaves:
        keys = tuple(k.key for k in path)
        name = convert.torch_name(keys)
        assert convert.flax_path(name, leaf.ndim) == keys, name
        assert convert.flax_shape(name, state[name].shape) == leaf.shape
    back = convert.flax_from_state_dict(state)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))
    unrolled = convert.params_from_flax(jax_w2v.unstack_layer_params(params))
    stacked = w2v.stack_layer_params(unrolled)
    assert set(stacked) == set(_port_scanned(params, cfg).state_dict())
    for name, value in state.items():
        assert torch.equal(stacked[name], value), name
    again = w2v.unstack_layer_params(stacked)
    assert list(again) == list(unrolled)
    for name, value in unrolled.items():
        assert torch.equal(again[name], value), name


def test_scanned_init_names_and_shapes_match_jax():
    """The port's scanned model has JAX's scanned init tree: the same
    leaves at the same flax paths and shapes; and create_full_model's
    scanned weights are the unrolled model's of the same seed, stacked."""
    jcfg, cfg = _configs(scan_layers=True)
    jmodel = jax_w2v.Wav2Vec2ForPreTraining(jcfg)
    want = _init_wav2vec2(jmodel, jcfg, jax.random.PRNGKey(0), "pretraining")
    want = {tuple(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    port = w2v.Wav2Vec2ForPreTraining(cfg)
    got = {convert.flax_path(n, p.dim()): convert.flax_shape(n, p.shape)
           for n, p in port.named_parameters()}
    assert got == want
    tiny = {k: v for k, v in cfg.__dict__.items()
            if k not in ("model_size", "scan_layers")}
    scanned, _ = w2v.create_full_model("pretraining", "tiny", device="cpu",
                                       seed=5, **{**tiny, "scan_layers": True})
    unrolled, _ = w2v.create_full_model("pretraining", "tiny", device="cpu",
                                        seed=5, **tiny)
    stacked = w2v.stack_layer_params(unrolled.state_dict())
    assert list(stacked) == list(scanned.state_dict())
    for name, value in scanned.state_dict().items():
        assert torch.equal(value, stacked[name]), name
    frozen = scanned.wav2vec2.quantizer.codevectors
    assert not frozen.requires_grad


def test_weighted_layer_sum_matches_jax_scan():
    """The scanned encoder with the weighted layer sum against JAX's
    scanned encoder, eager, rtol 1e-5 / atol 1e-5 (the encoder tests'
    tolerance, tests/test_torch_wav2vec2.py)."""
    jcfg_u, _ = _configs(use_weighted_layer_sum=True)
    jcfg_s, cfg = _configs(use_weighted_layer_sum=True, scan_layers=True)
    x = np.random.default_rng(2).standard_normal(
        (2, 20, cfg.hidden_size)).astype(np.float32)
    p_u = jax_w2v.Wav2Vec2Encoder(jcfg_u).init(
        jax.random.PRNGKey(0), jnp.asarray(x), deterministic=True)["params"]
    p_u = dict(jax.device_get(p_u))
    p_u["layer_weights"] = np.asarray([0.3, -0.2], np.float32)
    p_s = jax_w2v.stack_layer_params({"encoder": p_u})["encoder"]
    want = jax_w2v.Wav2Vec2Encoder(jcfg_s).apply(
        {"params": p_s}, jnp.asarray(x), deterministic=True)
    port = w2v.Wav2Vec2Encoder(cfg).eval()
    port.load_state_dict(convert.params_from_flax(p_s))
    got = port(_t(x))["last_hidden_state"]
    _close(got, want["last_hidden_state"], atol=1e-5)


def test_param_shardings_on_the_stacked_tree_match_jax():
    """tp.param_shardings of the scanned model names, for every leaf, the
    torch dim JAX's tp.param_shardings splits on the stacked tree (found
    by converting an array that counts along JAX's split dim); the stack
    dim is never split."""
    _, params, cfg = _jax_stacked()
    jax_mesh = jax_tp.make_2d_mesh(8, model_parallel=2)
    specs = jax_tp.param_shardings(params, jax_mesh)
    got = tp.param_shardings(_port_scanned(params, cfg))
    stacked_seen = 0
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: hasattr(x, "spec"))[0]:
        keys = tuple(k.key for k in path)
        leaf = params
        for k in keys:
            leaf = leaf[k]
        name = convert.torch_name(keys)
        entries = tuple(spec.spec)
        if "model" not in entries:
            assert got[name] is None, name
            continue
        d = entries.index("model")
        marker = np.indices(leaf.shape)[d].astype(np.float32)
        torch_leaf = convert.params_from_flax(
            {"x": {keys[-1]: marker}} if len(keys) == 1 else
            _nest(keys, marker))[name]
        varies = [i for i in range(torch_leaf.dim())
                  if torch_leaf.shape[i] > 1 and not torch.equal(
                      torch_leaf.narrow(i, 0, 1).expand_as(torch_leaf),
                      torch_leaf)]
        assert varies == [got[name]], (name, entries)
        if convert.stacked(name.split(".")):
            stacked_seen += 1
            assert got[name] != 0
    # q, k, v and intermediate_dense with their biases, out_proj and
    # output_dense.
    assert stacked_seen == 10
    assert got["wav2vec2.encoder.layers.attention.q_proj.weight"] == 1
    assert got["wav2vec2.encoder.layers.attention.out_proj.weight"] == 2


def _nest(keys, value):
    tree = value
    for k in reversed(keys):
        tree = {k: tree}
    return tree


class _ThreadGroup:
    """A group of ``n`` ranks in one process, each a thread: the
    all_gather and SUM all_reduce that ops/sharding.py hands to
    torch.distributed, met at a barrier (no process group, no gloo)."""

    def __init__(self, n: int):
        self.n, self.slots = n, [None] * n
        self.barrier = threading.Barrier(n, timeout=60)
        self.local = threading.local()

    def _meet(self, t):
        self.slots[self.local.rank] = t.clone()
        self.barrier.wait()
        every = list(self.slots)
        self.barrier.wait()
        return every

    def all_gather(self, parts, t, group=None):
        for part, piece in zip(parts, self._meet(t)):
            part.copy_(piece)

    def all_reduce(self, t, op=None, group=None):
        every = self._meet(t)
        t.copy_(functools.reduce(torch.add, every))

    def run(self, fn):
        """fn(rank) on every rank at once; the results in rank order."""
        out, errors = [None] * self.n, []

        def body(rank):
            self.local.rank = rank
            try:
                out[rank] = fn(rank)
            except BaseException as exc:     # noqa: BLE001
                errors.append(exc)
                self.barrier.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


@pytest.fixture
def thread_group(monkeypatch):
    group = _ThreadGroup(2)
    monkeypatch.setattr(torch.distributed, "all_gather", group.all_gather)
    monkeypatch.setattr(torch.distributed, "all_reduce", group.all_reduce)
    monkeypatch.setattr(sharding, "_note", lambda *args, **kwargs: None)
    return group


def _tp_layout(rank: int) -> mesh.Layout:
    return mesh.Layout(axis="model", data=1, inner=2, data_rank=0,
                       inner_rank=rank)


def test_tp_and_sp_take_the_stacked_layout(monkeypatch, thread_group):
    """shard_model, the encoder under a seq group and make_wav2vec2_job
    take the stacked layout, on two ranks met as threads: each stacked
    leaf holds its rank's slice on JAX's dim, the layer body's attention
    and feed-forward the group, and the sharded pretraining forward (rates
    0) and the encoder under seq rules give the unsharded scanned model's
    outputs (1e-5, the encoder tests' tolerance)."""
    from tethys_tpu_torch.train import jobs

    _, cfg = _configs(scan_layers=True)
    tiny = {k: v for k, v in cfg.__dict__.items()
            if k not in ("model_size", "scan_layers")}
    whole, _ = w2v.create_full_model("pretraining", "tiny", device="cpu",
                                     seed=3, **{**tiny, "scan_layers": True})
    whole.train()
    audio = _t(_audio())
    with torch.no_grad():
        want = whole(audio, generator=torch.Generator().manual_seed(0))
    state = whole.state_dict()

    def tp_rank(rank):
        layout = _tp_layout(rank)
        model, _ = w2v.create_full_model("pretraining", "tiny", device="cpu",
                                         seed=3, **{**tiny,
                                                    "scan_layers": True})
        tp.shard_model(model.train(), layout)
        body = model.wav2vec2.encoder.layers
        assert body.attention.tp == body.feed_forward.tp == sharding.Shard(
            None, 2, rank)
        mine = tp.shard_params(state, layout)
        for name, p in model.state_dict().items():
            assert torch.equal(p, mine[name]), name
        with torch.no_grad():
            return model(audio, generator=torch.Generator().manual_seed(0))

    for got in thread_group.run(tp_rank):
        for key in ("projected_states", "projected_quantized_features"):
            _close(got[key], want[key], atol=1e-5, msg=key)
        assert torch.equal(got["codevector_indices"],
                           want["codevector_indices"])
    q = "wav2vec2.encoder.layers.attention.q_proj.weight"
    encoder = whole.wav2vec2.encoder.eval()
    hidden = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 21, cfg.hidden_size)).astype(np.float32))
    with torch.no_grad():
        want_h = encoder(hidden)["last_hidden_state"]

    copies = [copy.deepcopy(encoder) for _ in range(2)]   # one a rank

    def sp_rank(rank):
        with sharding.seq_axis_rules(sharding.Shard(None, 2, rank)), \
                torch.no_grad():
            return copies[rank](hidden)["last_hidden_state"]

    for got in thread_group.run(sp_rank):
        _close(got, want_h, atol=1e-5)

    for axis in ("model", "seq"):
        monkeypatch.setattr(jobs, "parallel_layout",
                            lambda *a, axis=axis: _tp_layout(0)._replace(
                                axis=axis))
        job = jobs.make_wav2vec2_job("pretraining", "tiny", 1,
                                     scan_layers=True, device="cpu")
        model = job.state.model
        assert model.config.scan_layers and job.state.layout.axis == axis
        size = model.config.hidden_size
        assert model.state_dict()[q].shape == (
            model.config.num_hidden_layers,
            size // 2 if axis == "model" else size, size)


def test_scanned_tp_checkpoint_gathers_and_shards(thread_group):
    """Whole checkpoints of a scanned model over a model group of 2
    (ranks met as threads): ``gather_params`` is the one-process scanned
    state dict, ``shard_params`` of it each rank's own shards, its flax
    tree JAX's ``stack_layer_params`` tree bit for bit, and back; Adam's
    moments
    gathered whole (``gather_optimizer_state``) and cut back
    (``shard_optimizer_state``) likewise."""
    _, params, cfg = _jax_stacked()
    one = _port_scanned(params, cfg)
    gen = torch.Generator().manual_seed(7)
    moments = {n: (torch.randn(p.shape, generator=gen),
                   torch.rand(p.shape, generator=gen))
               for n, p in one.named_parameters() if p.requires_grad}

    def rank_of(rank):
        layout = _tp_layout(rank)
        model = tp.shard_model(_port_scanned(params, cfg), layout)
        local = {n: p.detach().clone() for n, p in model.state_dict().items()}
        opt = dp.wav2vec2_optimizer(model.parameters())
        mine = {n: tp.shard_params({n: m}, layout)[n]
                for n, (m, _) in moments.items()}
        mine_v = {n: tp.shard_params({n: v}, layout)[n]
                  for n, (_, v) in moments.items()}
        for n, p in model.named_parameters():
            if n in moments:
                opt.state[p] = {"step": 1, "m": mine[n], "v": mine_v[n]}
        whole_opt = tp.gather_optimizer_state(opt, model, layout)
        return (local, tp.gather_params(model, layout), whole_opt,
                tp.shard_optimizer_state(whole_opt, opt, model, layout),
                opt.state_dict())

    names = [n for n, _ in one.named_parameters()]   # the state's indices
    stacked_seen = 0
    for rank, (local, whole, whole_opt, cut, own) in enumerate(
            thread_group.run(rank_of)):
        assert list(whole) == list(one.state_dict())
        for name, value in one.state_dict().items():
            assert torch.equal(whole[name], value), name
        again = tp.shard_params(whole, _tp_layout(rank))
        for name, value in local.items():
            assert torch.equal(again[name], value), name
            if convert.stacked(name.split(".")) and tp.shard_dim(
                    name, value.dim()) is not None:
                stacked_seen += 1
                assert value.shape[0] == cfg.num_hidden_layers
        tree = convert.flax_from_state_dict(whole)
        jax.tree_util.tree_map(np.testing.assert_array_equal, tree,
                               jax.tree_util.tree_map(np.asarray, params))
        back = convert.params_from_flax(tree)
        assert list(back) == list(whole)
        for name, value in whole.items():
            assert torch.equal(back[name], value), name
        for idx, state in whole_opt["state"].items():
            name = names[int(idx)]
            assert torch.equal(state["m"], moments[name][0]), name
            assert torch.equal(state["v"], moments[name][1]), name
            for key in ("m", "v"):
                assert torch.equal(cut["state"][idx][key],
                                   own["state"][idx][key]), name
    assert stacked_seen == 2 * 10


def test_hardened_step_scanned_matches_unrolled():
    """5 hardened steps (wav2vec2_optimizer, dropout on, the loss scaled so
    that both clips bite) of the scanned model against the unrolled one
    from the same weights and generators: the losses within 1e-6
    relative and the parameters within 1e-5 (the global clip's norm sums
    the stacked tensors' squares in another order), but the two whose
    gradient is rounding alone."""
    _, cfg = _configs()
    dropout = dict(hidden_dropout=0.1, attention_dropout=0.1,
                   activation_dropout=0.1)
    tiny = {**{k: v for k, v in cfg.__dict__.items()
               if k not in ("model_size", "scan_layers")}, **dropout}
    audio = _t(_audio())
    runs = []
    for scan in (False, True):
        model, config = w2v.create_full_model(
            "pretraining", "tiny", device="cpu", seed=1,
            **{**tiny, "scan_layers": scan})
        model.train()
        opt = dp.wav2vec2_optimizer(model.parameters(), 1e-3)
        frames = config.downsampled_length(AUDIO)

        def loss_fn(m, batch, generator):
            from tethys_tpu_torch import losses
            neg = losses.sample_negative_indices(generator, 2, frames,
                                                 config.num_negatives)
            loss, aux = w2v.pretraining_loss(
                config, m(batch[0], generator=generator),
                negative_indices=neg)
            return loss * 50.0, aux

        step = dp.make_train_step(loss_fn, opt, hardened=True)
        state, losses_seen = dp.TrainState(model, opt), []
        for i in range(5):
            state, loss = step(state, (audio,), dp.step_generator(0, i))
            losses_seen.append(loss.item())
        runs.append((losses_seen, model.state_dict()))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    got = w2v.unstack_layer_params(runs[1][1])
    for name, value in runs[0][1].items():
        # A key bias and project_q's LayerNorm bias take a gradient that is
        # zero but for rounding, which Adam turns into steps of +-lr
        # (tests/test_torch_wav2vec2_jobs.py).
        if not name.endswith(("k_proj.bias", "project_q.layer_norm.bias")):
            _close(got[name], value, rtol=1e-5, atol=1e-6, msg=name)
