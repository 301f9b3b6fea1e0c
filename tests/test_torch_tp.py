"""The port's tensor parallelism against the JAX package's, on the CPU.

Worlds of 4 gloo processes (tests/_torch_parallel_ranks.py), laid out
(data 2, model 2) as JAX reshapes its devices; the JAX side runs on the
8 fake CPU devices of conftest, on a mesh of the same shape.  Weights: the
JAX model's own (tests/test_tp.py's TINY), converted with
``convert.params_from_flax`` and sharded by each rank.

One world holds several checks, so that the file stays well inside
tier-1's time:
* every rank's parameter shapes equal the shard shapes JAX's
  ``tp.param_shardings`` gives its device;
* ``greedy_generate`` under tensor parallelism emits JAX's tokens and
  length (tests/test_tp.py's ``test_tp_sharded_generate_matches_unsharded``);
* 2 SGD steps equal JAX's ``make_tp_train_step`` on the (data 2, model 2)
  mesh: losses rtol 1e-5, parameters rtol 2e-4 / atol 1e-6 (tests/
  test_sp.py's tolerance; SGD, as tests/test_tp.py, keeps the comparison
  proportional to the gradients);
* the same steps under ``remat_layers`` equal them;
* with module dropout on (dropout and activation_dropout 0.1; attention's
  0, whose flash mask keeps local coordinates as JAX's does) they equal
  the port's data-parallel step over the same 2 replicas, computed in one
  process: fc1's column shards draw their columns of the unsharded mask;
* a checkpoint of a Keras-Adam step, written by rank 0 whole, restores
  into a data-parallel run, Adam's moments whole;
* with TETHYS_FUSED_QKV=1 (the fused projections on each rank's heads;
  JAX's fused Pallas route has no partitioning rule and runs on gathered
  weights under a TP mesh) the tokens and the steps are the same.
A chief and 3 workers (TF_CONFIG) run ``whisper_dist --tp 2``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tethys_tpu.configs import WhisperConfig as JaxConfig
from tethys_tpu.models.whisper import WhisperForConditionalGeneration as JaxWhisper
from tethys_tpu.models.whisper import greedy_generate as jax_greedy
from tethys_tpu.parallel import tp as jax_tp
from tethys_tpu_torch.checkpoint import CheckpointManager
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import flax_path, params_from_flax
from tethys_tpu_torch.models.whisper import WhisperForConditionalGeneration
from tethys_tpu_torch.ops import sharding
from tethys_tpu_torch.parallel import dp, mesh, tp

import _torch_parallel_ranks as ranks_lib

TINY = dict(
    d_model=32, encoder_layers=1, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=32, vocab_size=64, max_target_positions=32,
    decoder_start_token_id=63,
)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
DROPOUT = dict(dropout=0.1, attention_dropout=0.0, activation_dropout=0.1)
LR = 1e-2
MAX_LENGTH = 12


def _close(got, want, rtol=2e-4, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _setup():
    """tests/test_tp.py's _setup: the model, its params, 8 rows."""
    model = JaxWhisper(JaxConfig(**TINY))
    rng = jax.random.PRNGKey(0)
    feats = np.random.default_rng(0).standard_normal((8, 8, 64)).astype(
        np.float32)
    labels = np.random.default_rng(1).integers(3, 40, (8, 10)).astype(
        np.int32)
    params = model.init({"params": rng, "dropout": rng}, feats[:1],
                        labels=labels[:1], deterministic=True)["params"]
    return model, params, feats, labels


def _leaf(tree, name, ndim):
    for part in flax_path(name, ndim):
        tree = tree[part]
    return tree


def _torch_shape(name, flax_shape):
    """A flax shard shape in the port's layout (kernels transposed)."""
    if flax_path(name, len(flax_shape))[-1] == "kernel":
        return tuple(flax_shape[::-1])
    return tuple(flax_shape)


def test_tp_world_matches_jax(tmp_path):
    model, params, feats, labels = _setup()
    params = jax.device_get(params)
    batches = [(feats[:4], labels[:4]), (feats[4:], labels[4:])]
    torch.save({"config": {**TINY, **NO_DROPOUT},
                "state_dict": params_from_flax(params), "lr": LR, "seed": 0,
                "batches": [tuple(torch.from_numpy(a) for a in b)
                            for b in batches],
                "generate": torch.from_numpy(feats),
                "max_length": MAX_LENGTH, "dropout": DROPOUT},
               tmp_path / "spec.pt")
    world = ranks_lib.torchrun_world(tmp_path, 4, "tp")
    try:
        want_tokens, want_len = jax_greedy(model, {"params": params},
                                           jnp.asarray(feats),
                                           max_length=MAX_LENGTH)
        jmesh = jax_tp.make_2d_mesh(4, model_parallel=2)
        shardings = jax_tp.param_shardings(params, jmesh)

        def loss_fn(p, batch, rng):
            f, l = batch
            return model.apply({"params": p}, f, labels=l,
                               deterministic=True)["loss"], {}

        opt = optax.sgd(LR)
        state = jax_tp.init_tp_state(params, opt, jmesh)
        step = jax_tp.make_tp_train_step(loss_fn, opt, jmesh)
        want_losses = []
        for i, (f, l) in enumerate(batches):
            state, loss = step(state, (jnp.asarray(f), jnp.asarray(l)),
                               jax.random.PRNGKey(i))
            want_losses.append(float(loss))
        want_params = params_from_flax(jax.device_get(state.params))
        dp_losses, dp_params = ranks_lib.port_dp(
            torch.load(tmp_path / "spec.pt"), 2, DROPOUT)
    finally:
        ranks_lib.wait(world)
    ranks = [torch.load(tmp_path / f"rank_{r}.pt") for r in range(4)]

    # The layout, and each rank's shards against JAX's.
    assert [r["layout"] for r in ranks] == [
        (2, 2, 0, 0), (2, 2, 0, 1), (2, 2, 1, 0), (2, 2, 1, 1)]
    sharded = 0
    for r in ranks:
        for name, shape in r["shapes"].items():
            leaf = _leaf(params, name, len(shape))
            want = _torch_shape(
                name, _leaf(shardings, name, len(shape)).shard_shape(
                    leaf.shape))
            assert shape == want, (name, shape, want)
            sharded += shape != tuple(want_params[name].shape)
    # Per rank: 3 attentions x (q/k/v weights and biases, out_proj's
    # weight), 2 FFNs x (fc1's weight and bias, fc2's weight), the two
    # convs' weights and biases, the embedding, the lm_head.
    assert sharded == 4 * (3 * 7 + 2 * 3 + 4 + 2)

    for r in ranks:
        assert torch.equal(r["tokens"], torch.from_numpy(
            np.array(want_tokens))), (r["tokens"], want_tokens)
        assert r["length"] == int(want_len)
        _close(r["losses"], want_losses, rtol=1e-5, atol=0)
        assert r["remat_losses"] == r["losses"]
        _close(r["dropout_losses"], dp_losses, rtol=1e-5, atol=0)
        assert r["dropout_losses"][0] != r["losses"][0]   # it dropped
        assert torch.equal(r["fused_tokens"], r["tokens"])
        _close(r["fused_losses"], want_losses, rtol=1e-5, atol=0)
    for r in (ranks[0], ranks[2]):   # the two model groups
        for name, p in r["params"].items():
            _close(p, want_params[name], msg=name)
            _close(r["remat_params"][name], p, rtol=1e-6, atol=1e-7, msg=name)
            _close(r["dropout_params"][name], dp_params[name], msg=name)
            _close(r["fused_params"][name], want_params[name], msg=name)

    # Rank 0's whole checkpoint restores into a data-parallel run.
    port = WhisperForConditionalGeneration(WhisperConfig(**TINY, **NO_DROPOUT))
    opt = dp.whisper_optimizer(port.parameters(), 1e-3)
    restored = CheckpointManager(str(tmp_path / "ckpt")).restore_like(
        "whisper_tiny_epoch_1", dp.TrainState(port, opt))
    for name, p in restored.model.state_dict().items():
        assert torch.equal(p, ranks[0]["adam_params"][name]), name
    m = {n: opt.state[p]["m"] for n, p in port.named_parameters()}
    for r in ranks:
        layout = mesh.Layout("model", 2, 2, *r["layout"][2:])
        for name, local in r["adam_m"].items():
            assert torch.equal(tp.shard_params({name: m[name]}, layout)[name],
                               local), name
    step = dp.make_train_step(ranks_lib.loss_fn, opt)
    _, loss = step(restored, tuple(torch.from_numpy(a[:2])
                                   for a in batches[0]),
                   dp.step_generator(0, 2))
    assert np.isfinite(loss.item())


def test_shard_slices_match_jax_devices_indices_map():
    """Each rank's slice of every leaf is the one JAX's NamedSharding puts
    on its device, for model groups of 2 and 4 (whisper-large-v3's vocab,
    51866, at 2).  JAX refuses a dim that the group does not divide (51866
    over 4); the port splits it in chunks of ceil(n / 4), the last one
    shorter, and the slices tile the whole."""
    config = JaxConfig(**{**TINY, "vocab_size": 51866,
                          "decoder_start_token_id": 50258})
    model = JaxWhisper(config)
    shapes = jax.eval_shape(lambda r: model.init(
        {"params": r, "dropout": r}, jnp.zeros((1, 8, 64)),
        labels=jnp.zeros((1, 4), jnp.int32), deterministic=True)["params"],
        jax.random.PRNGKey(0))
    names = params_from_flax(jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes))
    for inner in (2, 4):
        jmesh = jax_tp.make_2d_mesh(8, model_parallel=inner)
        shardings = jax_tp.param_shardings(shapes, jmesh)
        devices = np.asarray(jmesh.devices)
        for name, zeros in names.items():
            whole = torch.arange(zeros.numel(), dtype=torch.float64).reshape(
                zeros.shape)
            pieces = [tp.shard_params(
                {name: whole}, mesh.Layout("model", 8 // inner, inner, 0, i)
            )[name] for i in range(inner)]
            dim = tp.shard_dim(name, whole.dim())
            if dim is not None:
                assert torch.equal(torch.cat(pieces, dim), whole), name
            if inner == 4 and 51866 in whole.shape:
                assert [p.shape[dim] for p in pieces] == [12967] * 3 + [12965]
                continue
            leaf = _leaf(shapes, name, zeros.dim())
            index = _leaf(shardings, name, zeros.dim()).devices_indices_map(
                leaf.shape)
            for d in range(8 // inner):
                for i in range(inner):
                    flax_index = index[devices[d, i]]
                    if flax_path(name, zeros.dim())[-1] == "kernel":
                        flax_index = flax_index[::-1]
                    got = tp.shard_params(
                        {name: whole},
                        mesh.Layout("model", 8 // inner, inner, d, i))[name]
                    assert torch.equal(got, whole[flax_index]), (name, d, i)
    assert sharding.shard_range(51866, 4, 3) == (3 * 12967, 51866)


def test_tp_must_divide_heads_and_d_ff():
    cfg = WhisperConfig(**TINY)
    tp.check_divides(cfg, 2)
    with pytest.raises(ValueError, match="tp=3 does not divide.*whisper tiny"):
        tp.check_divides(cfg, 3, "whisper tiny")
    model = WhisperForConditionalGeneration(WhisperConfig(
        **{**TINY, "encoder_attention_heads": 1}))
    with pytest.raises(ValueError, match="encoder_attention_heads"):
        tp.shard_model(model, mesh.Layout("model", 1, 2, 0, 0))


def test_whisper_dist_tp_chief_and_three_workers(tmp_path):
    """python -m tethys_tpu_torch.jobs.whisper_dist --tp 2 --device cpu as
    a chief and 3 workers: two data replicas of two model ranks, the same
    losses on every rank, a checkpoint written whole by the chief alone."""
    tiny = {"config": {**TINY, "vocab_size": 128, "max_target_positions":
                       128, "decoder_start_token_id": 101},
            "seq_len": 64}
    outs, final = ranks_lib.cli_world(tmp_path, tiny, "--tp", "2")
    losses = []
    for r, out in enumerate(outs):
        lines = out.splitlines()
        assert f"process group: gloo, rank {r} of 4" in lines, out
        assert "batch size per replica: 2, global batch size: 4" in lines
        losses.append([line.split("Loss: ")[1][:6] for line in lines
                       if line.startswith("Step ")])
    assert len(losses[0]) == 2 and all(l == losses[0] for l in losses)
    whole = WhisperForConditionalGeneration(WhisperConfig(**tiny["config"]))
    assert {k: tuple(v.shape) for k, v in final.items()} == {
        k: tuple(v.shape) for k, v in whole.state_dict().items()}
    tags = {p.name: sorted(d.name for d in (p / "checkpoints").iterdir()
                           if not d.name.startswith("."))
            for p in tmp_path.glob("ws_*")}
    assert tags == {"ws_chief_0": ["whisper_tiny_epoch_1"], "ws_worker_0": [],
                    "ws_worker_1": [], "ws_worker_2": []}
    saved = torch.load(tmp_path / "ws_chief_0" / "checkpoints" /
                       "whisper_tiny_epoch_1" / "model.pt")
    for name, p in final.items():
        assert torch.equal(saved[name], p), name
    names = sorted(p.name for p in (tmp_path / "result" / "run1").iterdir())
    assert names == sorted(f"{t}_{i}_{kind}.txt"
                           for t, i in [("chief", 0), ("worker", 0),
                                        ("worker", 1), ("worker", 2)]
                           for kind in ("collectives", "jct"))
