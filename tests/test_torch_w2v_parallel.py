"""The port's Wav2Vec2 tensor and sequence parallelism against the JAX
package's, on the CPU.

Two gloo worlds (tests/_torch_parallel_ranks.py's ``w2v`` ranks), of 2 and
of 4 processes, run side by side; each rank takes every case of its
world's size.  The JAX side runs on conftest's 8 fake CPU devices, on
meshes of the same shapes.  Weights: the JAX model's own (tests/
_torch_wav2vec2_common.py's tiny config), converted with
``convert.params_from_flax``.  Every case takes 2 hardened steps with
``wav2vec2_optimizer`` (Keras Adam with clipnorm 1), its loss scaled by 50
so that the global-norm clip bites on every replica, on numpy-seeded audio
with fixed negatives carried in the batch:

* TP over (data 1, model 2) and (data 2, model 2) against JAX's
  ``tp.make_tp_train_step(hardened=True)``: the conv stack, the
  quantizer's codevectors and projection and the trunk are sharded.  At
  data 1 JAX's TP step does not compile (XLA's SPMD partitioner refuses
  its cross-partition all-reduce outside manual mode), so those cases are
  held to what its one replica computes: JAX's hardened step on a
  one-device mesh;
* SP over (data 1, seq 2), on 21 frames that the degree does not divide,
  and over (data 2, seq 2), against JAX's ``sp.make_sp_train_step(
  hardened=True)``;
* GroupNorm with 2 groups over a model group of 4 (the channels gathered
  for the kernels), heads 4, against JAX's step over (data 1, model 4);
* TP and SP over 2 ranks with every dropout rate 0.1 against one port
  process: the shards draw their slices of the unsharded masks; TP and SP
  under ``remat`` with ``grad_accum`` 2 and the CTC head under TP (its
  lm_head over the vocab, the dummy loss), against one port process;
* the feature encoder's LayerNorm (``feat_extract_norm="layer"``, on the
  gathered channels) under TP, against JAX.
Losses within 1e-5 relative, parameters within rtol 2e-4 / atol 1e-6
(test_torch_tp.py's tolerances; the parameters whose true gradient is 0,
``ROUNDING_ONLY``, take Adam's step on rounding noise and are left out, as
in test_torch_dp.py); the quantizer's indices equal one process's but at
a tie; each rank's replicated parameters equal its group's bit for bit;
Keras clipnorm and the global clip on shards equal them on the whole
tensors.  Then the ``wav2vec2_dist`` CLI: ``--tp 2`` and ``--sp 2`` each
as a chief and a worker to completion, the ``--tp 2`` whole checkpoint
resumed by a ``--tp 1`` run, and ``--tp 2 --sp 2`` refused with the JAX
parser's error.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tethys_tpu import losses as jax_losses
from tethys_tpu.parallel import dp as jax_dp
from tethys_tpu.parallel import sp as jax_sp
from tethys_tpu.parallel import tp as jax_tp
from tethys_tpu.parallel.mesh import make_data_mesh
from tethys_tpu_torch.configs import Wav2Vec2Config
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.jobs import wav2vec2_dist
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.ops import group_norm, sharding
from tethys_tpu_torch.ops.norms import ReferenceGroupNorm
from tethys_tpu_torch.parallel import mesh, tp

import _torch_parallel_ranks as ranks_lib
from _torch_wav2vec2_common import AUDIO, NO_DROPOUT, TINY, pair

LR, SCALE, SEED, STEPS = 1e-3, 50.0, 0, 2
ODD_AUDIO = 420          # 84 -> 42 -> 21 frames: seq 2 splits them 11 + 10
DROPOUT = dict(hidden_dropout=0.1, activation_dropout=0.1,
               attention_dropout=0.1)
# heads 4 for a model group of 4; 2 GroupNorm groups, which 4 ranks split.
GN_UNEVEN = dict(num_attention_heads=4, num_conv_pos_embedding_groups=2)
ROUNDING_ONLY = ("k_proj.bias", "project_q.layer_norm.bias")
FIELDS = ("name", "world", "axis", "inner", "config", "batches", "overrides",
          "options")
CAPACITY = dict(remat=True, grad_accum=2)
# FIELDS; the cases with config overrides or step options are held to one
# port process, the others to JAX.
CASES = [
    ("tp_1x2", 2, "model", 2, "tiny", "even_2", {}, {}),
    ("sp_1x2_odd", 2, "seq", 2, "tiny", "odd_2", {}, {}),
    ("tp_1x2_dropout", 2, "model", 2, "tiny", "even_2", DROPOUT, {}),
    ("sp_1x2_dropout", 2, "seq", 2, "tiny", "odd_2", DROPOUT, {}),
    ("tp_1x2_remat_accum", 2, "model", 2, "tiny", "even_2", {}, CAPACITY),
    ("sp_1x2_remat_accum", 2, "seq", 2, "tiny", "odd_2", {}, CAPACITY),
    ("tp_1x2_ctc", 2, "model", 2, "asr", "even_2", {}, {"head": "asr"}),
    ("tp_1x2_layer_norm", 2, "model", 2, "layer", "even_2", {}, {}),
    ("tp_2x2", 4, "model", 2, "tiny", "even_4", {}, {}),
    ("sp_2x2", 4, "seq", 2, "tiny", "even_4", {}, {}),
    ("tp_1x4_gn_uneven", 4, "model", 4, "gn_uneven", "even_2", {}, {}),
]
# Each case with dropout and its case at rate 0.
DROPPED = {"tp_1x2_dropout": "tp_1x2", "sp_1x2_dropout": "sp_1x2_odd"}


def _batches(rows, samples, cfg, seed):
    frames = cfg.downsampled_length(samples)
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((rows, samples)).astype(np.float32),
             rng.integers(0, frames, (rows, cfg.num_negatives)).astype(
                 np.int32)) for _ in range(STEPS)]


def _jax_steps(jmodel, cfg, params, batches, axis, world, inner):
    """JAX's hardened TP or SP step with wav2vec2_optimizer: the logged
    losses and the parameters after the last step, in the port's names."""
    def loss_fn(p, batch, rng):
        audio, negatives = batch
        out = jmodel.apply({"params": p}, audio, training=True,
                           deterministic=True)
        _, c = jax_losses.contrastive_loss(
            out["projected_states"], out["projected_quantized_features"],
            None, num_negatives=cfg.num_negatives,
            temperature=cfg.contrastive_logits_temperature,
            negative_indices=negatives)
        loss = c + cfg.diversity_loss_weight * jax_losses.diversity_loss(
            out["codevector_perplexity"])
        return loss * SCALE, {}

    opt = jax_dp.wav2vec2_optimizer(LR)
    params = jax.device_get(params)
    if axis == "model" and world == inner:     # one replica (module doc)
        jmesh = make_data_mesh(1)
        state = jax_dp.replicate_state(
            jax_dp.TrainState(params, opt.init(params)), jmesh)
        dp_step = jax_dp.make_train_step(loss_fn, opt, jmesh, hardened=True)

        def step(state, batch, rng):
            return dp_step(state, jax_dp.shard_batch(batch, jmesh), rng)
    elif axis == "model":
        jmesh = jax_tp.make_2d_mesh(world, model_parallel=inner)
        state = jax_tp.init_tp_state(params, opt, jmesh)
        step = jax_tp.make_tp_train_step(loss_fn, opt, jmesh, hardened=True)
    else:
        jmesh = jax_sp.make_seq_mesh(world, seq_parallel=inner)
        state = jax_sp.init_sp_state(params, opt, jmesh)
        step = jax_sp.make_sp_train_step(loss_fn, opt, jmesh, hardened=True)
    losses = []
    for i, (audio, negatives) in enumerate(batches):
        state, loss = step(state, (jnp.asarray(audio), jnp.asarray(negatives)),
                           jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, params_from_flax(jax.device_get(state.params))


def _close(got, want, rtol=2e-4, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _check_indices(name, got, want, distances):
    """The sharded quantizer's step-0 indices against one process's: a
    flip only where the two codevectors' distances tie (1e-5 relative)."""
    flips = got != want
    if flips.any():
        d = distances.gather(-1, got[..., None])[..., 0][flips]
        d_min = distances.gather(-1, want[..., None])[..., 0][flips]
        gap = ((d - d_min).abs() / d_min.abs().clamp_min(1e-6)).max()
        assert gap.item() <= 1e-5, (name, gap)


def test_w2v_tp_and_sp_worlds_match_jax(tmp_path):
    configs, state_dicts, jax_side = {}, {}, {}
    for key, kind, overrides in (("tiny", "pretraining", {}),
                                 ("gn_uneven", "pretraining", GN_UNEVEN),
                                 ("asr", "asr", {}),
                                 ("layer", "pretraining",
                                  {"feat_extract_norm": "layer"})):
        jmodel, params, port, cfg = pair(kind, **overrides)
        configs[key] = {**TINY, **NO_DROPOUT, **overrides}
        state_dicts[key] = port.state_dict()
        jax_side[key] = (jmodel, params, cfg)
    cfg = jax_side["tiny"][2]
    batches = {"even_2": _batches(2, AUDIO, cfg, 1),
               "even_4": _batches(4, AUDIO, cfg, 2),
               "odd_2": _batches(2, ODD_AUDIO, cfg, 3)}
    assert cfg.downsampled_length(ODD_AUDIO) % 2 == 1
    spec = {"lr": LR, "scale": SCALE, "seed": SEED, "configs": configs,
            "state_dicts": state_dicts,
            "batches": {k: [tuple(torch.from_numpy(a) for a in b) for b in v]
                        for k, v in batches.items()},
            "cases": [dict(zip(FIELDS, c)) for c in CASES]}
    dirs = {n: tmp_path / f"world_{n}" for n in (2, 4)}
    worlds = []
    for n, d in dirs.items():
        d.mkdir()
        torch.save(spec, d / "spec.pt")
        worlds.append(ranks_lib.torchrun_world(d, n, "w2v"))
    want = {}
    try:
        for case in CASES:
            name, world, axis, inner, key, bkey, overrides, options = case
            if overrides or options:     # one port process (data 1)
                one = ranks_lib.w2v_steps(spec, dict(zip(FIELDS, case)), None)
                want[name] = one["losses"], one["params"]
            else:
                jmodel, params, jcfg = jax_side[key]
                want[name] = _jax_steps(jmodel, jcfg, params, batches[bkey],
                                        axis, world, inner)
    finally:
        for w in worlds:
            ranks_lib.wait(w)
    ranks = {n: [torch.load(d / f"rank_{r}.pt") for r in range(n)]
             for n, d in dirs.items()}

    for name, world, axis, inner, key, bkey, overrides, options in CASES:
        want_losses, want_params = want[name]
        group = ranks[world]
        assert [r[name]["layout"] for r in group] == [
            (world // inner, inner, i // inner, i % inner)
            for i in range(world)], name
        for r in group:
            got = r[name]
            _close(got["losses"], want_losses, rtol=1e-5, atol=0, msg=name)
            for n, p in want_params.items():
                if n.endswith(ROUNDING_ONLY):
                    continue
                _close(got["params"][n], p, msg=f"{name} {n}")
            # one process on the first replica's rows
            cfg_one = Wav2Vec2Config(**{**configs[key], **overrides})
            if got["layout"][2] == 0 and not (overrides or options):
                model = w2v.Wav2Vec2ForPreTraining(cfg_one)
                model.load_state_dict(state_dicts[key])
                rows = len(spec["batches"][bkey][0][0]) // got["layout"][0]
                with torch.no_grad():
                    out = model.train()(spec["batches"][bkey][0][0][:rows])
                _check_indices(name, got["indices"],
                               out["codevector_indices"],
                               out["codevector_distances"])
        # Each model or seq group's replicated parameters bit for bit.
        for first in range(0, world, inner):
            for r in group[first + 1:first + inner]:
                for n, p in group[first][name]["replicated"].items():
                    assert torch.equal(r[name]["replicated"][n], p), (name, n)
        kinds = set(group[0][name]["collective_bytes"])
        assert {"all-gather", "all-reduce", "broadcast"} <= kinds, (name,
                                                                   kinds)
        if name in DROPPED:               # it dropped
            assert (group[0][name]["losses"][0]
                    != group[0][DROPPED[name]]["losses"][0]), name
    for n in (2, 4):
        for r in ranks[n]:
            assert r["clip"]["clipnorm"] < 1e-6 and r["clip"]["global"] < 1e-6
            # Every collective ran over gloo on the CPU.
            assert all(k[:2] == ("gloo", "cpu") for k in r["transports"])


def test_group_norm_stats_plan_fits_the_channel_shards():
    """wav2vec2-base's GroupNorm (512 channels, 16 groups) on a channel
    shard: tp 2 gives 256 channels in 8 groups, tp 4 128 in 4; the
    moments kernel's launch plan finds a tile for both, in f32 and bf16,
    at every conv's T of a 2 s clip (132 SMs, the occupancy the kernel
    reports at base)."""
    base = Wav2Vec2Config.from_size("base")
    channels, groups = base.conv_dim[0], base.num_conv_pos_embedding_groups
    for degree in (2, 4):
        c, g = channels // degree, groups // degree
        for elem, vec in ((4, 4), (2, 8)):
            for t in (6400, 3200, 1600, 800, 400, 200, 100):
                n_ctile, cluster, n_clusters = group_norm.stats_plan(
                    32, t, c, g, vec, elem, blocks_per_sm=8, sm_count=132)
                assert g % n_ctile == 0 and cluster >= 1 and n_clusters >= 1
    norm = ReferenceGroupNorm(channels, groups)
    for degree, whole in ((2, True), (4, True), (32, False)):
        norm.tp = sharding.Shard(None, degree, 0)
        assert norm.shards_whole_groups() == whole


def test_tp_must_divide_heads_and_intermediate_size():
    cfg = Wav2Vec2Config(**TINY)
    tp.check_divides(cfg, 2)
    with pytest.raises(ValueError, match="tp=4 does not divide.*heads"):
        tp.check_divides(cfg, 4, "wav2vec2 tiny")
    bad = Wav2Vec2Config(**{**TINY, "intermediate_size": 66})
    model = w2v.Wav2Vec2ForPreTraining(bad)
    with pytest.raises(ValueError, match="intermediate_size"):
        tp.shard_model(model, mesh.Layout("model", 1, 4, 0, 0))


@pytest.mark.parametrize("flag", ["--tp", "--sp"])
def test_wav2vec2_dist_chief_and_worker_then_resume_at_tp_1(tmp_path, flag):
    """python -m tethys_tpu_torch.jobs.wav2vec2_dist --tp 2 (or --sp 2)
    --device cpu as a chief and a worker (TF_CONFIG): one model or seq
    group, the same losses on both, the whole checkpoint written by the
    chief alone; then --tp 1 --resume in the chief's workspace restores
    the --tp 2 checkpoint (Adam's counts go on)."""
    tiny = dict(TINY, conv_dim=(16,) * 5, conv_stride=(5, 4, 4, 4, 4),
                conv_kernel=(10, 3, 3, 3, 2))
    result = tmp_path / "result"
    (result / "run1").mkdir(parents=True)
    cluster = {"chief": [f"127.0.0.1:{ranks_lib.free_port()}"],
               "worker": [f"127.0.0.1:{ranks_lib.free_port()}"]}
    first, resumed = tmp_path / "first", tmp_path / "resumed"
    argvs_envs = []
    for task in ("chief", "worker"):
        ws = tmp_path / f"ws_{task}"
        ws.mkdir()
        (ws / "model.txt").write_text("run1")
        argvs_envs.append((
            ["w2v_job", str(first), "--model_size", "tiny", "--batch_size",
             "2", "--num_batches", str(STEPS), "--device", "cpu", flag, "2"],
            ranks_lib.env(TINY_W2V=json.dumps(tiny), TETHYS_WORKSPACE=str(ws),
                          TETHYS_RESULT=str(result), TF_CONFIG=json.dumps(
                              {"cluster": cluster,
                               "task": {"type": task, "index": 0}}))))
    first.mkdir()
    outs = ranks_lib.wait(ranks_lib.start(argvs_envs))
    losses = []
    for r, out in enumerate(outs):
        lines = out.splitlines()
        assert f"process group: gloo, rank {r} of 2" in lines, out
        assert "batch size per replica: 2, global batch size: 2" in lines
        losses.append([line.split("Loss: ")[1][:6] for line in lines
                       if line.startswith("Step ")])
    assert len(losses[0]) == STEPS and losses[0] == losses[1]
    whole = torch.load(first / "final.pt")
    model = w2v.Wav2Vec2ForPreTraining(Wav2Vec2Config(**tiny))
    assert {k: tuple(v.shape) for k, v in whole["params"].items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert whole["counts"] == [STEPS]
    tags = {p.name: sorted(d.name for d in (p / "checkpoints").iterdir()
                           if not d.name.startswith("."))
            for p in tmp_path.glob("ws_*")}
    assert tags == {"ws_chief": ["model_epoch_1"], "ws_worker": []}
    if flag == "--sp":
        return
    resumed.mkdir()
    (out,) = ranks_lib.wait(ranks_lib.start([(
        ["w2v_job", str(resumed), "--model_size", "tiny", "--batch_size", "2",
         "--num_batches", "1", "--device", "cpu", "--resume"],
        ranks_lib.env(TINY_W2V=json.dumps(tiny),
                      TETHYS_WORKSPACE=str(tmp_path / "ws_chief"),
                      TETHYS_RESULT=str(result)))]))
    assert "Resumed from checkpoint model_epoch_1" in out.splitlines(), out
    assert torch.load(resumed / "final.pt")["counts"] == [STEPS + 1]


def test_wav2vec2_dist_refuses_tp_with_sp(capsys):
    """--tp 2 --sp 2: the JAX parser's error, exit code 2."""
    with pytest.raises(SystemExit) as exc:
        wav2vec2_dist.main(["--tp", "2", "--sp", "2", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--tp and --sp are mutually exclusive" in capsys.readouterr().err
