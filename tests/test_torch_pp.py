"""The port's pipeline parallelism against the JAX package's, on the CPU.

Two worlds of 4 gloo processes (tests/_torch_parallel_ranks.py), started
together, while the JAX side runs ``pp.make_pp_train_step`` on meshes of
the same shapes of conftest's fake CPU devices:

* world A, (data 2, stage 2): one SGD step at M = 2, at M = 4 with remat
  (2 layers a stage, real bubbles) and with grad_accum 2 equals JAX's PP
  step and JAX's DP step over the same 2 replicas; two Keras-Adam steps
  equal JAX's; each rank holds only its stage's layers and their moments
  (the twin of test_pp_stack_actually_sharded); the replicated parameters
  are bitwise equal on every rank;
* world B, (data 1, stage 4), whose middle stages both receive and send:
  one SGD step equals JAX's; with every dropout rate on, two steps equal
  the port's own in-process PP step at one stage with the same M, within
  f32 rounding (the draws are folded by (layer, microbatch), not by tick).

Weights: the JAX model's own (tests/test_pp.py's tiny Whisper with 4
encoder layers), converted with ``convert.params_from_flax``.  Tolerances
are tests/test_pp.py's: losses rtol 1e-5, parameters rtol 2e-4 / atol
1e-6.  In process: a stage split round-trips to the state dict, and the
errors of an indivisible split or batch.  A chief and 3 workers (TF_CONFIG)
run ``whisper_dist --pp 2``; its whole checkpoint resumes at ``--pp 1``
and ``--pp 2``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tethys_tpu.models.whisper import create_whisper_model
from tethys_tpu.parallel import dp as jax_dp
from tethys_tpu.parallel import pp as jax_pp
from tethys_tpu.parallel.mesh import make_data_mesh
from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.models.whisper import WhisperForConditionalGeneration
from tethys_tpu_torch.parallel import dp, mesh, pp

import _torch_parallel_ranks as ranks_lib

TINY = dict(
    d_model=32, encoder_layers=4, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=32, vocab_size=64, max_target_positions=32,
    decoder_start_token_id=63,
)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
DROPOUT = dict(dropout=0.1, attention_dropout=0.1, activation_dropout=0.1)
LR = 1e-2
ADAM_LR = 1e-3
# The key biases' gradient is zero up to rounding (a constant shift of a
# query's scores): Adam turns that noise into steps of +-lr whose sign
# differs between the two packages, so under Adam they are held to the
# size of those steps only (as tests/test_torch_dp.py leaves them out).
ROUNDING_ONLY = ("k_proj.bias",)
CASES = [
    {"name": "m2", "stages": 2, "steps": 1,
     "options": {"num_microbatches": 2}},
    {"name": "m4_remat", "stages": 2, "steps": 1,
     "options": {"num_microbatches": 4, "remat": True}},
    {"name": "accum", "stages": 2, "steps": 1,
     "options": {"num_microbatches": 2, "grad_accum": 2}},
    {"name": "adam", "stages": 2, "steps": 2, "adam": ADAM_LR,
     "options": {"num_microbatches": 2}},
    {"name": "m2", "stages": 4, "steps": 1,
     "options": {"num_microbatches": 2}},
    {"name": "dropout", "stages": 4, "steps": 2, "overrides": DROPOUT,
     "options": {"num_microbatches": 2}},
]


def _close(got, want, rtol=2e-4, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _jax_tiny():
    """tests/test_pp.py's _tiny_whisper, with a second batch of 8 rows."""
    model, config = create_whisper_model("tiny", **TINY)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((16, config.n_mels, 64)).astype(np.float32)
    labels = rng.integers(3, 60, size=(16, 8)).astype(np.int32)
    params = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        feats[:1], labels=labels[:1], deterministic=True)["params"])
    batches = [(feats[:8], labels[:8]), (feats[8:], labels[8:])]
    return model, config, params, batches


def _jax_pp(model, config, params, batches, stages, opt, steps=1, **kw):
    """JAX's PP step on make_pp_mesh(4, pipeline_parallel=stages): the
    losses and the parameters, converted."""
    jmesh = jax_pp.make_pp_mesh(4, pipeline_parallel=stages)
    state = jax_pp.init_pp_state(params, opt, jmesh, config)
    step = jax_pp.make_pp_train_step(model, opt, jmesh, state,
                                     deterministic=True, **kw)
    losses = []
    for i, (f, l) in enumerate(batches[:steps]):
        state, loss = step(state, (jnp.asarray(f), jnp.asarray(l)),
                           jax.random.PRNGKey(i))
        losses.append(float(loss))
    return losses, params_from_flax(jax_pp.unpack_params(
        jax.device_get(state.params), config.encoder_layers))


def _jax_dp(model, params, batch, grad_accum=1):
    """JAX's DP step (SGD) over 2 replicas: the loss and the parameters."""
    def loss_fn(p, b, rng):
        f, l = b
        return model.apply({"params": p}, f, labels=l,
                           deterministic=True)["loss"], {}

    opt = optax.sgd(LR)
    dmesh = make_data_mesh(2)
    state = jax_dp.replicate_state(jax_dp.TrainState(params, opt.init(params)),
                                   dmesh)
    step = jax_dp.make_train_step(loss_fn, opt, dmesh, hardened=False,
                                  grad_accum=grad_accum)
    state, loss = step(state, jax_dp.shard_batch(batch, dmesh),
                       jax.random.PRNGKey(0))
    return [float(loss)], params_from_flax(jax.device_get(state.params))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Worlds A and B, run while the JAX side computes its steps: every
    rank's results, JAX's, and the port's one-stage dropout reference."""
    model, config, params, batches = _jax_tiny()
    spec = {"config": {**TINY, **NO_DROPOUT},
            "state_dict": params_from_flax(params), "lr": LR, "seed": 0,
            "batches": [tuple(torch.from_numpy(a) for a in b)
                        for b in batches], "cases": CASES}
    dirs = {}
    procs = []
    for degree in (2, 4):
        dirs[degree] = tmp_path_factory.mktemp(f"pp{degree}")
        torch.save(spec, dirs[degree] / "spec.pt")
        procs += ranks_lib.torchrun_world(dirs[degree], 4, "pp", str(degree))
    try:
        sgd = optax.sgd(LR)
        want = {
            (2, "m2"): _jax_pp(model, config, params, batches, 2, sgd,
                               num_microbatches=2),
            (2, "m4_remat"): _jax_pp(model, config, params, batches, 2, sgd,
                                     num_microbatches=4, remat=True),
            (2, "accum"): _jax_pp(model, config, params, batches, 2, sgd,
                                  num_microbatches=2, grad_accum=2),
            (2, "adam"): _jax_pp(model, config, params, batches, 2,
                                 jax_dp.whisper_optimizer(ADAM_LR), steps=2,
                                 num_microbatches=2),
            (4, "m2"): _jax_pp(model, config, params, batches, 4, sgd,
                               num_microbatches=2),
            "dp": _jax_dp(model, params, batches[0]),
            "dp_accum": _jax_dp(model, params, batches[0], grad_accum=2),
        }
        dropout = next(c for c in CASES if c["name"] == "dropout")
        one_stage = ranks_lib.pp_train(spec, dropout, mesh.make_pp_mesh(1))
    finally:
        ranks_lib.wait(procs)
    ranks = {degree: [torch.load(d / f"rank_{r}.pt") for r in range(4)]
             for degree, d in dirs.items()}
    return ranks, want, one_stage


def _check(run, want, msg, adam_steps=0):
    _close(run["losses"], want[0], rtol=1e-5, atol=0, msg=msg)
    assert set(run["params"]) == set(want[1]), msg
    for name, p in run["params"].items():
        if adam_steps and name.endswith(ROUNDING_ONLY):
            assert (p - want[1][name]).abs().max() <= (
                2 * ADAM_LR * adam_steps), f"{msg}: {name}"
            continue
        _close(p, want[1][name], msg=f"{msg}: {name}")


@pytest.mark.parametrize("case,dp_case", [
    ("m2", "dp"), ("m4_remat", "dp"), ("accum", "dp_accum"), ("adam", None)])
def test_pp_world_a_matches_jax(worlds, case, dp_case):
    """(data 2, stage 2): every rank logs JAX's loss and holds JAX's
    parameters after the step, those of JAX's PP step and of its DP step
    (the same steps at rate 0)."""
    ranks, want, _ = worlds
    for r, out in enumerate(ranks[2]):
        assert out["layout"] == (2, 2, r // 2, r % 2)
        _check(out[case], want[(2, case)], f"rank {r} {case} (JAX PP)",
               adam_steps=2 if case == "adam" else 0)
        if dp_case:
            _check(out[case], want[dp_case], f"rank {r} {case} (JAX DP)")


def test_pp_world_a_stage_holds_its_layers_and_moments(worlds):
    """Each rank keeps its 2 of the 4 encoder layers, as local layers 0
    and 1, and Adam's moments of exactly its parameters; its step hands
    the hops and the sums their bytes."""
    ranks, _, _ = worlds
    whole = WhisperForConditionalGeneration(WhisperConfig(**TINY))
    numel = {n: p.numel() for n, p in whole.named_parameters()}
    layers = {n for n in numel if n.startswith(pp.LAYERS)}
    for r, out in enumerate(ranks[2]):
        run = out["adam"]
        local = set(run["names"])
        assert {n.split(".")[3] for n in local & layers} == {"0", "1"}, r
        assert local == (set(numel) - layers) | {
            n for n in layers if n.split(".")[3] in ("0", "1")}, r
        assert set(run["moments"]) == local, r
        for name, sizes in run["moments"].items():
            assert sizes == {"m": numel[name], "v": numel[name]}, name
        assert sum(numel[n] for n in local) == sum(numel.values()) - sum(
            numel[n] for n in layers) // 2
        # 2 microbatches of [2, 32, 32] f32 each way through one hop.
        assert run["collective_bytes"]["collective-permute"] == 2 * 2 * (
            2 * 32 * 32 * 4)
        assert run["collective_bytes"]["all-reduce"] > 0


def test_pp_world_a_replicated_parameters_bitwise_equal(worlds):
    """The replicated parameters (all but the encoder layers) have the
    same bits on every rank after each case: the stage group's sum of (g,
    0) is g, and the data group's sum is the same on both stage groups."""
    ranks, _, _ = worlds
    for case in ("m2", "m4_remat", "accum", "adam"):
        first = ranks[2][0][case]["replicated"]
        for out in ranks[2][1:]:
            for name, p in out[case]["replicated"].items():
                assert torch.equal(p, first[name]), (case, name)


def test_pp_world_b_matches_jax(worlds):
    """(data 1, stage 4), one layer a stage: JAX's PP step."""
    ranks, want, _ = worlds
    for r, out in enumerate(ranks[4]):
        assert out["layout"] == (1, 4, 0, r)
        _check(out["m2"], want[(4, "m2")], f"rank {r} (JAX PP, 4 stages)")
        # the middle stages receive and send, each way
        hops = 1 if r in (0, 3) else 2
        assert out["m2"]["collective_bytes"]["collective-permute"] == (
            hops * 2 * 2 * (4 * 32 * 32 * 4))


def test_pp_world_b_dropout_equals_one_stage(worlds):
    """Every dropout rate on, 2 steps: 4 stages equal the port's PP step
    at one stage in one process with the same M, within f32 rounding,
    and the draws dropped something."""
    ranks, want, one_stage = worlds
    for r, out in enumerate(ranks[4]):
        run = out["dropout"]
        _close(run["losses"], one_stage["losses"], rtol=1e-5, atol=0,
               msg=f"rank {r}")
        for name, p in run["params"].items():
            _close(p, one_stage["params"][name], msg=f"rank {r}: {name}")
    assert ranks[4][0]["dropout"]["losses"][0] != ranks[4][0]["m2"][
        "losses"][0]


def _tiny_torch():
    model = WhisperForConditionalGeneration(WhisperConfig(**TINY))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return model


def test_stage_split_round_trips():
    """The twin of test_pack_unpack_roundtrip: each of 4 stages keeps its
    own layer, the stages' parameters under their global names make up
    the whole state dict, and a whole state dict (and a whole Adam state)
    restores into each stage."""
    whole = _tiny_torch()
    sd = {n: t.clone() for n, t in whole.state_dict().items()}
    opt = dp.whisper_optimizer(whole.parameters(), 1e-3)
    for p in whole.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    whole_opt = opt.state_dict()
    moments = {n: opt.state[p]["m"] for n, p in whole.named_parameters()}
    seen = {}
    for s in range(4):
        layout = mesh.Layout("stage", 1, 4, 0, s)
        state = pp.init_pp_state(_tiny_torch(), lambda ps: dp.whisper_optimizer(
            ps, 1e-3), layout)
        model = state.model
        assert len(model.model.encoder.layers) == 1
        model.load_state_dict(pp.stage_params(sd, model))
        local = model.state_dict()
        for name, t in local.items():
            seen[pp.global_name(name, s)] = t
        state.optimizer.load_state_dict(pp.stage_optimizer_state(
            whole_opt, state.optimizer, model))
        for name, p in model.named_parameters():
            assert torch.equal(state.optimizer.state[p]["m"],
                               moments[pp.global_name(name, s)]), name
    assert set(seen) == set(sd)
    for name, t in sd.items():
        assert torch.equal(seen[name], t), name


@pytest.mark.parametrize("options,match", [
    (dict(stages=3), "4 encoder layers not divisible by 3 stages"),
    (dict(num_microbatches=1, grad_accum=3), "grad_accum"),
    (dict(num_microbatches=3), "num_microbatches"),
    (dict(world=4), "1 devices not divisible by pp=4"),
])
def test_pp_rejects_indivisible(options, match):
    """The twin of test_pp_grad_accum_rejects_indivisible_batch: the
    stages must divide the layers, grad_accum x num_microbatches the local
    batch (4 rows), and the stages the world."""
    model = _tiny_torch().train()
    options = dict(options)
    with pytest.raises(ValueError, match=match):
        if "world" in options:
            mesh.make_pp_mesh(options["world"])
        layout = mesh.Layout("stage", 1, options.pop("stages", 1), 0, 0)
        state = pp.init_pp_state(model, lambda ps: torch.optim.SGD(
            ps, lr=LR), layout)
        step = pp.make_pp_train_step(model, state.optimizer, layout,
                                     **options)
        step(state, (torch.zeros(4, TINY["n_mels"], 64),
                     torch.zeros(4, 8, dtype=torch.int64)),
             dp.step_generator(0, 0))


def test_whisper_dist_pp_chief_and_three_workers(tmp_path):
    """python -m tethys_tpu_torch.jobs.whisper_dist --pp 2 --device cpu as
    a chief and 3 workers, (data 2, stage 2): the same finite losses on
    every rank, a collective report with the hops, the whole model
    returned on rank 0 (JAX's gathered tree), and a whole checkpoint by
    the chief in the canonical names, which ``--pp 1 --resume`` and
    ``--pp 2 --resume`` both restore (0 steps after it: the final weights
    and the resaved Adam state equal the first run's)."""
    tiny = {"config": {**TINY, "vocab_size": 128, "max_target_positions":
                       128, "decoder_start_token_id": 101},
            "seq_len": 64}
    outs, final = ranks_lib.cli_world(tmp_path / "run", tiny, "--pp", "2")
    losses = []
    for r, out in enumerate(outs):
        lines = out.splitlines()
        assert f"process group: gloo, rank {r} of 4" in lines, out
        assert "batch size per replica: 2, global batch size: 4" in lines
        losses.append([line.split("Loss: ")[1][:6] for line in lines
                       if line.startswith("Step ")])
    assert len(losses[0]) == 2 and all(l == losses[0] for l in losses)
    assert all(np.isfinite(float(l)) for l in losses[0])
    report = (tmp_path / "run" / "result" / "run1" /
              "chief_0_collectives.txt").read_text()
    assert "collective-permute," in report and "all-reduce," in report
    ckpt = tmp_path / "run" / "ws_chief_0" / "checkpoints"
    saved = torch.load(ckpt / "whisper_tiny_epoch_1" / "model.pt")
    whole = WhisperForConditionalGeneration(WhisperConfig(
        **{**TINY, **tiny["config"]}))
    assert list(saved) == list(whole.state_dict())
    assert "model.encoder.layers.3.self_attn.q_proj.weight" in saved
    returned = torch.load(tmp_path / "run" / "returned.pt")
    assert list(returned) == list(saved)
    for name, t in final.items():
        assert torch.equal(saved[name], t), name
        assert torch.equal(returned[name], t), name
        assert returned[name].device.type == "cpu"
    adam = torch.load(ckpt / "whisper_tiny_epoch_1" / "optimizer.pt")
    for flags in (("--pp", "1"), ("--pp", "2")):
        where = tmp_path / f"resume{flags[1]}"
        outs, resumed = ranks_lib.cli_world(
            where, tiny, *flags, "--resume", "--num_batches", "0",
            checkpoints=ckpt)
        assert "Resumed from checkpoint whisper_tiny_epoch_1" in outs[0]
        for name, t in final.items():
            assert torch.equal(resumed[name], t), (flags, name)
        again = torch.load(where / "ws_chief_0" / "checkpoints" /
                           "whisper_tiny_epoch_1" / "optimizer.pt")
        assert set(again["state"]) == set(adam["state"])
        for i, entry in adam["state"].items():
            assert again["state"][i]["step"] == entry["step"]
            for k in ("m", "v"):
                assert torch.equal(again["state"][i][k], entry[k]), (flags, i)
