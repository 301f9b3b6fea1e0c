"""Tensor and sequence parallelism on Wav2Vec2's stacked ``scan_layers``
layout, the port against the JAX package, on the CPU.

Two gloo worlds (tests/_torch_parallel_ranks.py's ``w2v`` ranks, each case
with ``scan_layers``), of 2 and of 4 processes, run side by side, as in
tests/test_torch_w2v_parallel.py, whose set-up this file shares: the tiny
config, JAX's own weights (stacked by the rank, ``stack_layer_params``),
numpy-seeded audio with fixed negatives, 2 hardened steps with
``wav2vec2_optimizer`` and the loss scaled by 50.  The JAX side runs its
scanned model on the stacked tree (``jax_w2v.stack_layer_params``) on
conftest's fake CPU devices:

* scanned TP over (data 2, model 2) against JAX's ``make_tp_train_step``;
  over (data 1, model 2) against JAX's one-replica hardened step (JAX's TP
  step does not compile at data 1);
* scanned SP over (data 2, seq 2) and over (data 1, seq 2) on 21 frames
  against JAX's ``make_sp_train_step``;
* scanned TP and SP over 2 ranks with every dropout rate 0.1 against one
  scanned port process;
* the scanned TP and SP steps' first gradients, as the global clip takes
  them (after the group's sums), unstacked, against the unrolled steps'
  in the same world;
* the whole checkpoint of the scanned (data 1, model 2) run restored into
  a scanned one-process model and its optimizer, and its flax tree against
  JAX's stacked parameters after the same steps.

Tolerances are test_torch_w2v_parallel.py's: losses 1e-5 relative,
parameters rtol 2e-4 / atol 1e-6 (the two parameters whose true gradient
is 0, ``ROUNDING_ONLY``, left out); the quantizer's first indices equal
one unsharded process's but at a tie; the replicated parameters bit for bit
across a model or seq group.
"""

import jax
import numpy as np
import pytest
import torch

from tethys_tpu.models import wav2vec2 as jax_w2v
from tethys_tpu_torch import convert
from tethys_tpu_torch.configs import Wav2Vec2Config
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.parallel import dp

import _torch_parallel_ranks as ranks_lib
from _torch_wav2vec2_common import AUDIO, NO_DROPOUT, TINY, configs, pair
from test_torch_w2v_parallel import (
    DROPOUT,
    LR,
    ODD_AUDIO,
    ROUNDING_ONLY,
    SCALE,
    SEED,
    _batches,
    _check_indices,
    _close,
    _jax_steps,
)

FIELDS = ("name", "world", "axis", "inner", "batches", "overrides",
          "options", "scan_layers")
GRADS = {"grads": True}
# FIELDS; the scanned cases with dropout are held to one scanned port
# process, the other scanned ones to JAX's scanned steps, the unrolled ones
# only give the first gradients the scanned ones are held to.
CASES = [
    ("scan_tp_1x2", 2, "model", 2, "even_2", {},
     {"grads": True, "whole": True}, True),
    ("scan_sp_1x2_odd", 2, "seq", 2, "odd_2", {}, GRADS, True),
    ("scan_tp_1x2_dropout", 2, "model", 2, "even_2", DROPOUT, {}, True),
    ("scan_sp_1x2_dropout", 2, "seq", 2, "odd_2", DROPOUT, {}, True),
    ("unrolled_tp_1x2", 2, "model", 2, "even_2", {}, GRADS, False),
    ("unrolled_sp_1x2_odd", 2, "seq", 2, "odd_2", {}, GRADS, False),
    ("scan_tp_2x2", 4, "model", 2, "even_4", {}, {}, True),
    ("scan_sp_2x2", 4, "seq", 2, "even_4", {}, {}, True),
]
SCANNED = [c[0] for c in CASES if c[-1]]
# Each scanned case whose first gradients are held to an unrolled one's.
TWINS = {"scan_tp_1x2": "unrolled_tp_1x2",
         "scan_sp_1x2_odd": "unrolled_sp_1x2_odd"}


def _scanned_jax(params):
    """JAX's scanned pretraining model at the tiny config and its stacked
    parameters."""
    jcfg, _ = configs(scan_layers=True)
    return (jax_w2v.Wav2Vec2ForPreTraining(jcfg),
            jax_w2v.stack_layer_params(jax.device_get(params)))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results and the references: {case: (losses, params)}."""
    tmp = tmp_path_factory.mktemp("scan_parallel")
    _, params, port, cfg = pair("pretraining")
    config = {**TINY, **NO_DROPOUT}
    state_dict = port.state_dict()
    batches = {"even_2": _batches(2, AUDIO, cfg, 1),
               "even_4": _batches(4, AUDIO, cfg, 2),
               "odd_2": _batches(2, ODD_AUDIO, cfg, 3)}
    spec = {"lr": LR, "scale": SCALE, "seed": SEED,
            "configs": {"tiny": config}, "state_dicts": {"tiny": state_dict},
            "batches": {k: [tuple(torch.from_numpy(a) for a in b) for b in v]
                        for k, v in batches.items()},
            "cases": [dict(zip(FIELDS, c), config="tiny") for c in CASES]}
    dirs = {n: tmp / f"world_{n}" for n in (2, 4)}
    started = []
    for n, d in dirs.items():
        d.mkdir()
        torch.save(spec, d / "spec.pt")
        started.append(ranks_lib.torchrun_world(d, n, "w2v"))
    jmodel, stacked = _scanned_jax(params)
    want = {}
    try:
        for case in CASES:
            name, world, axis, inner, bkey, overrides, _, scan = case
            if not scan:
                continue
            if overrides:            # one scanned port process
                one = ranks_lib.w2v_steps(
                    spec, dict(zip(FIELDS, case), config="tiny",
                               options={}), None)
                want[name] = one["losses"], one["params"]
            else:
                want[name] = _jax_steps(jmodel, cfg, stacked, batches[bkey],
                                        axis, world, inner)
    finally:
        for w in started:
            ranks_lib.wait(w)
    ranks = {n: [torch.load(d / f"rank_{r}.pt") for r in range(n)]
             for n, d in dirs.items()}
    return {"spec": spec, "want": want, "ranks": ranks, "cfg": cfg}


def _world(case):
    return [c for c in CASES if c[0] == case][0]


@pytest.mark.parametrize("name", SCANNED)
def test_scanned_steps_match(worlds, name):
    """Every rank's losses and whole parameters against JAX's scanned step
    (or one scanned port process), the layout, the quantizer's first
    indices, and the replicated parameters bit for bit in each group."""
    _, world, axis, inner, bkey, overrides, _, _ = _world(name)
    want_losses, want_params = worlds["want"][name]
    group = worlds["ranks"][world]
    spec = worlds["spec"]
    for r, rank in enumerate(group):
        got = rank[name]
        assert got["layout"] == (world // inner, inner, r // inner,
                                 r % inner), name
        _close(got["losses"], want_losses, rtol=1e-5, atol=0, msg=name)
        assert set(got["params"]) == set(want_params), name
        assert "wav2vec2.encoder.layers.attention.q_proj.weight" in want_params
        for n, p in want_params.items():
            if not n.endswith(ROUNDING_ONLY):
                _close(got["params"][n], p, msg=f"{name} {n}")
        if got["layout"][2] == 0 and not overrides:
            # The first indices against one unsharded scanned process on
            # the first replica's rows.
            model = w2v.Wav2Vec2ForPreTraining(Wav2Vec2Config(
                **spec["configs"]["tiny"], scan_layers=True))
            model.load_state_dict(w2v.stack_layer_params(
                spec["state_dicts"]["tiny"]))
            audio = spec["batches"][bkey][0][0]
            with torch.no_grad():
                out = model.train()(audio[:len(audio) // got["layout"][0]])
            _check_indices(name, got["indices"], out["codevector_indices"],
                           out["codevector_distances"])
    for first in range(0, world, inner):
        for rank in group[first + 1:first + inner]:
            for n, p in group[first][name]["replicated"].items():
                assert torch.equal(rank[name]["replicated"][n], p), (name, n)
    kinds = set(group[0][name]["collective_bytes"])
    assert {"all-gather", "all-reduce", "broadcast"} <= kinds, (name, kinds)
    if overrides:                            # it dropped
        twin = name.replace("_dropout", "" if axis == "model" else "_odd")
        assert group[0][name]["losses"][0] != group[0][twin]["losses"][0]


@pytest.mark.parametrize("name", sorted(TWINS))
def test_scanned_first_gradients_equal_unrolled(worlds, name):
    """The first gradients the global clip takes, whole and unstacked, of
    the scanned step and of the unrolled step in the same world: the
    stacked gradient is one ``stack`` of the layer slices' (bit for bit)."""
    for rank in worlds["ranks"][2]:
        got, want = rank[name]["grads"], rank[TWINS[name]]["grads"]
        assert list(got) == list(want), name
        for n, g in want.items():
            assert torch.equal(got[n], g), (name, n)


def test_scanned_tp_checkpoint_restores_into_one_process(worlds):
    """The scanned (data 1, model 2) run's whole checkpoint, written on rank
    0 (``whole_state_dicts``): the canonical stacked names and shapes of a
    scanned model, loaded by a scanned one-process model and its Keras Adam
    (each moment whole), equal to what the ranks gathered; its flax tree
    JAX's stacked tree, within the steps' tolerances of JAX's parameters
    after the same steps."""
    params, opt_state = worlds["ranks"][2][0]["scan_tp_1x2"]["whole"]
    assert worlds["ranks"][2][1]["scan_tp_1x2"]["whole"] is None
    model = w2v.Wav2Vec2ForPreTraining(Wav2Vec2Config(
        **worlds["spec"]["configs"]["tiny"], scan_layers=True))
    model.load_state_dict(params)
    gathered = worlds["ranks"][2][0]["scan_tp_1x2"]["params"]
    for n, p in model.state_dict().items():
        assert torch.equal(p, gathered[n]), n
    optimizer = dp.wav2vec2_optimizer(model.parameters(), LR)
    optimizer.load_state_dict(opt_state)
    names = dict(model.named_parameters())
    for p, state in optimizer.state.items():
        assert state["step"] == 2
        assert state["m"].shape == state["v"].shape == p.shape
    assert len(optimizer.state) == sum(p.requires_grad and "quantizer."
                                       not in n for n, p in names.items())
    tree = convert.flax_from_state_dict(params)
    want = convert.flax_from_state_dict(worlds["want"]["scan_tp_1x2"][1])
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_equal(
        np.shape(a), np.shape(b)), tree, want)
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    wanted = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    for path, leaf in leaves:
        name = "/".join(k.key for k in path)
        if name.endswith(("k_proj/bias", "project_q/layer_norm/bias")):
            continue
        _close(leaf, wanted[path], msg=name)
