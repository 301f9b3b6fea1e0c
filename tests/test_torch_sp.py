"""The port's sequence parallelism against the JAX package's, on the CPU.

Worlds of gloo processes (tests/_torch_parallel_ranks.py) laid out (data 2,
seq 2) and (data 1, seq 3), whose 32 encoder rows split unevenly (11, 11,
10); the JAX side runs ``sp.make_sp_train_step`` on a mesh of the same
shape of conftest's fake CPU devices.  Weights: the JAX model's own
(tests/test_sp.py's tiny Whisper), converted with
``convert.params_from_flax``.  2 SGD steps: losses rtol 1e-5, parameters
rtol 2e-4 / atol 1e-6 (tests/test_sp.py's tolerances).

In the (data 2, seq 2) world the same steps run with module dropout on
(dropout and activation_dropout 0.1; attention's 0, whose flash mask keeps
local coordinates as JAX's does) and equal the port's data-parallel step
over the same 2 replicas, which the test computes in one process: each
shard's dropout draws its rows of the unsharded mask.  A chief and 3
workers (TF_CONFIG) run ``whisper_dist --sp 2``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from tethys_tpu.models.whisper import create_whisper_model
from tethys_tpu.parallel import sp as jax_sp
from tethys_tpu_torch.convert import params_from_flax

import _torch_parallel_ranks as ranks_lib

TINY = dict(
    d_model=32, encoder_layers=2, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=32, vocab_size=64, max_target_positions=32,
    decoder_start_token_id=63,
)
NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
DROPOUT = dict(dropout=0.1, attention_dropout=0.0, activation_dropout=0.1)
LR = 1e-2
ROWS = 2          # per replica


def _close(got, want, rtol=2e-4, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _jax_tiny(n_rows: int):
    """tests/test_sp.py's _tiny_whisper with ``n_rows`` rows a step, 2
    steps."""
    model, config = create_whisper_model("tiny", **TINY)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((2 * n_rows, config.n_mels, 64)).astype(
        np.float32)
    labels = rng.integers(3, 60, size=(2 * n_rows, 8)).astype(np.int32)
    params = jax.device_get(model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        feats[:1], labels=labels[:1], deterministic=True)["params"])
    batches = [(feats[:n_rows], labels[:n_rows]),
               (feats[n_rows:], labels[n_rows:])]
    return model, params, batches


@pytest.mark.parametrize("world,degree", [(4, 2), (3, 3)])
def test_sp_world_matches_jax(tmp_path, world, degree):
    data = world // degree
    model, params, batches = _jax_tiny(data * ROWS)
    spec = {"config": {**TINY, **NO_DROPOUT},
            "state_dict": params_from_flax(params), "lr": LR, "seed": 0,
            "batches": [tuple(torch.from_numpy(a) for a in b)
                        for b in batches]}
    if data > 1:
        spec["dropout"] = DROPOUT
    torch.save(spec, tmp_path / "spec.pt")
    procs = ranks_lib.torchrun_world(tmp_path, world, "sp", str(degree))
    try:
        def loss_fn(p, batch, rng):
            f, l = batch
            return model.apply({"params": p}, f, labels=l,
                               deterministic=True)["loss"], {}

        opt = optax.sgd(LR)
        jmesh = jax_sp.make_seq_mesh(world, seq_parallel=degree)
        state = jax_sp.init_sp_state(params, opt, jmesh)
        step = jax_sp.make_sp_train_step(loss_fn, opt, jmesh)
        want_losses = []
        for i, (f, l) in enumerate(batches):
            state, loss = step(state, (jnp.asarray(f), jnp.asarray(l)),
                               jax.random.PRNGKey(i))
            want_losses.append(float(loss))
        want = params_from_flax(jax.device_get(state.params))
        if data > 1:
            dp_losses, dp_params = ranks_lib.port_dp(spec, data, DROPOUT)
    finally:
        ranks_lib.wait(procs)
    ranks = [torch.load(tmp_path / f"rank_{r}.pt") for r in range(world)]
    assert [r["layout"] for r in ranks] == [
        (data, degree, r // degree, r % degree) for r in range(world)]
    for r in ranks:
        _close(r["losses"], want_losses, rtol=1e-5, atol=0)
        for name, p in r["params"].items():
            _close(p, want[name], msg=name)
        if data > 1:
            _close(r["dropout_losses"], dp_losses, rtol=1e-5, atol=0)
            for name, p in r["dropout_params"].items():
                _close(p, dp_params[name], msg=name)
    # The dropout run dropped something: its losses differ from rate 0's.
    if data > 1:
        assert ranks[0]["dropout_losses"][0] != ranks[0]["losses"][0]
    # Every rank of a seq group keeps the same replica.
    for r in ranks[1:]:
        for name, p in ranks[0]["params"].items():
            assert torch.equal(r["params"][name], p), name


def test_whisper_dist_sp_chief_and_three_workers(tmp_path):
    """python -m tethys_tpu_torch.jobs.whisper_dist --sp 2 --device cpu as
    a chief and 3 workers: two data replicas of two seq ranks, the same
    losses on every rank, a checkpoint written by the chief alone."""
    tiny = {"config": {**TINY, "vocab_size": 128, "max_target_positions":
                       128, "decoder_start_token_id": 101},
            "seq_len": 64}
    outs, final = ranks_lib.cli_world(tmp_path, tiny, "--sp", "2")
    losses = []
    for r, out in enumerate(outs):
        lines = out.splitlines()
        assert f"process group: gloo, rank {r} of 4" in lines, out
        assert "batch size per replica: 2, global batch size: 4" in lines
        losses.append([line.split("Loss: ")[1][:6] for line in lines
                       if line.startswith("Step ")])
    assert len(losses[0]) == 2 and all(l == losses[0] for l in losses)
    assert all(torch.isfinite(p).all() for p in final.values())
    tags = {p.name: sorted(d.name for d in (p / "checkpoints").iterdir()
                           if not d.name.startswith("."))
            for p in tmp_path.glob("ws_*")}
    assert tags == {"ws_chief_0": ["whisper_tiny_epoch_1"], "ws_worker_0": [],
                    "ws_worker_1": [], "ws_worker_2": []}
