"""The port's data-parallel runtime against the JAX package, on the CPU.

Worlds of 2 and 4 processes over gloo on 127.0.0.1.  Each rank is this
file run as a script (``python tests/test_torch_dp.py <mode> <dir>``): it
joins the group with ``parallel/mesh.initialize_distributed`` and runs the
port's own code.
- Two ranks take 2 steps of the plain step (Whisper tiny) and of the
  hardened step (Wav2Vec2 tiny, its negatives carried in the batch so that
  they shard with it), f32, dropout 0, each on its half of the global
  batch; JAX's ``dp.make_train_step`` takes the same 2 steps on a 2-device
  mesh (conftest's fake CPU devices).  Losses, the summed gradients of the
  first step and the parameters after the second agree within 1e-4
  relative, the existing trajectory tests' tolerance.  The summed
  gradients hold the aggregation itself: a mean would halve them, and a
  reduce taken before the hardened clip would leave them a global norm of
  at most 1.
- A chief and 3 workers (TF_CONFIG) run the ``wav2vec2_dist`` CLI at a
  tiny size with ``--device cpu``, each in its own workspace, as pods
  with their own filesystems: the same losses and final parameters on
  every rank, one checkpoint tag (rank 0's), a JCT file and a collective
  report per rank; ``--resume`` restores rank 0's state on every rank.
"""

import datetime
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from tethys_tpu_torch.configs import Wav2Vec2Config, WhisperConfig
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.models.whisper import WhisperForConditionalGeneration
from tethys_tpu_torch.parallel import dp, mesh
from tethys_tpu_torch.profiling.comm import write_collective_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 150


def _rank_steps(workdir: str) -> None:
    """One rank of the 2-process step worlds: the spec's model and global
    batches, this rank's rows, 2 steps; writes its losses, the gradients
    the optimizer took at step 0 (the sum over the replicas), its final
    parameters and its collective report."""
    mesh.initialize_distributed(timeout_s=60, device="cpu")
    rank, n = mesh.rank(), mesh.world_size()
    spec = torch.load(os.path.join(workdir, "spec.pt"))
    if spec["kind"] == "whisper":
        model = WhisperForConditionalGeneration(WhisperConfig(**spec["config"]))
        optimizer = dp.whisper_optimizer(model.parameters(), spec["lr"])

        def loss_fn(m, batch, generator):
            features, labels = batch
            return m(features, labels=labels, generator=generator)["loss"], {}
    else:
        cfg = Wav2Vec2Config(**spec["config"])
        model = w2v.Wav2Vec2ForPreTraining(cfg)
        optimizer = dp.wav2vec2_optimizer(model.parameters(), spec["lr"])

        def loss_fn(m, batch, generator):
            audio, negatives = batch
            loss, aux = w2v.pretraining_loss(
                cfg, m(audio, generator=generator),
                negative_indices=negatives)
            return loss * spec["scale"], aux
    model.load_state_dict(spec["state_dict"])
    model.train()
    step = dp.make_train_step(loss_fn, optimizer,
                              hardened=spec["kind"] == "wav2vec2")
    summed, adam_step = [], optimizer.step

    def record():
        summed.append({k: p.grad.clone() for k, p in model.named_parameters()
                       if p.grad is not None})
        adam_step()

    optimizer.step = record
    state, losses = dp.TrainState(model, optimizer), []
    for i, batch in enumerate(spec["batches"]):
        rows = len(batch[0]) // n
        local = tuple(a[rank * rows:(rank + 1) * rows] for a in batch)
        state, loss = step(state, local, dp.step_generator(0, i, rank))
        losses.append(loss.item())
    write_collective_report({"all-reduce": step.reducer.bytes_per_step},
                            "worker", rank, out_dir=workdir)
    torch.save({"losses": losses, "grads": summed[0],
                "params": {k: p.detach() for k, p in
                           model.named_parameters()}},
               os.path.join(workdir, f"rank_{rank}.pt"))
    mesh.shutdown_distributed()


def _rank_job(workdir: str, *argv: str) -> None:
    """One rank of the TF_CONFIG world: the wav2vec2_dist CLI at a tiny
    size (tests/test_torch_wav2vec2_jobs.py's ``tiny_jobs``); writes its
    final parameters and Adam's counts before the job's end."""
    from tethys_tpu_torch.jobs import wav2vec2_dist
    from tethys_tpu_torch.train import jobs

    real_model, real_finalize = w2v.create_full_model, jobs.finalize_job
    tiny = json.loads(os.environ["TINY_W2V"])

    def tiny_model(model_type, model_size, **kw):
        return real_model(model_type, "tiny", **{**kw, **tiny})

    def finalize(result, *args, **kwargs):
        torch.save({"params": {k: p.detach() for k, p in
                               result.state.model.named_parameters()},
                    "counts": sorted({s["step"] for s in
                                      result.state.optimizer.state.values()})},
                   os.path.join(workdir, f"final_{mesh.rank()}.pt"))
        real_finalize(result, *args, **kwargs)

    w2v.create_full_model, jobs.finalize_job = tiny_model, finalize
    wav2vec2_dist.main(list(argv))


if __name__ == "__main__":
    # A rank of a world the tests below launch: it needs neither JAX nor
    # pytest.
    torch.set_num_threads(1)
    {"steps": _rank_steps, "job": _rank_job}[sys.argv[1]](*sys.argv[2:])
    sys.exit(0)

import jax  # noqa: E402

from tethys_tpu import data as jax_data  # noqa: E402
from tethys_tpu import losses as jax_losses  # noqa: E402
from tethys_tpu.configs import WhisperConfig as JaxWhisperConfig  # noqa: E402
from tethys_tpu.parallel import dp as jax_dp  # noqa: E402
from tethys_tpu.parallel.mesh import make_data_mesh  # noqa: E402
from tethys_tpu.profiling.hlo_comm import collective_traffic_report  # noqa: E402
from tethys_tpu_torch.convert import params_from_flax  # noqa: E402
from tethys_tpu_torch.jobs.whisper_dist import (  # noqa: E402
    build_parser as whisper_dist_parser,
)
from _torch_wav2vec2_common import AUDIO, LOG_RE, NO_DROPOUT, TINY  # noqa: E402
from _torch_wav2vec2_common import negatives as w2v_negatives  # noqa: E402
from _torch_wav2vec2_common import pair as w2v_pair  # noqa: E402
from test_torch_train import NO_DROPOUT as WHISPER_NO_DROPOUT  # noqa: E402
from test_torch_train import SEQ_LEN, _jax_init  # noqa: E402
from test_torch_train import TINY as WHISPER_TINY  # noqa: E402

TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK")
STEPS = 2
# Wav2Vec2's two parameters whose gradient is zero up to rounding (a key
# bias, project_q's LayerNorm bias): Adam turns that noise into steps of
# +-lr whose sign differs between the two packages
# (tests/test_torch_wav2vec2_jobs.py).
ROUNDING_ONLY = ("k_proj.bias", "project_q.layer_norm.bias")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in TORCHRUN_ENV + ("TF_CONFIG",)}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo", **extra)
    return env


def _start(argvs_envs) -> list:
    """One process per (argv, env), all started at once."""
    return [subprocess.Popen([sys.executable, __file__, *argv], env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for argv, env in argvs_envs]


def _wait(procs) -> list:
    """The processes' stdouts; raises with every rank's output if one
    failed or outlived TIMEOUT_S."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs):
        raise AssertionError("a rank failed:\n" + "\n----\n".join(
            f"rc={p.returncode}\n{out}" for p, out in zip(procs, outs)))
    return outs


def _torchrun_world(workdir, n: int) -> list:
    """``n`` ranks of ``_rank_steps`` from torchrun's env, started."""
    port = str(_free_port())
    return _start([(["steps", str(workdir)],
                    _env(WORLD_SIZE=str(n), RANK=str(r),
                         MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
                   for r in range(n)])


def _ranks(workdir, n: int) -> list:
    return [torch.load(os.path.join(workdir, f"rank_{r}.pt"))
            for r in range(n)]


def _close(got, want, rtol=1e-4, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _same_on_every_rank(ranks) -> None:
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        for k, p in ranks[0]["params"].items():
            assert torch.equal(r["params"][k], p), k


def _jax_two_replicas(loss_fn, optimizer, params, batches, hardened):
    """JAX's step on a 2-device mesh: the logged losses, the summed
    gradients of step 0 (``grad_aux``) and the final parameters."""
    mesh_2 = make_data_mesh(2)
    step = jax_dp.make_train_step(loss_fn, optimizer, mesh_2,
                                  hardened=hardened, return_aux=True,
                                  grad_aux_fn=lambda g: g)
    state = jax_dp.replicate_state(
        jax_dp.TrainState(params, optimizer.init(params)), mesh_2)
    losses = []
    for i, batch in enumerate(batches):
        state, loss, aux = step(state, jax_dp.shard_batch(batch, mesh_2),
                                jax.random.PRNGKey(i))
        losses.append(float(loss))
        if i == 0:
            grads = params_from_flax(jax.device_get(aux["grad_aux"]))
    return (losses, grads, params_from_flax(jax.device_get(state.params)),
            mesh_2)


def test_two_process_plain_step_matches_jax(tmp_path):
    """Whisper tiny, 2 ranks: the logged loss is the SUM of the replicas'
    losses, and the gradients are summed, as JAX's psum does."""
    lr = 1e-3
    config = JaxWhisperConfig(**WHISPER_TINY, **WHISPER_NO_DROPOUT)
    model, params = _jax_init(config)
    dataset = iter(jax_data.create_whisper_dummy_dataset(
        4, n_mels=WHISPER_TINY["n_mels"], seq_len=SEQ_LEN))
    batches = [next(dataset) for _ in range(STEPS)]
    torch.save({"kind": "whisper", "lr": lr,
                "config": {**WHISPER_TINY, **WHISPER_NO_DROPOUT},
                "state_dict": params_from_flax(jax.device_get(params)),
                "batches": [tuple(torch.from_numpy(a) for a in b)
                            for b in batches]},
               tmp_path / "spec.pt")
    world = _torchrun_world(tmp_path, 2)
    try:
        def jax_loss(p, batch, rng):
            f, l = batch
            return model.apply({"params": p}, f, labels=l,
                               deterministic=False,
                               rngs={"dropout": rng})["loss"], {}

        want_losses, want_grads, want_params, _ = _jax_two_replicas(
            jax_loss, jax_dp.whisper_optimizer(lr), params, batches, False)
    finally:
        _wait(world)
    ranks = _ranks(tmp_path, 2)
    _same_on_every_rank(ranks)
    _close(ranks[0]["losses"], want_losses, atol=0)
    assert set(ranks[0]["grads"]) == set(want_grads)
    for k, g in ranks[0]["grads"].items():
        _close(g, want_grads[k], msg=k)
    for k, p in ranks[0]["params"].items():
        _close(p, want_params[k], atol=1e-5, msg=k)


def test_two_process_hardened_step_matches_jax(tmp_path):
    """Wav2Vec2 tiny, 2 ranks, the hardened step with the loss scaled by
    50 so that each replica's clip bites: each replica's gradient is
    clipped to a global norm of 1 before the SUM, so the sum's norm lies
    in (1, 2]; the logged loss is the SUM of the replicas' losses / N.
    The collective report's total is what JAX's compiled step
    all-reduces, less the parameters that take no gradient."""
    lr, scale = 1e-3, 50.0
    jmodel, params, port, cfg = w2v_pair("pretraining")
    dataset = iter(jax_data.create_wav2vec2_dummy_dataset(
        4, audio_length=AUDIO))
    batches = [(next(dataset)[0], w2v_negatives(cfg, batch=4, seed=9 + i))
               for i in range(STEPS)]
    torch.save({"kind": "wav2vec2", "lr": lr, "scale": scale,
                "config": {**TINY, **NO_DROPOUT},
                "state_dict": port.state_dict(),
                "batches": [tuple(torch.from_numpy(a) for a in b)
                            for b in batches]},
               tmp_path / "spec.pt")
    world = _torchrun_world(tmp_path, 2)
    try:
        def jax_loss(p, batch, rng):
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
            return loss * scale, {}

        optimizer = jax_dp.wav2vec2_optimizer(lr)
        want_losses, want_grads, want_params, mesh_2 = _jax_two_replicas(
            jax_loss, optimizer, params, batches, True)
    finally:
        _wait(world)
    ranks = _ranks(tmp_path, 2)
    _same_on_every_rank(ranks)
    _close(ranks[0]["losses"], want_losses, atol=0)
    grads = ranks[0]["grads"]
    norm = torch.linalg.vector_norm(
        torch.stack([g.norm() for g in grads.values()])).item()
    assert 1.0 + 1e-3 < norm <= 2.0 + 1e-5, norm
    for k, g in grads.items():
        _close(g, want_grads[k], msg=k)
    for k, p in ranks[0]["params"].items():
        if not k.endswith(ROUNDING_ONLY):
            _close(p, want_params[k], atol=1e-5, msg=k)

    # The collective report against the JAX step's compiled HLO (the
    # production step: no aux).  JAX all-reduces every parameter's
    # gradient, a zero one too; the port leaves out the parameters that
    # take none (the frozen codevectors and the quantizer's projection,
    # behind the argmin), so the two totals differ by exactly their bytes.
    jstep = jax_dp.make_train_step(jax_loss, optimizer, mesh_2, hardened=True)
    jstate = jax_dp.replicate_state(
        jax_dp.TrainState(params, optimizer.init(params)), mesh_2)
    hlo = jstep.lower(jstate, jax_dp.shard_batch(batches[0], mesh_2),
                      jax.random.PRNGKey(0)).compile().as_text()
    jax_total = collective_traffic_report(hlo)["total_bytes"]
    reports = []
    for r in range(2):
        with open(tmp_path / f"worker_{r}_collectives.txt") as fh:
            reports.append(fh.read().splitlines())
    assert reports[0] == reports[1]
    assert reports[0][0] == "kind,bytes_per_step"
    assert reports[0][1].startswith("all-reduce,")
    total = int(reports[0][-1].split(",")[1])
    no_grad = {k: p for k, p in port.named_parameters() if k not in grads}
    assert sorted(no_grad) == [
        "wav2vec2.quantizer.codevectors",
        "wav2vec2.quantizer.project_to_codevector_dim.bias",
        "wav2vec2.quantizer.project_to_codevector_dim.weight"]
    grad_bytes = 4 * sum(g.numel() for g in grads.values())
    assert total == grad_bytes + 4                      # buckets + the loss
    assert jax_total - total == 4 * sum(p.numel() for p in no_grad.values())


def test_tf_config_chief_and_three_workers_run_the_cli(tmp_path):
    """python -m tethys_tpu_torch.jobs.wav2vec2_dist --device cpu as a
    chief and 3 workers from TF_CONFIG, each in its own workspace; then
    the same world with --resume."""
    tiny = dict(TINY, conv_dim=(16,) * 5, conv_stride=(5, 4, 4, 4, 4),
                conv_kernel=(10, 3, 3, 3, 2))
    tasks = [("chief", 0)] + [("worker", i) for i in range(3)]
    result = tmp_path / "result"
    (result / "run1").mkdir(parents=True)

    def world(workdir, *flags):
        workdir.mkdir()
        cluster = {"chief": [f"127.0.0.1:{_free_port()}"],
                   "worker": [f"127.0.0.1:{_free_port()}" for _ in range(3)]}
        argvs_envs = []
        for task, index in tasks:
            ws = tmp_path / f"ws_{task}_{index}"
            ws.mkdir(exist_ok=True)
            (ws / "model.txt").write_text("run1")
            argvs_envs.append((
                ["job", str(workdir), "--model_size", "tiny", "--batch_size",
                 "2", "--num_batches", "2", "--device", "cpu", *flags],
                _env(TINY_W2V=json.dumps(tiny), TETHYS_WORKSPACE=str(ws),
                     TETHYS_RESULT=str(result), TF_CONFIG=json.dumps(
                         {"cluster": cluster,
                          "task": {"type": task, "index": index}}))))
        outs = _wait(_start(argvs_envs))
        finals = [torch.load(workdir / f"final_{r}.pt") for r in range(4)]
        for r, out in enumerate(outs):
            lines = out.splitlines()
            assert f"process group: gloo, rank {r} of 4" in lines
            assert "batch size per replica: 2, global batch size: 8" in lines
            assert len(LOG_RE.findall(out)) == 2
            assert "Error at step" not in out
        losses = [re.findall(r"Loss: (-?\d+\.\d+)", out) for out in outs]
        assert all(l == losses[0] for l in losses)
        for f in finals[1:]:
            for k, p in finals[0]["params"].items():
                assert torch.equal(f["params"][k], p), k
        return outs, finals

    world(tmp_path / "first")
    tags = {f"{task}_{index}": sorted(
        d for d in os.listdir(tmp_path / f"ws_{task}_{index}" / "checkpoints")
        if not d.startswith(".")) for task, index in tasks}
    assert tags == {"chief_0": ["model_epoch_1"], "worker_0": [],
                    "worker_1": [], "worker_2": []}
    assert [t for t, i in tasks
            if (tmp_path / f"ws_{t}_{i}" / "model_cache").exists()] == [
                "chief"]
    names = sorted(os.listdir(result / "run1"))
    assert names == sorted([f"{t}_{i}_{kind}.txt" for t, i in tasks
                            for kind in ("collectives", "jct")])

    outs, finals = world(tmp_path / "resumed", "--resume")
    for out in outs:
        assert "Resumed from checkpoint model_epoch_1" in out.splitlines()
    assert all(f["counts"] == [2 * STEPS] for f in finals)


def test_initialize_distributed_precedence(monkeypatch):
    """torchrun's env first, then a TF_CONFIG that names several
    processes (the chief's address, chief first), else no group; nccl and
    the local rank's card for a job on the card, gloo on the CPU; the
    120 s timeout."""
    calls, cards = [], []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    monkeypatch.setattr(torch.cuda, "set_device", cards.append)
    for name in TORCHRUN_ENV + ("TF_CONFIG",):
        monkeypatch.delenv(name, raising=False)
    mesh.initialize_distributed(device="cpu")
    one = {"cluster": {"worker": ["127.0.0.1:1"]},
           "task": {"type": "worker", "index": 0}}
    monkeypatch.setenv("TF_CONFIG", json.dumps(one))
    mesh.initialize_distributed(device="cpu")
    assert calls == []
    two = {"cluster": {"worker": ["w:2"], "chief": ["c:1"]},
           "task": {"type": "worker", "index": 0}}
    monkeypatch.setenv("TF_CONFIG", json.dumps(two))
    mesh.initialize_distributed(device="cpu")
    minutes = datetime.timedelta(seconds=120)
    assert calls.pop() == ("gloo", dict(init_method="tcp://c:1",
                                        world_size=2, rank=1,
                                        timeout=minutes))
    for name, value in (("WORLD_SIZE", "4"), ("RANK", "3"),
                        ("MASTER_ADDR", "h"), ("MASTER_PORT", "5"),
                        ("LOCAL_RANK", "3")):
        monkeypatch.setenv(name, value)
    mesh.initialize_distributed(timeout_s=7)
    assert calls.pop() == ("nccl", dict(
        init_method="env://", timeout=datetime.timedelta(seconds=7)))
    assert cards == [3] and mesh.local_rank() == 3
    assert not mesh.group_up()


def test_initialize_distributed_is_idempotent_and_one_rank_is_the_identity(
        monkeypatch):
    """A world of one from torchrun's env: a second call keeps the group;
    rank, size and backend; and the step with the group (buckets and a SUM
    over one rank) equals the step without, bit for bit."""
    for name, value in (("WORLD_SIZE", "1"), ("RANK", "0"),
                        ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(name, value)
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")

    def two_steps():
        _, _, port, cfg = w2v_pair("pretraining")
        optimizer = dp.wav2vec2_optimizer(port.parameters(), 1e-3)
        neg = torch.from_numpy(w2v_negatives(cfg))

        def loss_fn(m, audio, generator):
            loss, aux = w2v.pretraining_loss(cfg, m(audio, generator=generator),
                                             negative_indices=neg)
            return loss * 50.0, aux

        step = dp.make_train_step(loss_fn, optimizer, hardened=True)
        state, losses = dp.TrainState(port, optimizer), []
        audio = np.random.default_rng(0).standard_normal(
            (STEPS, 2, AUDIO)).astype(np.float32)
        for i in range(STEPS):
            state, loss = step(state, torch.from_numpy(audio[i]),
                               dp.step_generator(0, i))
            losses.append(loss.item())
        return step, losses, dict(port.named_parameters())

    alone, want_losses, want = two_steps()
    assert alone.reducer is None
    try:
        mesh.initialize_distributed(device="cpu")
        group = torch.distributed.group.WORLD
        mesh.initialize_distributed(device="cpu")
        assert torch.distributed.group.WORLD is group
        assert (mesh.group_up(), mesh.rank(), mesh.world_size()) == (
            True, 0, 1)
        assert torch.distributed.get_backend() == "gloo"
        grouped, losses, got = two_steps()
        assert grouped.reducer.bytes_per_step > 0
    finally:
        mesh.shutdown_distributed()
    assert not mesh.group_up()
    assert losses == want_losses
    for k, p in want.items():
        assert torch.equal(got[k], p), k


def test_replica_zero_keeps_the_one_process_generator():
    """step_generator(seed, step) draws what it drew before the replica
    argument existed (pinned), so every trajectory and resume test keeps
    its numbers; other replicas draw their own, each a function of (seed,
    step, replica)."""
    def draw(*args):
        return torch.randint(0, 2 ** 31 - 1, (3,),
                             generator=dp.step_generator(*args)).tolist()

    assert draw(0, 0) == draw(0, 0, 0) == [133204207, 2036640790, 426728693]
    assert draw(42, 3) == [857018914, 146491182, 721923060]
    assert draw(7, 123456) == [932972906, 2028135069, 601954652]
    assert draw(42, 3, 1) == draw(42, 3, 1)
    assert len({tuple(draw(42, 3, r)) for r in range(8)}) == 8
    assert len({tuple(draw(s, i, r)) for s in (0, 42) for i in range(3)
                for r in range(3)}) == 18


@pytest.mark.parametrize("rank", [0, 1])
def test_rank_zero_builds_the_kernels_before_the_others(monkeypatch, rank):
    """A job on the card in a world of several ranks: rank 0 builds the
    kernel library, then every rank meets at a barrier, so the others load
    what rank 0 built instead of each running nvcc."""
    from tethys_tpu_torch.jobs import _common
    from tethys_tpu_torch.utils import device, kernel_lib

    seen = []
    monkeypatch.setattr(device, "require_cuda", lambda: "cuda:0")
    monkeypatch.setattr(kernel_lib, "build", lambda: seen.append("build"))
    monkeypatch.setattr(mesh, "world_size", lambda: 2)
    monkeypatch.setattr(mesh, "rank", lambda: rank)
    monkeypatch.setattr(mesh, "barrier", lambda: seen.append("barrier"))
    args = whisper_dist_parser().parse_args(["--device", "cuda"])
    assert _common.job_device(args) == "cuda:0"
    assert seen == (["build", "barrier"] if rank == 0 else ["barrier"])
    assert _common.job_device(
        whisper_dist_parser().parse_args(["--device", "cpu"])) == "cpu"
