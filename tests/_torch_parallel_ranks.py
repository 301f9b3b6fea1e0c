"""The ranks of the tensor-, sequence- and pipeline-parallel worlds of
tests/test_torch_tp.py, tests/test_torch_sp.py,
tests/test_torch_w2v_parallel.py, tests/test_torch_scan_parallel.py and
tests/test_torch_pp.py, of the flat
optimizer's world of tests/test_torch_flat.py, and the
helpers that start them (gloo on 127.0.0.1, torchrun's env or a
TF_CONFIG).

A rank is this file run as a script, ``python tests/_torch_parallel_ranks.py
<mode> <dir> ...``: it joins the group with ``parallel/mesh.
initialize_distributed`` and runs the port's own code on the spec the test
wrote to ``<dir>/spec.pt`` (a tiny Whisper or Wav2Vec2 config, the JAX
model's weights converted to the port, the global batches), then writes
what it saw to ``<dir>/rank_<r>.pt``.  It needs neither JAX nor pytest.
"""

import json
import os
import socket
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tethys_tpu_torch.checkpoint import CheckpointManager  # noqa: E402
from tethys_tpu_torch.configs import Wav2Vec2Config, WhisperConfig  # noqa: E402
from tethys_tpu_torch.models import wav2vec2 as w2v  # noqa: E402
from tethys_tpu_torch.models.whisper import (  # noqa: E402
    WhisperForConditionalGeneration,
    greedy_generate,
)
from tethys_tpu_torch.ops import sharding  # noqa: E402
from tethys_tpu_torch.parallel import (  # noqa: E402
    dp,
    flat,
    mesh,
    pp,
    sp,
    tp,
)

TIMEOUT_S = 180
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT",
                "LOCAL_RANK")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def env(**extra) -> dict:
    out = {k: v for k, v in os.environ.items()
           if k not in TORCHRUN_ENV + ("TF_CONFIG",)}
    out.update(PYTHONPATH=REPO + os.pathsep + out.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo", **extra)
    return out


def start(argvs_envs) -> list:
    """One rank process per (argv, env), all started at once."""
    return [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                              *argv], env=e, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for argv, e in argvs_envs]


def wait(procs) -> list:
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


def torchrun_world(workdir, n: int, *argv: str) -> list:
    """``n`` ranks of ``<argv[0]> <workdir> <argv[1:]>`` from torchrun's
    env, started."""
    port = str(free_port())
    return start([([argv[0], str(workdir), *argv[1:]],
                   env(WORLD_SIZE=str(n), RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=port))
                  for r in range(n)])


def cli_world(tmp_path, tiny: dict, *flags: str, checkpoints=None):
    """python -m tethys_tpu_torch.jobs.whisper_dist --device cpu as a chief
    and 3 workers from TF_CONFIG, each in its own workspace, with the tiny
    config ``tiny`` ({"config": ..., "seq_len": ...}): their stdouts and
    the whole final parameters rank 0 saw.  ``checkpoints``: a directory
    of checkpoints copied into the chief's workspace first."""
    import shutil

    tasks = [("chief", 0)] + [("worker", i) for i in range(3)]
    result = tmp_path / "result"
    (result / "run1").mkdir(parents=True)
    cluster = {"chief": [f"127.0.0.1:{free_port()}"],
               "worker": [f"127.0.0.1:{free_port()}" for _ in range(3)]}
    argvs_envs = []
    for task, index in tasks:
        ws = tmp_path / f"ws_{task}_{index}"
        ws.mkdir()
        (ws / "model.txt").write_text("run1")
        if checkpoints is not None and task == "chief":
            shutil.copytree(checkpoints, ws / "checkpoints")
        argvs_envs.append((
            ["job", str(tmp_path), "--model_size", "tiny", "--batch_size",
             "2", "--num_batches", "2", "--device", "cpu", *flags],
            env(TINY_WHISPER=json.dumps(tiny), TETHYS_WORKSPACE=str(ws),
                TETHYS_RESULT=str(result), TF_CONFIG=json.dumps(
                    {"cluster": cluster,
                     "task": {"type": task, "index": index}}))))
    outs = wait(start(argvs_envs))
    return outs, torch.load(tmp_path / "final.pt")


def loss_fn(model, batch, generator):
    features, labels = batch
    return model(features, labels=labels, generator=generator)["loss"], {}


def build(spec, layout, **overrides):
    """The spec's model with ``overrides``, its weights loaded, sharded
    over the layout's model group (tensor parallelism; no layout: whole)."""
    model = WhisperForConditionalGeneration(
        WhisperConfig(**{**spec["config"], **overrides}))
    model.load_state_dict(spec["state_dict"])
    if layout is not None and layout.axis == "model":
        tp.shard_model(model, layout)
    return model


def train(spec, layout, optimizer=None, **overrides):
    """The spec's batches, one step each over the layout (SGD at the spec's
    rate unless ``optimizer`` makes another): the logged losses and the
    state."""
    model = build(spec, None, **overrides)   # init_tp_state shards it
    model.train()
    make = optimizer or (lambda ps: torch.optim.SGD(ps, lr=spec["lr"]))
    if layout.axis == "model":     # the model is sharded already
        state = tp.init_tp_state(model, make, layout)
        step = tp.make_tp_train_step(loss_fn, state.optimizer, layout)
    else:
        state = sp.init_sp_state(model, make(model.parameters()), layout)
        step = sp.make_sp_train_step(loss_fn, state.optimizer, layout)
    losses = []
    for i, (features, labels) in enumerate(spec["batches"]):
        rows = len(features) // layout.data
        mine = slice(layout.data_rank * rows, (layout.data_rank + 1) * rows)
        state, loss = step(state, (features[mine], labels[mine]),
                           dp.step_generator(spec["seed"], i,
                                             layout.data_rank))
        losses.append(loss.item())
    return losses, state


def port_dp(spec, replicas: int, overrides):
    """The port's data-parallel step over ``replicas`` replicas, in one
    process: each replica's loss and gradient with its own generator, the
    two summed (as GradientReducer sums them), then SGD."""
    model = WhisperForConditionalGeneration(
        WhisperConfig(**{**spec["config"], **overrides}))
    model.load_state_dict(spec["state_dict"])
    model.train()
    opt = torch.optim.SGD(model.parameters(), lr=spec["lr"])
    losses = []
    for i, (features, labels) in enumerate(spec["batches"]):
        opt.zero_grad(set_to_none=True)
        rows, total = len(features) // replicas, 0.0
        for r in range(replicas):
            mine = slice(r * rows, (r + 1) * rows)
            loss, _ = loss_fn(model, (features[mine], labels[mine]),
                              dp.step_generator(spec["seed"], i, r))
            loss.backward()
            total += loss.item()
        opt.step()
        losses.append(total)
    return losses, {k: v.detach() for k, v in model.state_dict().items()}


def _whole(state):
    """The whole parameters of a state (gathered under tensor
    parallelism)."""
    if state.layout.axis == "model":
        return tp.gather_params(state.model, state.layout)
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def rank_tp(workdir: str) -> None:
    """A rank of the (data 2, model 2) world: its shard shapes, greedy
    tokens, 2 SGD steps plain, under remat_layers and with the spec's
    dropout rates (attention's 0), one Keras-Adam step
    from the plain state, checkpointed, then tokens and steps with the
    fused projections (TETHYS_FUSED_QKV=1)."""
    mesh.initialize_distributed(timeout_s=60, device="cpu")
    spec = torch.load(os.path.join(workdir, "spec.pt"))
    layout = mesh.make_2d_mesh(model_parallel=2)
    model = build(spec, layout).eval()
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    tokens, length = greedy_generate(model, spec["generate"],
                                     max_length=spec["max_length"])
    losses, state = train(spec, layout)
    remat_losses, remat_state = train(spec, layout, remat_layers=True)
    dropout_losses, dropped = train(spec, layout, **spec["dropout"])
    out = {"shapes": shapes, "tokens": tokens, "length": int(length),
           "losses": losses, "params": _whole(state),
           "remat_losses": remat_losses, "remat_params": _whole(remat_state),
           "dropout_losses": dropout_losses, "dropout_params": _whole(dropped),
           "layout": (layout.data, layout.inner, layout.data_rank,
                      layout.inner_rank)}

    _, adam = train(spec, layout, optimizer=lambda ps: dp.whisper_optimizer(
        ps, 1e-3))
    names = {id(p): n for n, p in adam.model.named_parameters()}
    out["adam_params"] = _whole(adam)
    out["adam_m"] = {names[id(p)]: s["m"].clone()
                     for p, s in adam.optimizer.state.items()}
    CheckpointManager(os.path.join(workdir, "ckpt")).save(
        "whisper_tiny_epoch_1", adam)

    # The fused projections (ops/qkv.py's ProjectSplit / MergeProject) on
    # this rank's heads.
    os.environ["TETHYS_FUSED_QKV"] = "1"
    try:
        out["fused_tokens"] = greedy_generate(
            build(spec, layout).eval(), spec["generate"],
            max_length=spec["max_length"])[0]
        out["fused_losses"], fused = train(spec, layout)
        out["fused_params"] = _whole(fused)
    finally:
        del os.environ["TETHYS_FUSED_QKV"]
    out["transports"] = dict(sharding.TRANSPORTS)
    torch.save(out, os.path.join(workdir, f"rank_{mesh.rank()}.pt"))
    mesh.shutdown_distributed()


def rank_sp(workdir: str, degree: str) -> None:
    """A rank of a (data, seq) world: 2 SGD steps with every dropout rate
    0, and with the spec's dropout rates (attention's 0)."""
    mesh.initialize_distributed(timeout_s=60, device="cpu")
    spec = torch.load(os.path.join(workdir, "spec.pt"))
    layout = mesh.make_seq_mesh(seq_parallel=int(degree))
    losses, state = train(spec, layout)
    out = {"losses": losses, "params": _whole(state),
           "layout": (layout.data, layout.inner, layout.data_rank,
                      layout.inner_rank)}
    if spec.get("dropout"):
        out["dropout_losses"], dropped = train(spec, layout,
                                               **spec["dropout"])
        out["dropout_params"] = _whole(dropped)
    out["transports"] = dict(sharding.TRANSPORTS)
    torch.save(out, os.path.join(workdir, f"rank_{mesh.rank()}.pt"))
    mesh.shutdown_distributed()


def pp_train(spec, case, layout):
    """The spec's tiny Whisper with the case's rate overrides, split over
    the (data, stage) layout (a one-rank layout: the whole model), the
    case's PP step (SGD at the spec's rate, or Keras Adam at "adam"'s) on
    the case's first ``steps`` global batches (this replica's rows): the
    logged losses, the whole parameters, this rank's replicated parameters
    and its own names, its optimizer's moments' names and sizes and the
    step's collective bytes."""
    model = build(spec, None, **case.get("overrides", {}))
    model.train()
    lr = case.get("adam")
    state = pp.init_pp_state(
        model, (lambda ps: dp.whisper_optimizer(ps, lr)) if lr else
        (lambda ps: torch.optim.SGD(ps, lr=spec["lr"])), layout)
    step = pp.make_pp_train_step(model, state.optimizer, layout,
                                 **case["options"])
    losses = []
    for i, (features, labels) in enumerate(spec["batches"][:case["steps"]]):
        rows = len(features) // layout.data
        mine = slice(layout.data_rank * rows, (layout.data_rank + 1) * rows)
        state, loss = step(state, (features[mine], labels[mine]),
                           dp.step_generator(spec["seed"], i,
                                             layout.data_rank))
        losses.append(loss.item())
    names = {id(p): n for n, p in model.named_parameters()}
    return {"losses": losses,
            "params": pp.gather_params(model, layout),
            "replicated": {n: p.detach().clone()
                           for n, p in model.named_parameters()
                           if not n.startswith(pp.LAYERS)},
            "names": [n for n, _ in model.named_parameters()],
            "moments": {names[id(p)]: {k: v.numel() for k, v in s.items()
                                       if torch.is_tensor(v) and v.dim()}
                        for p, s in state.optimizer.state.items()},
            "collective_bytes": dict(step.collective_bytes)}


def rank_pp(workdir: str, degree: str) -> None:
    """A rank of a (data, stage) world: each of the spec's cases for a
    world of this size."""
    mesh.initialize_distributed(timeout_s=60, device="cpu")
    spec = torch.load(os.path.join(workdir, "spec.pt"))
    layout = mesh.make_pp_mesh(pipeline_parallel=int(degree))
    out = {"layout": tuple(layout[1:5])}
    for case in spec["cases"]:
        if case["stages"] == layout.inner:
            out[case["name"]] = pp_train(spec, case, layout)
    out["transports"] = dict(sharding.TRANSPORTS)
    torch.save(out, os.path.join(workdir, f"rank_{mesh.rank()}.pt"))
    mesh.shutdown_distributed()


def rank_job(workdir: str, *argv: str) -> None:
    """A rank of a TF_CONFIG world: the whisper_dist CLI with the tiny
    config and clip length of $TINY_WHISPER patched in; writes the model
    train_whisper returns on rank 0 and its final whole parameters before
    the job's end."""
    from tethys_tpu_torch.checkpoint import whole_state_dicts
    from tethys_tpu_torch.jobs import whisper_dist
    from tethys_tpu_torch.train import jobs

    tiny = json.loads(os.environ["TINY_WHISPER"])
    real_train, real_finalize = jobs.train_whisper, jobs.finalize_job

    def train_whisper(**kw):
        overrides = {**tiny["config"], **(kw.pop("config_overrides") or {})}
        out = real_train(**kw, config_overrides=overrides,
                         data_seq_len=tiny["seq_len"])
        if mesh.rank() == 0:    # the model train_whisper returns
            torch.save(out[1].state_dict(),
                       os.path.join(workdir, "returned.pt"))
        return out

    def finalize(result, *args, **kwargs):
        whole = whole_state_dicts(result.state, with_optimizer=False)
        if mesh.rank() == 0:
            torch.save(whole[0], os.path.join(workdir, "final.pt"))
        real_finalize(result, *args, **kwargs)

    jobs.train_whisper, jobs.finalize_job = train_whisper, finalize
    whisper_dist.main(list(argv))


def w2v_steps(spec, case, layout):
    """Wav2Vec2 pretraining (or, with the case's option head "asr", CTC
    on the dummy loss), the hardened step with wav2vec2_optimizer over
    ``layout`` (None: one process, no group) and the case's other options
    (remat, grad_accum) on each of its global batches (this replica's
    rows), the loss scaled by spec["scale"]: the logged losses, the whole
    parameters after the last step, the quantizer's indices at the first,
    each rank's own replicated parameters and the step's collective
    bytes.  A case with ``scan_layers`` runs the stacked encoder layout
    (the spec's weights stacked; its parameters in the stacked names);
    with the option ``grads`` it also gives the whole gradients of the
    first step as the global clip takes them (after the model or seq
    group's sums), unstacked, and with ``whole`` the whole checkpoint
    (``checkpoint.whole_state_dicts``) after the last step, on rank 0."""
    from tethys_tpu_torch.checkpoint import whole_state_dicts

    cfg = Wav2Vec2Config(**{**spec["configs"][case["config"]],
                            **case.get("overrides", {}),
                            "scan_layers": bool(case.get("scan_layers"))})
    options = dict(case.get("options", {}))
    head = options.pop("head", "pretraining")
    want_grads = options.pop("grads", False)
    want_whole = options.pop("whole", False)
    model = (w2v.Wav2Vec2ForCTC(cfg) if head == "asr"
             else w2v.Wav2Vec2ForPreTraining(cfg))
    weights = spec["state_dicts"][case["config"]]
    model.load_state_dict(w2v.stack_layer_params(weights) if cfg.scan_layers
                          else weights)
    model.train()

    def make(params):
        return dp.wav2vec2_optimizer(params, spec["lr"])

    if layout is not None and layout.axis == "model":
        state = tp.init_tp_state(model, make, layout)
    else:
        state = sp.init_sp_state(model, make(model.parameters()), layout)
    indices = []

    def loss_fn(m, batch, generator):
        audio, negatives = batch
        if head == "asr":     # the dummy CTC loss reads the logits alone
            out = m(audio, labels=negatives.long(), generator=generator)
            return out["loss"] * spec["scale"], {}
        out = m(audio, generator=generator)
        indices.append(out["codevector_indices"])
        loss, aux = w2v.pretraining_loss(cfg, out,
                                         negative_indices=negatives)
        return loss * spec["scale"], aux

    step = dp.make_train_step(loss_fn, state.optimizer, hardened=True,
                              layout=layout, **options)
    data, data_rank = (1, 0) if layout is None else (layout.data,
                                                     layout.data_rank)
    first, real_clip = {}, dp.clip_by_global_norm

    def snapshot(grads, *args):
        if not first:
            named = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
            if layout is not None and layout.axis == "model":
                named = tp.gather_named(named, model, layout)
            first.update(w2v.unstack_layer_params(named))
        return real_clip(grads, *args)

    if want_grads:
        dp.clip_by_global_norm = snapshot
    losses = []
    try:
        for i, batch in enumerate(spec["batches"][case["batches"]]):
            rows = len(batch[0]) // data
            mine = tuple(a[data_rank * rows:(data_rank + 1) * rows]
                         for a in batch)
            state, loss = step(state, mine,
                               dp.step_generator(spec["seed"], i, data_rank))
            losses.append(loss.item())
    finally:
        dp.clip_by_global_norm = real_clip
    sizes = getattr(model, "_tp_full_sizes", {})
    out = {"losses": losses,
           "params": (_whole(state) if layout is not None else
                      {k: v.detach().clone()
                       for k, v in model.state_dict().items()}),
           "indices": indices[0] if indices else None,
           "replicated": {n: p.detach().clone()
                          for n, p in model.named_parameters()
                          if n not in sizes},
           "collective_bytes": dict(step.collective_bytes)}
    if want_grads:
        out["grads"] = first
    if want_whole:
        out["whole"] = whole_state_dicts(state)
    return out


def clip_shards(layout) -> dict:
    """Keras clipnorm and the global-norm clip on shards over the model
    group (dp.ShardNorms) against the same clips on the whole tensors:
    the largest difference of each, after gathering."""
    gen = torch.Generator().manual_seed(5)
    whole = [torch.randn(8, 3, generator=gen) * s for s in (0.2, 0.5, 3.0)]
    whole.append(torch.randn(5, generator=gen))     # replicated
    shard = sharding.Shard(layout.inner_group, layout.inner,
                           layout.inner_rank)
    mine = [sharding.replicated_slice(w, 0, shard).clone() for w in whole[:3]]
    mine.append(whole[3].clone())
    out = {}
    for name, clip in (("clipnorm", dp.per_variable_clipnorm),
                       ("global", dp.clip_by_global_norm)):
        want = [w.clone() for w in whole]
        got = [g.clone() for g in mine]
        clip(want, 1.0)
        clip(got, 1.0, dp.ShardNorms(shard, {id(g) for g in got[:3]}))
        got = [sharding.all_gather(g, 0, shard, 8) for g in got[:3]] + got[3:]
        out[name] = max((a - b).abs().max().item()
                        for a, b in zip(got, want))
    return out


def rank_w2v(workdir: str) -> None:
    """A rank of a Wav2Vec2 world: each of the spec's cases for a world of
    this size, over its (data, model) or (data, seq) layout."""
    mesh.initialize_distributed(timeout_s=60, device="cpu")
    spec = torch.load(os.path.join(workdir, "spec.pt"))
    out = {}
    for case in spec["cases"]:
        if case["world"] != mesh.world_size():
            continue
        make = {"model": mesh.make_2d_mesh,
                "seq": mesh.make_seq_mesh}[case["axis"]]
        layout = make(case["inner"])
        out[case["name"]] = w2v_steps(spec, case, layout)
        out[case["name"]]["layout"] = tuple(layout[1:5])
        if case["axis"] == "model" and "clip" not in out:
            out["clip"] = clip_shards(layout)
    out["transports"] = dict(sharding.TRANSPORTS)
    torch.save(out, os.path.join(workdir, f"rank_{mesh.rank()}.pt"))
    mesh.shutdown_distributed()


def rank_w2v_job(workdir: str, *argv: str) -> None:
    """A rank of a wav2vec2_dist world at the tiny size of $TINY_W2V;
    writes its final whole parameters and Adam's counts before the job's
    end."""
    from tethys_tpu_torch.checkpoint import whole_state_dicts
    from tethys_tpu_torch.jobs import wav2vec2_dist
    from tethys_tpu_torch.train import jobs

    tiny = json.loads(os.environ["TINY_W2V"])
    real_model, real_finalize = w2v.create_full_model, jobs.finalize_job

    def tiny_model(model_type, model_size, **kw):
        return real_model(model_type, "tiny", **{**kw, **tiny})

    def finalize(result, *args, **kwargs):
        whole = whole_state_dicts(result.state)
        if mesh.rank() == 0:
            torch.save({"params": whole[0], "counts": sorted(
                {s["step"] for s in whole[1]["state"].values()})},
                os.path.join(workdir, "final.pt"))
        real_finalize(result, *args, **kwargs)

    w2v.create_full_model, jobs.finalize_job = tiny_model, finalize
    wav2vec2_dist.main(list(argv))


def rank_flat(workdir: str) -> None:
    """A rank of the 2-process world of tests/test_torch_flat.py: the
    spec's tiny Wav2Vec2 hardened step (its weights, the loss scaled by
    ``scale``) on this rank's rows of each batch, per tensor and on the
    flat buffer (parallel/flat.py) in turn; writes each one's losses,
    final parameters, collective bytes and, a step, the bytes of every
    all_reduce call and whether it reduced the flat gradient itself."""
    mesh.initialize_distributed(timeout_s=60, device="cpu")
    rank, n = mesh.rank(), mesh.world_size()
    spec = torch.load(os.path.join(workdir, "spec.pt"))
    cfg = Wav2Vec2Config(**spec["config"])
    real_all_reduce, out = torch.distributed.all_reduce, {}

    def loss_fn(m, batch, generator):
        audio, negatives = batch
        loss, aux = w2v.pretraining_loss(cfg, m(audio, generator=generator),
                                         negative_indices=negatives)
        return loss * spec["scale"], aux

    for kind in ("per_tensor", "flat"):
        model = w2v.Wav2Vec2ForPreTraining(cfg)
        model.load_state_dict(spec["state_dict"])
        model.train()
        fspec = None
        if kind == "flat":
            fspec = flat.FlatSpec(model)
            fspec.bind(model)
            opt = flat.wav2vec2_optimizer(fspec, spec["lr"])
        else:
            opt = dp.wav2vec2_optimizer(model.parameters(), spec["lr"])
        step = dp.make_train_step(loss_fn, opt, hardened=True,
                                  flat_spec=fspec)
        calls, losses = [], []

        def counting(tensor, *args, **kwargs):
            calls[-1].append((tensor.numel() * tensor.element_size(),
                              fspec is not None and tensor.data_ptr()
                              == fspec.param.grad.data_ptr()))
            return real_all_reduce(tensor, *args, **kwargs)

        torch.distributed.all_reduce = counting
        try:
            state = dp.TrainState(model, opt)
            for i, batch in enumerate(spec["batches"]):
                rows = len(batch[0]) // n
                local = tuple(a[rank * rows:(rank + 1) * rows] for a in batch)
                calls.append([])
                state, loss = step(state, local, dp.step_generator(0, i, rank))
                losses.append(loss.item())
        finally:
            torch.distributed.all_reduce = real_all_reduce
        out[kind] = {"losses": losses, "calls": calls,
                     "collective_bytes": dict(step.collective_bytes),
                     "total": None if fspec is None else fspec.total,
                     "params": {k: p.detach().clone() for k, p in
                                model.named_parameters()}}
    torch.save(out, os.path.join(workdir, f"rank_{rank}.pt"))
    mesh.shutdown_distributed()


if __name__ == "__main__":
    torch.set_num_threads(1)
    {"tp": rank_tp, "sp": rank_sp, "pp": rank_pp, "job": rank_job,
     "w2v": rank_w2v, "w2v_job": rank_w2v_job,
     "flat": rank_flat}[sys.argv[1]](*sys.argv[2:])
    sys.exit(0)
