"""Training job assembly (tethys_tpu/train/jobs.py).

``train_whisper`` and ``train_wav2vec2``: the model with f32 master
weights, its optimizer, the synthetic dataset, the train step and the
loop, on one device (a CUDA device unless the caller names another);
``make_whisper_job`` and ``make_wav2vec2_job`` build the step alone (the
profiler drives them too), each call inside the span
``tethys.setup.build_job`` (utils/tracing); Whisper's ``prepare_batch``
counts its bytes under ``input.bytes.pageable``, and Wav2Vec2's
pretraining loss draws its negatives inside ``tethys.w2v2.negatives``.
``finalize_job``: the JCT print, the JCT file, the final weights save and
the end of the process group.  With
``resume=True`` each restores its own newest checkpoint (``whisper_<size>_*``
or ``model_*``) into the fresh state and prints ``Resumed from checkpoint
<tag>``; the loop then starts at step 0 with the same seeds, as the JAX
job's does (the optimizer's state carries Adam's count).

Data parallelism: when the job's CLI has joined a process group
(``parallel/mesh.initialize_distributed``), every process builds the model
from the same seed, feeds its own local batch of
``batch_size_per_replica`` from the same seeded synthetic dataset (JAX
jobs.py:200-207) and keeps one replica; the step sums the gradients over
the replicas (``parallel/dp``), rank 0 writes the checkpoints, and
``collective_report=True`` writes ``<task>_<idx>_collectives.txt`` on
every rank.

Tensor and sequence parallelism, both families (``tensor_parallel``,
``seq_parallel``), and Whisper's pipeline parallelism
(``pipeline_parallel``, ``num_microbatches``), mutually exclusive as in
JAX (``parallel_layout``): the world is laid out (data, model), (data,
seq) or (data, stage) (parallel/mesh); each data replica feeds its
``batch_size_per_replica`` rows, every rank of a replica the same ones
with the same generator (the loop's replica is the data coordinate, so a
model, seq or stage group draws the same negatives and dropout seeds).
Under tensor and pipeline parallelism the whole model is made on the CPU
from the seed and each rank moves its shards or its stage to the card
(parallel/tp.shard_model, parallel/pp.split_stages); the checkpoints and
final weights are gathered whole (checkpoint.py) and restore into any
layout, and ``train_whisper`` returns the whole model on rank 0, on the
host, under pipeline parallelism (JAX jobs.py:332-341).  The PP step owns the
forward (parallel/pp.make_pp_train_step); ``remat``, ``grad_accum`` and
``master_dtype`` pass through.  Wav2Vec2 runs the hardened step over the
layout (parallel/dp.py's module doc).

The JAX bench's options (``scripts/bench``): ``flat_opt`` (both
families) binds the parameters as views of one flat f32 master and runs
the step on the flat vector (parallel/flat.py; no TP, SP or PP, no
``remat``, ``grad_accum`` 1), and Wav2Vec2's ``scan_layers`` builds the
stacked encoder layout (under data, tensor or sequence parallelism, as
JAX's ``_spec_for`` and scanned encoder allow it).  No job CLI takes
either, as none of the JAX jobs' does.

The single-card capacity modes of the JAX jobs: ``remat`` (the whole loss
checkpointed, parallel/dp), ``grad_accum`` (microbatches accumulated in
f32, parallel/dp), Whisper's ``remat_layers`` and ``remat_policy`` through
``config_overrides`` (models/whisper.py), and ``master_dtype="bfloat16"``:
the parameters are made in f32 and cast once to bf16 (JAX's
``astype(bfloat16)``, bit for bit), so Keras Adam keeps its moments in
bf16 too.

With ``profiler`` (a ``profiling.tensorsize.TensorProfiler``) a job logs
its parameters once and, after every step, the static rows of a step in
the JAX job's order (``whisper_inventories``, ``wav2vec2_inventories``:
input, activation, intra-op, output, gradient), the memory in use and,
for Wav2Vec2 with ``profile_values``, the skewness of the input, of every
loss aux of more than one element and of every summed gradient, computed
on the device and fetched with the step's loss (JAX jobs.py:110-133,
:239-277, :452-505).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from tethys_tpu_torch import data as data_lib
from tethys_tpu_torch import losses
from tethys_tpu_torch.checkpoint import (
    CheckpointManager,
    save_final_weights,
    whole_state_dicts,
)
from tethys_tpu_torch.configs import (
    Wav2Vec2Config,
    WhisperConfig,
    resolve_dtype,
)
from tethys_tpu_torch.convert import flax_path
from tethys_tpu_torch.models import wav2vec2 as wav2vec2_lib
from tethys_tpu_torch.models.whisper import (
    WhisperForConditionalGeneration,
    create_whisper_model,
)
from tethys_tpu_torch.parallel import dp, flat, mesh, pp, tp
from tethys_tpu_torch.profiling import tensorsize
from tethys_tpu_torch.profiling.comm import write_collective_report
from tethys_tpu_torch.train.loop import TrainLoopResult, run_training
from tethys_tpu_torch.utils.artifacts import write_jct
from tethys_tpu_torch.utils import tracing
from tethys_tpu_torch.utils.device import host_to_device, require_cuda


class TrainJob(NamedTuple):
    """What train_whisper and train_wav2vec2 run: the step, its state, the
    data."""
    step_fn: Callable
    state: dp.TrainState
    dataset: data_lib.DummyBatcher
    prepare_batch: Callable
    config: Union[WhisperConfig, Wav2Vec2Config]


def parallel_layout(tensor_parallel: int = 1, seq_parallel: int = 1,
                    pipeline_parallel: int = 1) -> mesh.Layout:
    """The layout of a job (JAX jobs.py:181-197, :386-395): (data, model)
    under ``tensor_parallel``, (data, seq) under ``seq_parallel``, (data,
    stage) under ``pipeline_parallel``, else one replica a rank."""
    if sum(n > 1 for n in (tensor_parallel, seq_parallel,
                           pipeline_parallel)) > 1:
        raise ValueError(
            "tensor_parallel / seq_parallel / pipeline_parallel are "
            "mutually exclusive")
    if tensor_parallel > 1:
        return mesh.make_2d_mesh(model_parallel=tensor_parallel)
    if seq_parallel > 1:
        return mesh.make_seq_mesh(seq_parallel=seq_parallel)
    if pipeline_parallel > 1:
        return mesh.make_pp_mesh(pipeline_parallel=pipeline_parallel)
    return mesh.make_data_mesh()


@tracing.spanned("tethys.setup.build_job")
def make_whisper_job(
    model_type: str = "small",
    batch_size_per_replica: int = 1,
    learning_rate: float = 1e-4,
    compute_dtype: str = "float32",
    seed: int = 42,
    data_seq_len: int = 3000,
    config_overrides: Optional[dict] = None,
    device=None,
    remat: bool = False,
    grad_accum: int = 1,
    master_dtype: str = "float32",
    tensor_parallel: int = 1,
    seq_parallel: int = 1,
    pipeline_parallel: int = 1,
    num_microbatches: int = 2,
    flat_opt: bool = False,
) -> TrainJob:
    """The model with ``master_dtype`` master weights (in train mode), the
    plain step with ``whisper_optimizer``, ``remat`` and ``grad_accum``
    (under ``pipeline_parallel`` the PP step with ``num_microbatches``),
    the synthetic dataset; over ``parallel_layout(tensor_parallel,
    seq_parallel, pipeline_parallel)``.  ``flat_opt``: the flat-buffer
    optimizer (module doc)."""
    layout = parallel_layout(tensor_parallel, seq_parallel, pipeline_parallel)
    _check_flat_opt(flat_opt, layout)
    device = require_cuda() if device is None else torch.device(device)
    split = layout.axis in ("model", "stage") and layout.inner > 1
    # create_whisper_model draws the weights in f32 and casts them once;
    # under tensor or pipeline parallelism on the CPU, and each rank moves
    # its shards or its stage.
    model, config = create_whisper_model(
        model_type, device="cpu" if split else device, seed=seed,
        param_dtype=resolve_dtype(master_dtype),
        compute_dtype=compute_dtype, **(config_overrides or {}))
    if split and layout.axis == "model":
        tp.check_divides(config, layout.inner, f"whisper {model_type}")
        model = tp.shard_model(model, layout).to(device)
    elif split:
        model = pp.split_stages(model, layout).to(device)
    model.train()
    spec = _flat_spec(model) if flat_opt else None
    optimizer = (flat.whisper_optimizer(spec, learning_rate) if flat_opt
                 else dp.whisper_optimizer(model.parameters(), learning_rate))

    def loss_fn(model, batch, generator):
        features, labels = batch
        outputs = model(features, labels=labels, generator=generator)
        return outputs["loss"], {}

    def prepare_batch(batch):
        features, labels = batch
        tracing.count("input.bytes.pageable", features.nbytes + labels.nbytes)
        return (torch.from_numpy(features).to(device),
                torch.from_numpy(labels).to(device))

    if layout.axis == "stage":
        step = pp.make_pp_train_step(model, optimizer, layout,
                                     num_microbatches, remat=remat,
                                     grad_accum=grad_accum)
    else:
        step = dp.make_train_step(loss_fn, optimizer, hardened=False,
                                  remat=remat, grad_accum=grad_accum,
                                  layout=layout, flat_spec=spec)
    return TrainJob(
        step, dp.TrainState(model, optimizer, layout),
        data_lib.create_whisper_dummy_dataset(
            batch_size_per_replica, n_mels=config.n_mels, seq_len=data_seq_len),
        prepare_batch, config)


def _check_flat_opt(flat_opt: bool, layout: mesh.Layout) -> None:
    if flat_opt and layout.inner > 1:
        raise ValueError("--flat_opt takes no --tp, --sp or --pp: no JAX "
                         "entry point combines them")


def _flat_spec(model: torch.nn.Module) -> flat.FlatSpec:
    """The model's parameters bound as views of one flat master."""
    spec = flat.FlatSpec(model)
    spec.bind(model)
    return spec


Inventories = List[Tuple[List[tensorsize.Row], str]]
WHISPER_LABELS = 100      # the label length of the synthetic dataset


def _profiler_hooks(profiler, static_inventories: Inventories):
    """The per-step hook that drives the TensorProfiler: the static rows of
    a step, the value skews of the step's aux, the memory in use."""

    def hook(step, loss, duration, aux):
        profiler.start_step(step)
        for inventory, tensor_type in static_inventories:
            profiler.log_inventory(inventory, tensor_type)
        if aux:
            skews = {}
            for key, val in aux.items():
                if key in ("grad_aux", "value_skews") and isinstance(val, dict):
                    skews.update({k: float(v) for k, v in val.items()})
            if skews:
                profiler.log_value_skews(skews)
        profiler.log_memory_usage()
        profiler.end_step()

    return hook


def whisper_inventories(config: WhisperConfig, batch_size: int,
                        data_seq_len: int = 3000) -> Inventories:
    """A Whisper training step's static rows, (rows, tensor type) in the
    JAX job's order, from shapes alone (no parameter is allocated)."""
    spec = tensorsize.TensorSpec
    feats = spec((batch_size, config.n_mels, data_seq_len), torch.float32)
    labels = spec((batch_size, WHISPER_LABELS), torch.int32)
    model = WhisperForConditionalGeneration
    return [
        (tensorsize.tensor_inventory(
            {"input_features": feats, "labels": labels}, "input"), "input"),
        (tensorsize.intermediate_inventory(model, config, feats,
                                           labels=labels), "activation"),
        # The intra-op tensors that no module returns; the encoder's
        # length is the stride-2 SAME conv's ceil(T / 2).
        (tensorsize.whisper_intra_op_inventory(
            config, batch_size, enc_len=-(-data_seq_len // 2),
            dec_len=WHISPER_LABELS), "activation"),
        (tensorsize.tensor_inventory(tensorsize.eval_shape(
            model, config, feats, labels=labels), "output"), "output"),
        (tensorsize.tensor_inventory(tensorsize.parameter_tree(
            _shape_only(model, config)), "gradient"), "gradient"),
    ]


def wav2vec2_inventories(config: Wav2Vec2Config, batch_size: int,
                         audio_length: int = 32000,
                         model=wav2vec2_lib.Wav2Vec2ForPreTraining
                         ) -> Inventories:
    """A Wav2Vec2 training step's static rows (as ``whisper_inventories``),
    of ``model``'s training forward (for pretraining, the quantizer's
    branch included)."""
    audio = tensorsize.TensorSpec((batch_size, audio_length), torch.float32)
    return [
        (tensorsize.tensor_inventory({"input_values": audio}, "input"),
         "input"),
        (tensorsize.intermediate_inventory(model, config, audio,
                                           training=True), "activation"),
        (tensorsize.wav2vec2_intra_op_inventory(
            config, batch_size, frames=tensorsize.conv_output_length(
                audio_length, config.conv_stride)), "activation"),
        (tensorsize.tensor_inventory(tensorsize.eval_shape(
            model, config, audio, training=True), "output"), "output"),
        (tensorsize.tensor_inventory(tensorsize.parameter_tree(
            _shape_only(model, config)), "gradient"), "gradient"),
    ]


def _shape_only(model_class, config) -> torch.nn.Module:
    """The model's parameters without their memory (the meta device)."""
    with torch.device("meta"):
        return model_class(config)


def train_whisper(
    model_type: str = "small",
    batch_size_per_replica: int = 1,
    num_batches: int = 40,
    num_epochs: int = 1,
    learning_rate: float = 1e-4,
    compute_dtype: str = "float32",
    seed: int = 42,
    checkpointing: bool = True,
    checkpoint_dir: Optional[str] = None,
    data_seq_len: int = 3000,
    config_overrides: Optional[dict] = None,
    device=None,
    step_hooks: tuple = (),
    profiler=None,
    resume: bool = False,
    collective_report: bool = False,
    remat: bool = False,
    grad_accum: int = 1,
    master_dtype: str = "float32",
    tensor_parallel: int = 1,
    seq_parallel: int = 1,
    pipeline_parallel: int = 1,
    num_microbatches: int = 2,
):
    """End-to-end Whisper training (reference train_whisper,
    speech_jobs/whisper_dist.py:894-958).  With ``profiler``, the
    tensorsize instrumentation of whisper_dist_tensorsize.py; ``remat``,
    ``grad_accum``, ``master_dtype``, ``tensor_parallel``,
    ``seq_parallel``, ``pipeline_parallel`` and ``num_microbatches`` as in
    the module doc.  Returns (result, model, config): under pipeline
    parallelism the model is the whole one on rank 0, on the host (the
    stage's elsewhere), and ``result.state`` the stage state."""
    job = make_whisper_job(
        model_type, batch_size_per_replica, learning_rate, compute_dtype,
        seed, data_seq_len, config_overrides, device, remat=remat,
        grad_accum=grad_accum, master_dtype=master_dtype,
        tensor_parallel=tensor_parallel, seq_parallel=seq_parallel,
        pipeline_parallel=pipeline_parallel,
        num_microbatches=num_microbatches)
    if profiler is not None:
        profiler.log_model_parameters(job.state.model)
        step_hooks = tuple(step_hooks) + (_profiler_hooks(
            profiler, whisper_inventories(
                job.config, batch_size_per_replica, data_seq_len)),)
    ckpt = CheckpointManager(checkpoint_dir) if checkpointing else None
    if resume and ckpt is not None:
        _resume(ckpt, job.state, f"whisper_{model_type}_")
    result = run_training(
        job.step_fn, job.dataset, job.state, seed,
        num_epochs=num_epochs, max_iterations=num_batches,
        prepare_batch=job.prepare_batch, checkpoint_manager=ckpt,
        checkpoint_tag=f"whisper_{model_type}", step_hooks=step_hooks,
        replica=job.state.layout.data_rank)
    if collective_report:
        _emit_collective_report(job.step_fn)
    model = job.state.model
    if job.state.layout.axis == "stage":
        model = _whole_model(job.state) or model
    return result, model, job.config


def _whole_model(state: dp.TrainState):
    """The whole model of a stage state on rank 0, on the host as JAX's
    ``gather_unpacked_params`` returns it (a stage's card need not hold
    the whole model), in the stage model's mode (None elsewhere); a
    collective of the first stage group."""
    layout = state.layout
    whole = (pp.gather_params(state.model, layout)
             if layout.data_rank == 0 else None)
    if mesh.rank() != 0:
        return None
    with torch.device("meta"):
        model = WhisperForConditionalGeneration(state.model.config)
    model.load_state_dict(whole, assign=True)
    return model.train(state.model.training)


@tracing.spanned("tethys.setup.build_job")
def make_wav2vec2_job(
    model_type: str = "pretraining",
    model_size: str = "small",
    batch_size_per_replica: int = 1,
    learning_rate: float = 3e-5,
    compute_dtype: str = "float32",
    seed: int = 42,
    audio_length: int = 32000,
    real_ctc: bool = False,
    config_overrides: Optional[dict] = None,
    device=None,
    profile_values: bool = False,
    remat: bool = False,
    grad_accum: int = 1,
    master_dtype: str = "float32",
    tensor_parallel: int = 1,
    seq_parallel: int = 1,
    scan_layers: bool = False,
    flat_opt: bool = False,
) -> TrainJob:
    """The model with ``master_dtype`` master weights (in train mode), the
    hardened step with ``wav2vec2_optimizer``, ``remat`` and
    ``grad_accum``, the synthetic dataset; over ``parallel_layout(
    tensor_parallel, seq_parallel)``.  ``scan_layers``: the stacked
    encoder layout (also under tensor or sequence parallelism);
    ``flat_opt``: the flat-buffer optimizer (module doc).  Each step (each microbatch
    under ``grad_accum``) draws its contrastive negatives, then its dropout
    seeds, from its CPU generator.  ``profile_values``: the step returns
    (state, loss, aux),
    the aux the value skews of the input and of the loss aux's tensors of
    more than one element, with the skews of the summed gradients under
    ``grad_aux``, by flax path (one replica a rank only: the tensorsize
    jobs take no parallel flag)."""
    layout = parallel_layout(tensor_parallel, seq_parallel)
    _check_flat_opt(flat_opt, layout)
    if profile_values and layout.inner > 1:
        raise ValueError("profile_values takes one replica a rank (the "
                         "tensorsize jobs take no parallel flag)")
    device = require_cuda() if device is None else torch.device(device)
    sharded = layout.axis == "model" and layout.inner > 1
    # Under tensor parallelism made on the CPU, and each rank moves its
    # shards.
    model, config = wav2vec2_lib.create_full_model(
        model_type, model_size, device="cpu" if sharded else device,
        seed=seed, real_ctc=real_ctc, param_dtype=resolve_dtype(master_dtype),
        compute_dtype=compute_dtype,
        **{"scan_layers": scan_layers, **(config_overrides or {})})
    if sharded:
        tp.check_divides(config, layout.inner, f"wav2vec2 {model_size}")
        model = tp.shard_model(model, layout).to(device)
    model.train()
    spec = _flat_spec(model) if flat_opt else None
    optimizer = (flat.wav2vec2_optimizer(spec, learning_rate) if flat_opt
                 else dp.wav2vec2_optimizer(model.parameters(), learning_rate))
    frames = config.downsampled_length(audio_length)

    def loss_fn(model, batch, generator):
        audio, labels = batch
        if model_type == "pretraining":
            with tracing.span("tethys.w2v2.negatives"):
                negatives = losses.sample_negative_indices(
                    generator, audio.shape[0], frames, config.num_negatives)
            outputs = model(audio, generator=generator)
            return wav2vec2_lib.pretraining_loss(
                config, outputs, negative_indices=negatives)
        if model_type not in ("asr", "classification"):
            raise ValueError(f"unsupported model_type {model_type}")
        outputs = model(audio, labels=labels.long(), generator=generator)
        return outputs["loss"], {}

    grad_aux_fn = None
    if profile_values:
        base_loss_fn = loss_fn

        def loss_fn(model, batch, generator):  # noqa: F811
            loss, aux = base_loss_fn(model, batch, generator)
            skews = {"input/input_values": tensorsize.value_skewness(batch[0])}
            for key, val in (aux or {}).items():
                if val.numel() > 1:
                    skews[f"output/{key}"] = tensorsize.value_skewness(val)
            return loss, {"value_skews": skews}

        flax_names = {name: "/".join(flax_path(name, p.dim()))
                      for name, p in model.named_parameters()}

        def grad_aux_fn(grads):
            return tensorsize.tree_value_skewness(
                {flax_names[n]: g for n, g in grads.items()}, "gradient")

    def prepare_batch(batch):
        return tuple(host_to_device(torch.from_numpy(a), device)
                     for a in batch)

    return TrainJob(
        dp.make_train_step(loss_fn, optimizer, hardened=True,
                           return_aux=profile_values, grad_aux_fn=grad_aux_fn,
                           remat=remat, grad_accum=grad_accum, layout=layout,
                           flat_spec=spec),
        dp.TrainState(model, optimizer, layout),
        data_lib.create_wav2vec2_dummy_dataset(batch_size_per_replica,
                                               audio_length=audio_length),
        prepare_batch, config)


def train_wav2vec2(
    model_type: str = "pretraining",
    model_size: str = "small",
    batch_size_per_replica: int = 1,
    num_batches: int = 5,
    num_epochs: int = 1,
    learning_rate: float = 3e-5,
    compute_dtype: str = "float32",
    seed: int = 42,
    checkpointing: bool = True,
    checkpoint_dir: Optional[str] = None,
    audio_length: int = 32000,
    real_ctc: bool = False,
    config_overrides: Optional[dict] = None,
    device=None,
    step_hooks: tuple = (),
    profiler=None,
    profile_values: bool = True,
    resume: bool = False,
    collective_report: bool = False,
    remat: bool = False,
    grad_accum: int = 1,
    tensor_parallel: int = 1,
    seq_parallel: int = 1,
):
    """End-to-end Wav2Vec2 training (reference train_wav2vec2,
    speech_jobs/wav2vec2_dist.py:1263-1376): pretraining, asr or
    classification (``make_wav2vec2_job``) through the resilient loop with
    50-step and per-epoch checkpoints tagged ``model``.  With ``profiler``,
    the tensorsize and per-value skewness instrumentation of
    wav2vec2_dist_tensorsize.py (module doc); ``remat``, ``grad_accum``,
    ``tensor_parallel`` and ``seq_parallel`` as in the module doc.  Returns
    (result, model, config)."""
    profiling = profiler is not None
    job = make_wav2vec2_job(
        model_type, model_size, batch_size_per_replica, learning_rate,
        compute_dtype, seed, audio_length, real_ctc, config_overrides, device,
        profile_values=profiling and profile_values, remat=remat,
        grad_accum=grad_accum, tensor_parallel=tensor_parallel,
        seq_parallel=seq_parallel)
    if profiling:
        profiler.log_model_parameters(job.state.model)
        step_hooks = tuple(step_hooks) + (_profiler_hooks(
            profiler, wav2vec2_inventories(
                job.config, batch_size_per_replica, audio_length,
                type(job.state.model))),)
    ckpt = CheckpointManager(checkpoint_dir) if checkpointing else None
    if resume and ckpt is not None:
        _resume(ckpt, job.state, "model_")
    result = run_training(
        job.step_fn, job.dataset, job.state, seed,
        num_epochs=num_epochs, max_iterations=num_batches,
        prepare_batch=job.prepare_batch, checkpoint_manager=ckpt,
        checkpoint_every_steps=50 if checkpointing else None,
        checkpoint_tag="model", resilient=True, step_hooks=step_hooks,
        replica=job.state.layout.data_rank)
    if collective_report:
        _emit_collective_report(job.step_fn)
    return result, job.state.model, job.config


def _resume(ckpt: CheckpointManager, state: dp.TrainState,
            prefix: str) -> None:
    """Restores the newest checkpoint whose tag starts with ``prefix`` (the
    job's own tag and its underscore, so ``whisper_large`` never takes
    ``whisper_large-v3``'s) into ``state``, if there is one: rank 0's, on
    every rank."""
    latest = mesh.broadcast_object(
        ckpt.latest_tag(prefix=prefix) if mesh.rank() == 0 else None)
    if latest:
        ckpt.restore_like(latest, state)
        print(f"Resumed from checkpoint {latest}")


def _emit_collective_report(step_fn) -> None:
    """``<task>_<idx>_collectives.txt`` from the bytes the step's last run
    handed to each kind of collective (the gradient reduces and, under
    tensor or sequence parallelism, the model's own), when it moved any
    (the JAX job's ``_emit_collective_report``, tethys_tpu/train/
    jobs.py:78-99)."""
    if not step_fn.collective_bytes:
        return
    task_type, task_index = mesh.job_identity()
    path = write_collective_report(step_fn.collective_bytes, task_type,
                                   task_index)
    if path:
        print(f"collective report: {path}")


def finalize_job(result: TrainLoopResult, name: str, jct_seconds: float,
                 single: bool = False) -> None:
    """JCT print + file (``single_jct.txt`` with ``single``) + final weights
    save (reference speech_jobs/whisper_dist.py:1001-1026), then the end of
    the process group.  Every rank writes its own JCT file; rank 0 alone
    saves the weights."""
    print("Training completed.")
    print("jct:", jct_seconds)
    task_type, task_index = mesh.job_identity()
    write_jct(jct_seconds, task_type, task_index, single=single)
    whole = whole_state_dicts(result.state, with_optimizer=False)
    try:
        save_final_weights(result.state.model, name,
                           state_dict=whole and whole[0])
    except Exception as e:  # noqa: BLE001 — missing volume must not kill job
        print(f"final weight save failed: {e}")
    mesh.shutdown_distributed()
