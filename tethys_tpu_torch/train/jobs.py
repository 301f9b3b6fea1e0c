"""Training job assembly (tethys_tpu/train/jobs.py).

``train_whisper`` and ``train_wav2vec2``: the model with f32 master
weights, its optimizer, the synthetic dataset, the one-replica train step
and the loop, on one device (a CUDA device unless the caller names
another); ``make_whisper_job`` and ``make_wav2vec2_job`` build the step
alone (the profiler drives them too).  ``finalize_job``: the JCT print,
the JCT file and the final weights save.  Only the data-parallel branch on one process
exists; TP/SP/PP, remat, gradient accumulation, bf16 master weights and
resume are refused by the CLIs (jobs/) and wait in ROADMAP.md.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from tethys_tpu_torch import data as data_lib
from tethys_tpu_torch import losses
from tethys_tpu_torch.checkpoint import CheckpointManager, save_final_weights
from tethys_tpu_torch.configs import Wav2Vec2Config, WhisperConfig
from tethys_tpu_torch.models import wav2vec2 as wav2vec2_lib
from tethys_tpu_torch.models.whisper import create_whisper_model
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.parallel.mesh import job_identity, multi_process_spec
from tethys_tpu_torch.train.loop import TrainLoopResult, run_training
from tethys_tpu_torch.utils.artifacts import write_jct
from tethys_tpu_torch.utils.device import host_to_device, require_cuda


class TrainJob(NamedTuple):
    """What train_whisper and train_wav2vec2 run: the step, its state, the
    data."""
    step_fn: Callable
    state: dp.TrainState
    dataset: data_lib.DummyBatcher
    prepare_batch: Callable
    config: Union[WhisperConfig, Wav2Vec2Config]


def make_whisper_job(
    model_type: str = "small",
    batch_size_per_replica: int = 1,
    learning_rate: float = 1e-4,
    compute_dtype: str = "float32",
    seed: int = 42,
    data_seq_len: int = 3000,
    config_overrides: Optional[dict] = None,
    device=None,
) -> TrainJob:
    """The model with f32 master weights (in train mode), the plain step
    with ``whisper_optimizer``, the synthetic dataset."""
    _refuse_multi_process()
    device = require_cuda() if device is None else torch.device(device)
    model, config = create_whisper_model(
        model_type, device=device, seed=seed, param_dtype=torch.float32,
        compute_dtype=compute_dtype, **(config_overrides or {}))
    model.train()
    optimizer = dp.whisper_optimizer(model.parameters(), learning_rate)

    def loss_fn(model, batch, generator):
        features, labels = batch
        outputs = model(features, labels=labels, generator=generator)
        return outputs["loss"], {}

    def prepare_batch(batch):
        features, labels = batch
        return (torch.from_numpy(features).to(device),
                torch.from_numpy(labels).to(device))

    return TrainJob(
        dp.make_train_step(loss_fn, optimizer, hardened=False),
        dp.TrainState(model, optimizer),
        data_lib.create_whisper_dummy_dataset(
            batch_size_per_replica, n_mels=config.n_mels, seq_len=data_seq_len),
        prepare_batch, config)


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
):
    """End-to-end Whisper training (reference train_whisper,
    speech_jobs/whisper_dist.py:894-958).  Returns (result, model, config)."""
    job = make_whisper_job(
        model_type, batch_size_per_replica, learning_rate, compute_dtype,
        seed, data_seq_len, config_overrides, device)
    ckpt = CheckpointManager(checkpoint_dir) if checkpointing else None
    result = run_training(
        job.step_fn, job.dataset, job.state, seed,
        num_epochs=num_epochs, max_iterations=num_batches,
        prepare_batch=job.prepare_batch, checkpoint_manager=ckpt,
        checkpoint_tag=f"whisper_{model_type}", step_hooks=step_hooks)
    return result, job.state.model, job.config


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
) -> TrainJob:
    """The model with f32 master weights (in train mode), the hardened step
    with ``wav2vec2_optimizer``, the synthetic dataset.  Each step draws its
    contrastive negatives, then its dropout seeds, from the step's CPU
    generator."""
    _refuse_multi_process()
    device = require_cuda() if device is None else torch.device(device)
    model, config = wav2vec2_lib.create_full_model(
        model_type, model_size, device=device, seed=seed, real_ctc=real_ctc,
        compute_dtype=compute_dtype, **(config_overrides or {}))
    model.train()
    optimizer = dp.wav2vec2_optimizer(model.parameters(), learning_rate)
    frames = config.downsampled_length(audio_length)

    def loss_fn(model, batch, generator):
        audio, labels = batch
        if model_type == "pretraining":
            negatives = losses.sample_negative_indices(
                generator, audio.shape[0], frames, config.num_negatives)
            outputs = model(audio, generator=generator)
            return wav2vec2_lib.pretraining_loss(
                config, outputs, negative_indices=negatives)
        if model_type not in ("asr", "classification"):
            raise ValueError(f"unsupported model_type {model_type}")
        outputs = model(audio, labels=labels.long(), generator=generator)
        return outputs["loss"], {}

    def prepare_batch(batch):
        return tuple(host_to_device(torch.from_numpy(a), device)
                     for a in batch)

    return TrainJob(
        dp.make_train_step(loss_fn, optimizer, hardened=True),
        dp.TrainState(model, optimizer),
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
):
    """End-to-end Wav2Vec2 training (reference train_wav2vec2,
    speech_jobs/wav2vec2_dist.py:1263-1376): pretraining, asr or
    classification (``make_wav2vec2_job``) through the resilient loop with
    50-step and per-epoch checkpoints tagged ``model``.  Returns (result,
    model, config)."""
    job = make_wav2vec2_job(
        model_type, model_size, batch_size_per_replica, learning_rate,
        compute_dtype, seed, audio_length, real_ctc, config_overrides, device)
    ckpt = CheckpointManager(checkpoint_dir) if checkpointing else None
    result = run_training(
        job.step_fn, job.dataset, job.state, seed,
        num_epochs=num_epochs, max_iterations=num_batches,
        prepare_batch=job.prepare_batch, checkpoint_manager=ckpt,
        checkpoint_every_steps=50 if checkpointing else None,
        checkpoint_tag="model", resilient=True, step_hooks=step_hooks)
    return result, job.state.model, job.config


def _refuse_multi_process() -> None:
    if multi_process_spec() is not None:
        raise NotImplementedError(
            "TF_CONFIG names more than one process: multi-process data "
            "parallelism is not ported yet (ROADMAP.md, queue 1 item 5)")


def finalize_job(result: TrainLoopResult, name: str, jct_seconds: float,
                 single: bool = False) -> None:
    """JCT print + file (``single_jct.txt`` with ``single``) + final weights
    save (reference speech_jobs/whisper_dist.py:1001-1026)."""
    print("Training completed.")
    print("jct:", jct_seconds)
    task_type, task_index = job_identity()
    write_jct(jct_seconds, task_type, task_index, single=single)
    try:
        save_final_weights(result.state.model, name)
    except Exception as e:  # noqa: BLE001 — missing volume must not kill job
        print(f"final weight save failed: {e}")
