"""Whisper training job assembly (tethys_tpu/train/jobs.py).

``train_whisper``: model with f32 master weights, Keras Adam, the synthetic
dataset, the one-replica train step and the loop, on one device (a CUDA
device unless the caller names another).  ``finalize_job``: the JCT print,
the JCT file and the final weights save.  Only the data-parallel branch on
one process exists; TP/SP/PP, remat, gradient accumulation, bf16 master
weights and resume are refused by the CLI (jobs/whisper_dist.py) and wait
in ROADMAP.md.
"""

from __future__ import annotations

from typing import Optional

import torch

from tethys_tpu_torch import data as data_lib
from tethys_tpu_torch.checkpoint import CheckpointManager, save_final_weights
from tethys_tpu_torch.models.whisper import create_whisper_model
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.parallel.mesh import job_identity, multi_process_spec
from tethys_tpu_torch.train.loop import TrainLoopResult, run_training
from tethys_tpu_torch.utils.artifacts import write_jct
from tethys_tpu_torch.utils.device import require_cuda


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
    if multi_process_spec() is not None:
        raise NotImplementedError(
            "TF_CONFIG names more than one process: multi-process data "
            "parallelism is not ported yet (ROADMAP.md, queue 1 item 5)")
    device = require_cuda() if device is None else torch.device(device)
    model, config = create_whisper_model(
        model_type, device=device, seed=seed, param_dtype=torch.float32,
        compute_dtype=compute_dtype, **(config_overrides or {}))
    model.train()
    optimizer = dp.whisper_optimizer(model.parameters(), learning_rate)
    state = dp.TrainState(model, optimizer)

    def loss_fn(model, batch, generator):
        features, labels = batch
        outputs = model(features, labels=labels, generator=generator)
        return outputs["loss"], {}

    def prepare_batch(batch):
        features, labels = batch
        return (torch.from_numpy(features).to(device),
                torch.from_numpy(labels).to(device))

    step_fn = dp.make_train_step(loss_fn, optimizer, hardened=False)
    dataset = data_lib.create_whisper_dummy_dataset(
        batch_size_per_replica, n_mels=config.n_mels, seq_len=data_seq_len)
    ckpt = CheckpointManager(checkpoint_dir) if checkpointing else None
    result = run_training(
        step_fn, dataset, state, seed,
        num_epochs=num_epochs, max_iterations=num_batches,
        prepare_batch=prepare_batch, checkpoint_manager=ckpt,
        checkpoint_tag=f"whisper_{model_type}", step_hooks=step_hooks)
    return result, model, config


def finalize_job(result: TrainLoopResult, name: str,
                 jct_seconds: float) -> None:
    """JCT print + file + final weights save (reference
    speech_jobs/whisper_dist.py:1001-1026)."""
    print("Training completed.")
    print("jct:", jct_seconds)
    task_type, task_index = job_identity()
    write_jct(jct_seconds, task_type, task_index)
    try:
        save_final_weights(result.state.model, name)
    except Exception as e:  # noqa: BLE001 — missing volume must not kill job
        print(f"final weight save failed: {e}")
