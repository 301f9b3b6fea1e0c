"""Whisper training: the program's job (``make_whisper_job``: f32 master
weights, the configuration's compute dtype and dropout, Keras Adam) and
the plain reference of its step."""

from __future__ import annotations

import dataclasses

from tethys_bench import work
from tethys_bench.reference import whisper as reference

# The training loop swallows no failed step.
RESILIENT = False


def build_job(config: dict, traffic: dict, device):
    from tethys_tpu_torch.configs import WhisperConfig
    from tethys_tpu_torch.train import jobs

    fields = {f.name for f in dataclasses.fields(WhisperConfig)}
    overrides = {k: v for k, v in config.items()
                 if k in fields and k != "compute_dtype"}
    return jobs.make_whisper_job(
        config["model_type"], 1, config["optimizer"]["lr"],
        config["compute_dtype"], seed=0, data_seq_len=traffic["frames"],
        config_overrides=overrides, device=device,
        master_dtype=config["master_dtype"])


def step_flops(config: dict, traffic: dict) -> float:
    return work.whisper_step_flops(config, traffic["batch"],
                                   traffic["frames"], traffic["label_len"])


def kernel_work(config: dict, traffic: dict) -> dict:
    return {"flash": work.whisper_flash_work(
        config, traffic["batch"], traffic["frames"], traffic["label_len"])}
