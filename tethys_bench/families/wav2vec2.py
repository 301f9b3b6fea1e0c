"""Wav2Vec2 contrastive pretraining: the program's job
(``make_wav2vec2_job("pretraining")``: f32 master weights, the
configuration's compute dtype and dropout, the hardened step with its
global-norm clip, Keras Adam with its per-variable clip) and the plain
reference of its step."""

from __future__ import annotations

import dataclasses

from tethys_bench import work
from tethys_bench.reference import wav2vec2 as reference

# The training loop swallows a failed step and goes on.
RESILIENT = True


def build_job(config: dict, traffic: dict, device):
    from tethys_tpu_torch.configs import Wav2Vec2Config
    from tethys_tpu_torch.train import jobs

    # The job takes these as arguments of its own; the harness checks that
    # the job's configuration holds the file's values.
    own = ("model_size", "num_negatives", "mask_time_prob", "mask_time_length",
           "compute_dtype")
    fields = {f.name for f in dataclasses.fields(Wav2Vec2Config)}
    overrides = {k: (tuple(v) if isinstance(v, list) else v)
                 for k, v in config.items() if k in fields and k not in own}
    return jobs.make_wav2vec2_job(
        "pretraining", config["model_size"], 1, config["optimizer"]["lr"],
        config["compute_dtype"], seed=0, audio_length=traffic["samples"],
        config_overrides=overrides, device=device,
        master_dtype=config["master_dtype"])


def step_flops(config: dict, traffic: dict) -> float:
    return work.wav2vec2_step_flops(config, traffic["batch"],
                                    traffic["samples"])


def kernel_work(config: dict, traffic: dict) -> dict:
    return {"group_norm": work.wav2vec2_group_norm_work(
        config, traffic["batch"], traffic["samples"])}
