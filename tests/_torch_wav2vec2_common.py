"""Shared set-up of the Wav2Vec2 port tests (tests/test_torch_wav2vec2*.py):
a tiny config, the JAX model's own initialised parameters converted to the
port, numpy-seeded inputs."""

import re

import jax
import numpy as np
import torch

from tethys_tpu.configs import Wav2Vec2Config as JaxConfig
from tethys_tpu.models import wav2vec2 as jax_w2v
from tethys_tpu.train.jobs import _init_wav2vec2
from tethys_tpu_torch.configs import Wav2Vec2Config
from tethys_tpu_torch.convert import params_from_flax
from tethys_tpu_torch.models import wav2vec2 as w2v

TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=(16, 16, 16), conv_stride=(5, 2, 2),
    conv_kernel=(10, 3, 2), num_conv_pos_embeddings=8,
    num_conv_pos_embedding_groups=4, num_codevectors_per_group=12,
    num_codevector_groups=2, codevector_dim=16, proj_codevector_dim=16,
    num_negatives=5, classifier_proj_size=8, vocab_size=12, num_labels=3,
)
NO_DROPOUT = dict(hidden_dropout=0.0, activation_dropout=0.0,
                  attention_dropout=0.0)
AUDIO = 400                      # samples -> 80 -> 40 -> 20 frames
LOG_RE = re.compile(
    r"Step \d+, Loss: -?\d+\.\d{4}, Time: \d{2}:\d{2}:\d{2} "
    r"\(경과: \d+\.\d{2}초, 스텝 시간: \d+\.\d{2}초\)")
HEADS = {"pretraining": (jax_w2v.Wav2Vec2ForPreTraining,
                         w2v.Wav2Vec2ForPreTraining),
         "asr": (jax_w2v.Wav2Vec2ForCTC, w2v.Wav2Vec2ForCTC),
         "classification": (jax_w2v.Wav2Vec2ForSequenceClassification,
                            w2v.Wav2Vec2ForSequenceClassification)}


def t(x):
    return torch.from_numpy(np.array(x))


def configs(**overrides):
    kw = {**TINY, **NO_DROPOUT, **overrides}
    return JaxConfig(**kw), Wav2Vec2Config(**kw)


def pair(kind="pretraining", real_ctc=False, **overrides):
    """(jax model, jax params, port model in train mode, port config)."""
    jcfg, cfg = configs(**overrides)
    jcls, tcls = HEADS[kind]
    jmodel = jcls(jcfg, real_ctc=real_ctc) if kind == "asr" else jcls(jcfg)
    params = jax.device_get(_init_wav2vec2(jmodel, jcfg,
                                           jax.random.PRNGKey(0), kind))
    port = tcls(cfg, real_ctc=real_ctc) if kind == "asr" else tcls(cfg)
    port.load_state_dict(params_from_flax(params))
    return jmodel, params, port.train(), cfg


def audio(batch=2, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (batch, AUDIO)).astype(np.float32)


def close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


def negatives(cfg, batch=2, seed=9):
    """Fixed [B, K] negative indices for both sides."""
    frames = cfg.downsampled_length(AUDIO)
    return np.random.default_rng(seed).integers(
        0, frames, size=(batch, cfg.num_negatives)).astype(np.int32)
