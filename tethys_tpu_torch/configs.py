"""Whisper and Wav2Vec2 configurations with the reference's size presets.

Field for field the same as ``tethys_tpu.configs.WhisperConfig`` (the
reference's nonstandard "small" default: d_model 768 with 4 + 4 layers) and
``tethys_tpu.configs.Wav2Vec2Config`` (tiny/small/base), with ``dtype``
resolving ``compute_dtype`` to a torch dtype.  The model computes in that
dtype; training holds f32 master weights (bf16 under the jobs'
``master_dtype="bfloat16"``) and serving its weights in that dtype
(models/whisper.py, models/wav2vec2.py).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {
    "float32": torch.float32,
    "float64": torch.float64,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name):
    if not isinstance(name, str):
        return name
    return _DTYPES[name]


@dataclasses.dataclass
class WhisperConfig:
    """Whisper encoder-decoder hyperparameters (see tethys_tpu.configs)."""

    d_model: int = 768
    encoder_layers: int = 4
    encoder_attention_heads: int = 12
    decoder_layers: int = 4
    decoder_attention_heads: int = 12
    d_ff: int = 3072

    # Encoder (audio) side.
    n_mels: int = 80
    n_ctx: int = 1500  # max mel-frame context after the stride-2 conv (30 s)

    # Decoder (text) side.
    vocab_size: int = 51865
    max_target_positions: int = 448

    # Training (the serving path runs with dropout off).
    dropout: float = 0.1
    attention_dropout: float = 0.1
    activation_dropout: float = 0.0
    activation_function: str = "gelu"

    layer_norm_eps: float = 1e-5
    init_std: float = 0.02

    # Special tokens.
    pad_token_id: int = 0
    bos_token_id: int = 1
    eos_token_id: int = 2
    decoder_start_token_id: int = 50257  # <|startoftranscript|>

    use_cache: bool = True

    # Accelerator additions (not part of the reference surface).
    compute_dtype: str = "float32"
    use_flash_attention: bool = True
    # Per-layer rematerialization in training: each encoder and decoder
    # layer runs under ops/remat.checkpoint, so the backward holds only the
    # layers' inputs and recomputes each layer's interior.
    remat_layers: bool = False
    # Its policy: "save_flash" saves the flash forward's (o, lse), so the
    # recompute does not run the forward kernel again; "none" recomputes
    # everything.  Another value raises when a model is built with
    # remat_layers=True (ops/remat.check_policy).
    remat_policy: str = "save_flash"
    # "none" keeps the cross-attention caches in the compute dtype; "int8"
    # keeps them as int8 with f32 per-column scales (ops/decode.py).
    kv_quant: str = "none"

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)

    @classmethod
    def from_size(cls, model_type: str = "small", **overrides) -> "WhisperConfig":
        presets = {
            "tiny": dict(d_model=384, encoder_layers=4, encoder_attention_heads=6,
                         decoder_layers=4, decoder_attention_heads=6, d_ff=1536),
            "base": dict(d_model=512, encoder_layers=6, encoder_attention_heads=8,
                         decoder_layers=6, decoder_attention_heads=8, d_ff=2048),
            # "small" keeps the dataclass defaults (768-d, 4+4 layers).
            "small": dict(),
            "medium": dict(d_model=1024, encoder_layers=24, encoder_attention_heads=16,
                           decoder_layers=24, decoder_attention_heads=16, d_ff=4096),
            "large": dict(d_model=1280, encoder_layers=32, encoder_attention_heads=20,
                          decoder_layers=32, decoder_attention_heads=20, d_ff=5120),
            # OpenAI whisper-large-v3: the large trunk with 128 mel bins and
            # the v2/v3 tokenizer (+1 language token).
            "large-v3": dict(d_model=1280, encoder_layers=32,
                             encoder_attention_heads=20, decoder_layers=32,
                             decoder_attention_heads=20, d_ff=5120,
                             n_mels=128, vocab_size=51866,
                             decoder_start_token_id=50258),
        }
        kwargs = dict(presets[model_type])
        kwargs.update(overrides)
        return cls(**kwargs)


@dataclasses.dataclass
class Wav2Vec2Config:
    """Wav2Vec2 hyperparameters (see tethys_tpu.configs.Wav2Vec2Config,
    reference speech_jobs/wav2vec2_dist.py:24-128)."""

    model_size: str = "small"

    hidden_size: int = 512
    num_hidden_layers: int = 6
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    conv_dim: Tuple[int, ...] = (256, 256, 256, 256, 256)
    conv_stride: Tuple[int, ...] = (5, 2, 2, 2, 2)
    conv_kernel: Tuple[int, ...] = (10, 3, 3, 3, 2)
    num_conv_pos_embeddings: int = 64
    num_conv_pos_embedding_groups: int = 8

    # Feature extractor.
    feat_extract_norm: str = "group"
    feat_extract_activation: str = "gelu"
    conv_bias: bool = False

    # Common.
    hidden_act: str = "gelu"
    hidden_dropout: float = 0.1
    activation_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_eps: float = 1e-5

    # Quantizer.
    num_codevectors_per_group: int = 160
    num_codevector_groups: int = 2
    codevector_dim: int = 128
    proj_codevector_dim: int = 128

    # Quirk #13: the reference's codevectors variable is untracked by Keras,
    # so it is never updated and never enters the global-norm clip: the
    # codebook stays frozen at its random init.  False trains it.
    freeze_codevectors: bool = True

    contrastive_logits_temperature: float = 0.1
    num_negatives: int = 100
    diversity_loss_weight: float = 0.1
    ctc_loss_reduction: str = "sum"
    ctc_zero_infinity: bool = False

    # Masking utilities exist in the reference but no training path calls
    # them (reference wav2vec2_dist.py:1073-1119).
    mask_time_prob: float = 0.05
    mask_time_length: int = 10
    mask_feature_prob: float = 0.0
    mask_feature_length: int = 10

    vocab_size: int = 32
    do_stable_layer_norm: bool = True
    use_weighted_layer_sum: bool = False

    classifier_proj_size: int = 128
    num_labels: int = 10

    tdnn_dim: Tuple[int, ...] = (256, 256, 256, 256, 768)
    xvector_output_dim: int = 256
    tdnn_kernel: Tuple[int, ...] = (5, 3, 3, 1, 1)
    tdnn_dilation: Tuple[int, ...] = (1, 2, 3, 1, 1)

    # Accelerator additions.
    compute_dtype: str = "float32"
    # The JAX package's [L, ...]-stacked nn.scan layout of the encoder
    # layers: each layer parameter held once, stacked, and one layer body
    # run L times on its slices (models/wav2vec2.py).  Same math; the
    # layouts convert with models.wav2vec2.stack_layer_params / unstack.
    scan_layers: bool = False

    @property
    def dtype(self) -> torch.dtype:
        return resolve_dtype(self.compute_dtype)

    @classmethod
    def from_size(cls, model_size: str = "small",
                  **overrides) -> "Wav2Vec2Config":
        presets = {
            "small": dict(
                hidden_size=512, num_hidden_layers=6, num_attention_heads=8,
                intermediate_size=2048,
                conv_dim=(256,) * 5, conv_stride=(5, 2, 2, 2, 2),
                conv_kernel=(10, 3, 3, 3, 2),
                num_conv_pos_embeddings=64, num_conv_pos_embedding_groups=8,
                num_codevectors_per_group=160, codevector_dim=128,
                proj_codevector_dim=128, classifier_proj_size=128,
                tdnn_dim=(256, 256, 256, 256, 768), xvector_output_dim=256,
            ),
            "tiny": dict(
                hidden_size=256, num_hidden_layers=4, num_attention_heads=4,
                intermediate_size=1024,
                conv_dim=(128,) * 4, conv_stride=(5, 2, 2, 2),
                conv_kernel=(10, 3, 3, 2),
                num_conv_pos_embeddings=32, num_conv_pos_embedding_groups=4,
                num_codevectors_per_group=80, codevector_dim=64,
                proj_codevector_dim=64, classifier_proj_size=64,
                tdnn_dim=(128, 128, 128, 128, 384), xvector_output_dim=128,
            ),
            "base": dict(
                hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
                intermediate_size=3072,
                conv_dim=(512,) * 7, conv_stride=(5, 2, 2, 2, 2, 2, 2),
                conv_kernel=(10, 3, 3, 3, 3, 2, 2),
                num_conv_pos_embeddings=128, num_conv_pos_embedding_groups=16,
                num_codevectors_per_group=320, codevector_dim=256,
                proj_codevector_dim=256, classifier_proj_size=256,
                tdnn_dim=(512, 512, 512, 512, 1500), xvector_output_dim=512,
            ),
        }
        kwargs = dict(presets[model_size])
        kwargs["model_size"] = model_size
        kwargs.update(overrides)
        return cls(**kwargs)

    def downsampled_length(self, input_length: int) -> int:
        """Frames after the conv stack for ``input_length`` samples: TF
        SAME arithmetic, a ceil division per stride."""
        length = input_length
        for stride in self.conv_stride:
            length = -(-length // stride)
        return length
