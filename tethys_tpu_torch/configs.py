"""Whisper configuration with the reference's size presets.

Field for field the same as ``tethys_tpu.configs.WhisperConfig`` (the
reference's nonstandard "small" default: d_model 768 with 4 + 4 layers),
with ``dtype`` resolving ``compute_dtype`` to a torch dtype.  The model
holds its parameters in that dtype (models/whisper.py).
"""

from __future__ import annotations

import dataclasses

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
    remat_layers: bool = False
    remat_policy: str = "save_flash"
    # "none" keeps the cross-attention caches in the compute dtype; "int8"
    # is not ported yet (ROADMAP.md) and the model refuses it.
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
