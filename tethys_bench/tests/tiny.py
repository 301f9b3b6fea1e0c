"""Tiny cells for the CPU tests: the benchmark's configurations with their
widths cut to a CPU's size (compute in float32, so the program's plain
versions and the reference agree to rounding), and small traffic."""

import copy
import json
from pathlib import Path

from tethys_bench import harness

CONFIGS = Path(__file__).resolve().parents[1] / "configs"

WHISPER = dict(d_model=32, encoder_layers=1, encoder_attention_heads=2,
               decoder_layers=2, decoder_attention_heads=2, d_ff=64,
               n_mels=8, n_ctx=32, vocab_size=128, max_target_positions=64,
               decoder_start_token_id=101, pad_token_id=100,
               bos_token_id=100, eos_token_id=100, model_type="tiny")
WHISPER_TRAFFIC = {"inputs": "log_mel_and_labels", "batch": 4, "frames": 64,
                   "label_len": 20, "label_ids": [0, 100],
                   "eos_length": [8, 16], "pool": 4, "warmup_steps": 5,
                   "min_steps": 3, "trace_steps": 3, "reference_rows": 3}
WAV2VEC2 = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=64, conv_dim=[16, 16, 16],
                conv_kernel=[10, 3, 2], conv_stride=[5, 2, 2],
                num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=4,
                num_codevectors_per_group=8, codevector_dim=16,
                proj_codevector_dim=16, model_size="tiny")
WAV2VEC2_TRAFFIC = {"inputs": "waveform", "batch": 5, "samples": 1600,
                    "amplitude": 1.0, "pool": 4, "warmup_steps": 5,
                    "min_steps": 3, "trace_steps": 3, "reference_rows": 2}
# The program in float32 against the reference: rounding only.
TIGHT = {"loss_gap": 1e-5, "grad_gap": 1e-4, "delta_gap": 1e-4}
END_TO_END = [{"name": n, "unit": u} for n, u in (
    ("train_audio_s_per_s", "audio-s/s"), ("train_step_ms_p90", "ms"),
    ("train_peak_mem_gib", "GiB"), ("setup_s", "s"))]


def config(family: str, dtype: str = "float32", **overrides) -> dict:
    base = "whisper-base" if family == "whisper" else "wav2vec2-base"
    with open(CONFIGS / f"{base}.json") as fh:
        cfg = json.load(fh)
    cfg.update(WHISPER if family == "whisper" else WAV2VEC2)
    cfg["compute_dtype"] = dtype
    cfg.update(overrides)
    return cfg


def cell(family: str, limits=None, dtype: str = "float32",
         per_layer=(), **overrides) -> harness.Cell:
    """``overrides``: configuration keys set otherwise than the
    benchmark's configuration (paths that its cells do not take)."""
    traffic = WHISPER_TRAFFIC if family == "whisper" else WAV2VEC2_TRAFFIC
    return harness.Cell.of(f"tiny-{family}",
                           config(family, dtype, **overrides),
                           copy.deepcopy(traffic), dict(limits or TIGHT),
                           END_TO_END, per_layer)
