"""Whisper encoder-decoder for serving (tethys_tpu/models/whisper.py).

The module tree mirrors the flax parameter tree, so a state_dict key is
the flax path with ``layers_{i}`` written ``layers.{i}`` and ``kernel`` /
``scale`` / ``embedding`` written ``weight`` (convert.py).

Architecture, as in the JAX model:
* conv1 k3 s1 and conv2 k3 s2 with TF SAME padding (conv2 at an even frame
  count pads 0 frames on the left and 1 on the right), exact-erf GELU;
* sinusoidal positions in the encoder and the decoder (the decoder takes
  ``pe[index]`` while it decodes);
* pre-LN blocks with eps 1e-5, an encoder and a decoder final LayerNorm;
* a bias on every attention projection, k_proj included; q is scaled by
  head_dim^-0.5 after the bias;
* an lm_head with no bias, not tied to the embedding.

The model HOLDS its parameters in ``config.dtype`` (``create_whisper_model``
casts once after init; ``load_state_dict`` casts the f32 converted weights
on copy), so bf16 serving reads bf16 weights.

Serving: ``greedy_generate`` encodes, projects every decoder layer's
cross-attention K/V once (transposed, [B, H, D, T_enc]), then runs a
Python loop of exactly ``max_length`` single-token decode steps.  Each
step appends to the [B, H, D, T_max] self-attention caches IN PLACE through
the decode kernel (ops/decode.py).  The loop makes no host sync.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.ops.activations import gelu
from tethys_tpu_torch.ops.attention import decode_attention, multi_head_attention
from tethys_tpu_torch.ops.decode import decode_self_attention
from tethys_tpu_torch.ops.masks import causal_additive_mask
from tethys_tpu_torch.ops.posenc import sinusoidal_table
from tethys_tpu_torch.ops.qkv import merge_project, project_split

Cache = Dict[str, torch.Tensor]   # {"k": [B, H, D, T_max], "v": ...}


@functools.lru_cache(maxsize=8)
def _positions(max_len: int, d_model: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_table(max_len, d_model)).to(device)


def _same_pad(length: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF SAME padding (left, right) of a 1-D convolution."""
    out = -(-length // stride)
    total = max((out - 1) * stride + kernel - length, 0)
    return total // 2, total - total // 2


class WhisperAttention(nn.Module):
    """Self, cross and cached attention sharing one set of projections."""

    def __init__(self, config: WhisperConfig, num_heads: int):
        super().__init__()
        d = config.d_model
        self.config = config
        self.num_heads = num_heads
        self.head_dim = d // num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def _proj(self, name: str, scale: float = 1.0):
        layer = getattr(self, name)
        return layer.weight, layer.bias, scale

    def _out(self, attn: torch.Tensor) -> torch.Tensor:
        return merge_project(attn, self.out_proj.weight, self.out_proj.bias)

    def forward(self, hidden_states: torch.Tensor,
                key_value_states: Optional[torch.Tensor] = None,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Full-sequence self-attention (key_value_states None) or
        cross-attention; [B, Tq, E] -> [B, Tq, E]."""
        scaling = self.head_dim ** -0.5
        if key_value_states is None:
            q, k, v = project_split(
                hidden_states, [self._proj("q_proj", scaling),
                                self._proj("k_proj"), self._proj("v_proj")],
                self.num_heads)
        else:
            (q,) = project_split(hidden_states, [self._proj("q_proj", scaling)],
                                 self.num_heads)
            k, v = project_split(key_value_states,
                                 [self._proj("k_proj"), self._proj("v_proj")],
                                 self.num_heads)
        attn = multi_head_attention(
            q, k, v, bias=bias, use_flash=self.config.use_flash_attention)
        return self._out(attn)

    def project_kv(self, kv_source: torch.Tensor):
        """Cross-attention K/V of the encoder output, projected once per
        generate and stored transposed: ([B, H, D, Tk], [B, H, D, Tk])."""
        k, v = project_split(kv_source,
                             [self._proj("k_proj"), self._proj("v_proj")],
                             self.num_heads)
        return (k.transpose(2, 3).contiguous(), v.transpose(2, 3).contiguous())

    def decode_self(self, hidden_states: torch.Tensor, cache: Cache,
                    index: int) -> torch.Tensor:
        """One-token self-attention; appends to ``cache`` in place."""
        q, k, v = project_split(
            hidden_states, [self._proj("q_proj", self.head_dim ** -0.5),
                            self._proj("k_proj"), self._proj("v_proj")],
            self.num_heads)
        attn, _, _ = decode_self_attention(q, k, v, cache["k"], cache["v"],
                                           index)
        return self._out(attn)

    def decode_cross(self, hidden_states: torch.Tensor,
                     cross_kv: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """One-token cross-attention against the precomputed caches."""
        (q,) = project_split(
            hidden_states, [self._proj("q_proj", self.head_dim ** -0.5)],
            self.num_heads)
        return self._out(decode_attention(q, *cross_kv))


class WhisperFeedForward(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        self.fc1 = nn.Linear(config.d_model, config.d_ff)
        self.fc2 = nn.Linear(config.d_ff, config.d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


def _layer_norm(config: WhisperConfig) -> nn.LayerNorm:
    return nn.LayerNorm(config.d_model, eps=config.layer_norm_eps)


class WhisperEncoderLayer(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        self.self_attn_layer_norm = _layer_norm(config)
        self.self_attn = WhisperAttention(config, config.encoder_attention_heads)
        self.final_layer_norm = _layer_norm(config)
        self.feed_forward = WhisperFeedForward(config)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x))
        return x + self.feed_forward(self.final_layer_norm(x))


class WhisperDecoderLayer(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        heads = config.decoder_attention_heads
        self.self_attn_layer_norm = _layer_norm(config)
        self.self_attn = WhisperAttention(config, heads)
        self.encoder_attn_layer_norm = _layer_norm(config)
        self.encoder_attn = WhisperAttention(config, heads)
        self.final_layer_norm = _layer_norm(config)
        self.feed_forward = WhisperFeedForward(config)

    def forward(self, x, encoder_hidden_states, self_attn_bias=None):
        """Teacher-forced: the full target sequence at once."""
        x = x + self.self_attn(self.self_attn_layer_norm(x),
                               bias=self_attn_bias)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x),
                                  key_value_states=encoder_hidden_states)
        return x + self.feed_forward(self.final_layer_norm(x))

    def decode(self, x, cache: Cache, index: int, cross_kv):
        """One token [B, 1, E] against the caches."""
        x = x + self.self_attn.decode_self(self.self_attn_layer_norm(x),
                                           cache, index)
        x = x + self.encoder_attn.decode_cross(
            self.encoder_attn_layer_norm(x), cross_kv)
        return x + self.feed_forward(self.final_layer_norm(x))


class WhisperEncoder(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        self.config = config
        self.conv1 = nn.Conv1d(config.n_mels, config.d_model, 3)
        self.conv2 = nn.Conv1d(config.d_model, config.d_model, 3, stride=2)
        self.layers = nn.ModuleList(
            WhisperEncoderLayer(config) for _ in range(config.encoder_layers))
        self.layer_norm = _layer_norm(config)

    def forward(self, input_features: torch.Tensor,
                output_hidden_states: bool = False):
        """input_features [B, n_mels, T] -> [B, ceil(T/2), E].  With
        ``output_hidden_states`` also returns the output of the stem and of
        every layer (before the final LayerNorm)."""
        cfg = self.config
        x = input_features.to(self.conv1.weight.dtype)
        x = gelu(self.conv1(F.pad(x, _same_pad(x.shape[-1], 3, 1))))
        x = gelu(self.conv2(F.pad(x, _same_pad(x.shape[-1], 3, 2))))
        x = x.transpose(1, 2)                               # [B, T, E]
        pe = _positions(cfg.n_ctx, cfg.d_model, x.device)
        x = x + pe[: x.shape[1]].to(x.dtype)
        states: List[torch.Tensor] = [x]
        for layer in self.layers:
            x = layer(x)
            states.append(x)
        x = self.layer_norm(x)
        return (x, states) if output_hidden_states else x


class WhisperDecoder(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size, config.d_model)
        self.layers = nn.ModuleList(
            WhisperDecoderLayer(config) for _ in range(config.decoder_layers))
        self.layer_norm = _layer_norm(config)

    def _pe(self, device):
        cfg = self.config
        return _positions(cfg.max_target_positions, cfg.d_model, device)

    def forward(self, input_ids: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder: [B, T] ids -> [B, T, E]."""
        x = self.embed_tokens(input_ids)
        t = x.shape[1]
        x = x + self._pe(x.device)[:t].to(x.dtype)
        bias = causal_additive_mask(t, device=x.device)
        for layer in self.layers:
            x = layer(x, encoder_hidden_states, bias)
        return self.layer_norm(x)

    def precompute_cross_kv(self, encoder_hidden_states: torch.Tensor):
        return tuple(layer.encoder_attn.project_kv(encoder_hidden_states)
                     for layer in self.layers)

    def decode_step(self, token: torch.Tensor, caches, index: int, cross_kvs):
        """token [B, 1] at position ``index`` -> [B, 1, E]; caches are
        appended in place."""
        x = self.embed_tokens(token)
        x = x + self._pe(x.device)[index].to(x.dtype)
        for layer, cache, cross_kv in zip(self.layers, caches, cross_kvs):
            x = layer.decode(x, cache, index, cross_kv)
        return self.layer_norm(x)


class WhisperModel(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        self.encoder = WhisperEncoder(config)
        self.decoder = WhisperDecoder(config)


class WhisperForConditionalGeneration(nn.Module):
    def __init__(self, config: WhisperConfig):
        super().__init__()
        if config.kv_quant != "none":
            raise NotImplementedError(
                f"kv_quant={config.kv_quant!r} is not ported yet (ROADMAP.md)")
        self.config = config
        self.model = WhisperModel(config)
        self.lm_head = nn.Linear(config.d_model, config.vocab_size, bias=False)

    def forward(self, input_features: torch.Tensor,
                decoder_input_ids: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Teacher-forced logits [B, T, vocab] and the encoder output."""
        enc = self.model.encoder(input_features)
        hidden = self.model.decoder(decoder_input_ids, enc)
        return {"logits": self.lm_head(hidden),
                "encoder_last_hidden_state": enc}

    def encode(self, input_features: torch.Tensor) -> torch.Tensor:
        return self.model.encoder(input_features)

    def precompute_cross_kv(self, encoder_hidden_states: torch.Tensor):
        """Per decoder layer, the transposed cross-attention (K, V)."""
        return self.model.decoder.precompute_cross_kv(encoder_hidden_states)

    def decode_step(self, token: torch.Tensor, caches, index: int, cross_kvs):
        """token [B, 1] -> logits [B, 1, vocab]; caches appended in place."""
        hidden = self.model.decoder.decode_step(token, caches, index, cross_kvs)
        return self.lm_head(hidden)


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn like the JAX model's initialisers: Glorot
    uniform for Linear and Conv1d weights, zero biases, U(-0.05, 0.05) for
    the embedding, LayerNorm scale 1 and bias 0.  Values are drawn in f32
    on the generator's device (the CPU for a CPU generator) and copied in,
    so one seed gives the same weights on every device."""

    def fill(param, values):
        with torch.no_grad():
            param.copy_(values.to(device=param.device, dtype=param.dtype))

    def uniform(shape, bound):
        return (torch.rand(shape, generator=generator, device=generator.device)
                * 2.0 - 1.0) * bound

    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            w = module.weight
            receptive = w[0, 0].numel() if w.dim() == 3 else 1
            fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
            fill(w, uniform(w.shape, (6.0 / (fan_in + fan_out)) ** 0.5))
            if module.bias is not None:
                fill(module.bias, torch.zeros(module.bias.shape))
        elif isinstance(module, nn.Embedding):
            fill(module.weight, uniform(module.weight.shape, 0.05))
        elif isinstance(module, nn.LayerNorm):
            fill(module.weight, torch.ones(module.weight.shape))
            fill(module.bias, torch.zeros(module.bias.shape))


def create_whisper_model(model_type: str = "small", *, device="cpu",
                         seed: int = 0, **overrides):
    """(model, config) with random weights from ``seed``, held on ``device``
    in ``config.dtype``, in eval mode."""
    config = WhisperConfig.from_size(model_type, **overrides)
    with torch.device("meta"):
        model = WhisperForConditionalGeneration(config)
    model = model.to_empty(device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(config.dtype).eval(), config


def init_kv_caches(config: WhisperConfig, batch: int, max_length: int,
                   device) -> Tuple[Cache, ...]:
    """Zeroed self-attention caches per decoder layer, transposed
    [B, H, D, T_max] as in the JAX model."""
    head_dim = config.d_model // config.decoder_attention_heads
    shape = (batch, config.decoder_attention_heads, head_dim, max_length)
    return tuple(
        {"k": torch.zeros(shape, dtype=config.dtype, device=device),
         "v": torch.zeros(shape, dtype=config.dtype, device=device)}
        for _ in range(config.decoder_layers))


@torch.inference_mode()
def greedy_generate(model: WhisperForConditionalGeneration,
                    input_features: torch.Tensor,
                    max_length: Optional[int] = None):
    """Greedy decoding with the KV cache; returns (tokens [B, max_length+1]
    int32, length int32 0-d).

    Same observable semantics as the JAX ``greedy_generate`` (its
    fixed-length scan with a done mask): start from
    decoder_start_token_id, take the argmax (first maximal index) each
    step, and once every sequence emitted EOS at the same step, write pad
    and freeze the length.  Exactly ``max_length`` steps run; nothing in
    the loop waits on the device."""
    cfg = model.config
    max_length = max_length or cfg.max_target_positions
    batch = input_features.shape[0]
    device = input_features.device

    encoder_hidden = model.encode(input_features)
    cross_kvs = model.precompute_cross_kv(encoder_hidden)
    caches = init_kv_caches(cfg, batch, max_length, device)

    tokens = torch.full((batch, max_length + 1), cfg.pad_token_id,
                        dtype=torch.int32, device=device)
    tokens[:, 0] = cfg.decoder_start_token_id
    done = torch.zeros((), dtype=torch.bool, device=device)
    n = torch.zeros((), dtype=torch.int32, device=device)
    pad = torch.tensor(cfg.pad_token_id, dtype=torch.int32, device=device)
    for i in range(max_length):
        logits = model.decode_step(tokens[:, i:i + 1], caches, i, cross_kvs)
        next_tokens = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
        next_tokens = torch.where(done, pad, next_tokens)
        tokens[:, i + 1] = next_tokens
        n = torch.where(done, n, torch.full_like(n, i + 1))
        done = done | (next_tokens == cfg.eos_token_id).all()
    return tokens, n + 1
