"""Wav2Vec2: pretraining, CTC and classification (tethys_tpu/models/wav2vec2.py).

The module tree mirrors the flax parameter tree, so a state_dict key is the
flax path with ``layers_{i}`` written ``layers.{i}`` (convert.py).  As in
the JAX model (reference speech_jobs/wav2vec2_dist.py:24-1067):
* the feature encoder: strided convs with TF SAME padding (ops/conv.py),
  each followed by the reference GroupNorm (num_conv_pos_embedding_groups
  groups, joint (T, C/G) moments; the gn_stats kernel on the card) and
  exact-erf GELU; a grouped positional conv (k 128 at base, even, so
  asymmetric SAME), added; LayerNorm; dropout;
* a projection to the hidden size, LayerNorm, dropout; an encoder of
  pre-LN (``do_stable_layer_norm``) or post-LN layers, optionally with a
  softmax-weighted sum of the layer outputs;
* attention with q pre-scaled by head_dim^-0.5, the plain composition
  (the JAX model asks for no flash kernel), dropout on the probabilities;
* the hard argmin product quantizer of the *projected* features: squared
  distances from one matmul per group, first index on ties, one-hot,
  perplexity.  ``freeze_codevectors`` (quirk #13) makes the codebook a
  parameter that takes no gradient, so it gets no Adam update and no share
  of the global-norm clip.  Its input projection gets no gradient either:
  argmin is not differentiable (the JAX gradient there is exactly 0);
* heads: pretraining (project_hid, project_q), CTC (dummy or real CTC
  loss) and sequence classification.

Every dropout site of the JAX model, ``module_dropout`` and flax's
``nn.Dropout`` alike (wav2vec2.py:331,418,456), is the port's Philox
dropout (ops/dropout.py), live in ``model.train()`` mode with a CPU
``torch.Generator``.  ``self.training`` also stands for the JAX
``training`` flag: the quantizer branch and the losses run in train mode.
Parameters are cast to ``config.dtype`` where they are used (flax's
``dtype=``); ``create_full_model`` holds f32 master weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tethys_tpu_torch import losses
from tethys_tpu_torch.configs import Wav2Vec2Config
from tethys_tpu_torch.models.whisper import init_weights as _init_linear_conv
from tethys_tpu_torch.ops.activations import gelu
from tethys_tpu_torch.ops.attention import multi_head_attention
from tethys_tpu_torch.ops.conv import conv1d_same
from tethys_tpu_torch.ops.dropout import module_dropout
from tethys_tpu_torch.ops.masks import padding_additive_mask
from tethys_tpu_torch.ops.norms import LayerNorm, ReferenceGroupNorm
from tethys_tpu_torch.utils.device import require_cuda

Generator = Optional[torch.Generator]
Outputs = Dict[str, torch.Tensor]


class Dense(nn.Linear):
    """flax ``Dense(dtype=)``: input, weight and bias in the compute dtype."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        return F.linear(x.to(dtype), self.weight.to(dtype),
                        self.bias.to(dtype))


class SameConv1d(nn.Conv1d):
    """flax ``Conv(padding="SAME", dtype=)`` on channels-last [B, T, C]."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         groups=groups, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dtype)
        return conv1d_same(x.to(dtype), self.weight.to(dtype), bias,
                           self.stride[0], self.groups)


def _layer_norm(config: Wav2Vec2Config, dim: int) -> LayerNorm:
    return LayerNorm(dim, eps=config.layer_norm_eps)


class Wav2Vec2FeatureExtractor(nn.Module):
    """Raw waveform [B, T] -> conv features [B, T', conv_dim[-1]]."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        dtype, channels = config.dtype, 1
        for i, (dim, kernel, stride) in enumerate(zip(
                config.conv_dim, config.conv_kernel, config.conv_stride)):
            self.add_module(f"conv_{i}", SameConv1d(
                channels, dim, kernel, stride, bias=config.conv_bias,
                dtype=dtype))
            if config.feat_extract_norm == "group":
                norm = ReferenceGroupNorm(
                    dim, config.num_conv_pos_embedding_groups, dtype=dtype)
            else:
                norm = LayerNorm(dim, eps=1e-5)
            self.add_module(f"norm_{i}", norm)
            channels = dim
        self.pos_conv_embed = SameConv1d(
            channels, channels, config.num_conv_pos_embeddings,
            groups=config.num_conv_pos_embedding_groups, dtype=dtype)
        self.layer_norm = _layer_norm(config, channels)

    def forward(self, inputs: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        cfg = self.config
        x = inputs[:, :, None].to(cfg.dtype)                 # [B, T, 1]
        for i in range(len(cfg.conv_dim)):
            x = getattr(self, f"norm_{i}")(getattr(self, f"conv_{i}")(x))
            x = gelu(x) if cfg.feat_extract_activation == "gelu" else F.relu(x)
        x = x + self.pos_conv_embed(x)
        x = self.layer_norm(x)
        return module_dropout(x, cfg.hidden_dropout, self.training, generator)


class Wav2Vec2Attention(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        e, dtype = config.hidden_size, config.dtype
        self.q_proj = Dense(e, e, dtype)
        self.k_proj = Dense(e, e, dtype)
        self.v_proj = Dense(e, e, dtype)
        self.out_proj = Dense(e, e, dtype)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                generator: Generator = None) -> torch.Tensor:
        cfg = self.config
        b, s, e = x.shape
        heads = cfg.num_attention_heads
        head_dim = e // heads

        def split(t):  # a reshape, as the JAX model (no split kernel)
            return t.view(b, s, heads, head_dim).transpose(1, 2)

        q = split(self.q_proj(x) * head_dim ** -0.5)
        attn = multi_head_attention(
            q, split(self.k_proj(x)), split(self.v_proj(x)), bias=bias,
            dropout_rate=cfg.attention_dropout, generator=generator,
            training=self.training)
        return self.out_proj(attn.transpose(1, 2).reshape(b, s, e))


class Wav2Vec2FeedForward(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.intermediate_dense = Dense(config.hidden_size,
                                        config.intermediate_size, config.dtype)
        self.output_dense = Dense(config.intermediate_size,
                                  config.hidden_size, config.dtype)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        cfg = self.config
        x = gelu(self.intermediate_dense(x))
        x = module_dropout(x, cfg.activation_dropout, self.training, generator)
        x = self.output_dense(x)
        return module_dropout(x, cfg.hidden_dropout, self.training, generator)


class Wav2Vec2EncoderLayer(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.attention = Wav2Vec2Attention(config)
        self.attention_layer_norm = _layer_norm(config, config.hidden_size)
        self.feed_forward = Wav2Vec2FeedForward(config)
        self.feed_forward_layer_norm = _layer_norm(config, config.hidden_size)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                generator: Generator = None) -> torch.Tensor:
        rate = self.config.hidden_dropout

        def dropout(t):
            return module_dropout(t, rate, self.training, generator)

        if self.config.do_stable_layer_norm:      # pre-LN
            a = self.attention(self.attention_layer_norm(x), bias, generator)
            x = x + dropout(a)
            return x + self.feed_forward(self.feed_forward_layer_norm(x),
                                         generator)
        a = self.attention(x, bias, generator)    # post-LN
        x = self.attention_layer_norm(x + dropout(a))
        return self.feed_forward_layer_norm(x + self.feed_forward(x, generator))


class Wav2Vec2Encoder(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.layers = nn.ModuleList(
            Wav2Vec2EncoderLayer(config)
            for _ in range(config.num_hidden_layers))
        if config.use_weighted_layer_sum:
            self.layer_weights = nn.Parameter(
                torch.full((config.num_hidden_layers,),
                           1.0 / config.num_hidden_layers))

    def forward(self, x: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Generator = None) -> Outputs:
        bias = None
        if attention_mask is not None:
            bias = padding_additive_mask(attention_mask, scale=-10000.0)
        outputs = []
        for layer in self.layers:
            x = layer(x, bias, generator)
            outputs.append(x)
        if self.config.use_weighted_layer_sum:
            weights = torch.softmax(self.layer_weights, dim=-1).to(x.dtype)
            x = torch.einsum("l,lbth->bth", weights, torch.stack(outputs))
        return {"last_hidden_state": x}


class Wav2Vec2ProjectionHead(nn.Module):
    def __init__(self, config: Wav2Vec2Config, in_features: int):
        super().__init__()
        self.config = config
        self.projection_head = Dense(in_features, config.proj_codevector_dim,
                                     config.dtype)
        self.layer_norm = _layer_norm(config, config.proj_codevector_dim)

    def forward(self, x: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        x = self.layer_norm(self.projection_head(x))
        return module_dropout(x, self.config.hidden_dropout, self.training,
                              generator)


class Wav2Vec2Quantizer(nn.Module):
    """Hard (argmin) product quantizer, not Gumbel-softmax, by design."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        groups = config.num_codevector_groups
        self.codevectors = nn.Parameter(
            torch.empty(groups, config.num_codevectors_per_group,
                        config.codevector_dim // groups),
            requires_grad=not config.freeze_codevectors)
        self.project_to_codevector_dim = Dense(
            config.hidden_size, config.codevector_dim, config.dtype)

    def forward(self, hidden_states: torch.Tensor) -> Outputs:
        cfg = self.config
        groups = cfg.num_codevector_groups
        vectors = cfg.num_codevectors_per_group
        codevectors = self.codevectors.float()
        projected = self.project_to_codevector_dim(hidden_states)
        b, t, _ = projected.shape
        # [G, B*T, d]
        h = projected.float().view(b * t, groups, -1).transpose(0, 1)
        # |h - c|^2 = |h|^2 - 2 h.c + |c|^2: one matmul per group.
        distances = (h.square().sum(dim=-1, keepdim=True)
                     - 2.0 * torch.bmm(h, codevectors.transpose(1, 2))
                     + codevectors.square().sum(dim=-1)[:, None, :])
        indices = distances.argmin(dim=-1)                 # first on ties
        encodings = F.one_hot(indices, vectors).float()    # [G, BT, V]
        quantized = torch.bmm(encodings, codevectors)      # [G, BT, d]
        quantized = quantized.transpose(0, 1).reshape(b, t, cfg.codevector_dim)
        avg_probs = encodings.mean(dim=1).clamp(1e-10, 1.0)            # [G, V]
        perplexity = torch.exp(
            -(avg_probs * torch.log(avg_probs + 1e-10)).sum(dim=-1)).mean()
        return {
            "quantized_features": quantized.to(cfg.dtype),
            "encodings": encodings.view(groups, b, t, vectors),
            "indices": indices.view(groups, b, t),
            "distances": distances.view(groups, b, t, vectors),
            "codevector_perplexity": perplexity,
        }


class Wav2Vec2Model(nn.Module):
    """``projection_heads``: the pretraining model's project_hid and
    project_q live here, as in the flax tree (the other heads never call
    them, so flax makes no parameters for them)."""

    def __init__(self, config: Wav2Vec2Config, projection_heads: bool = False):
        super().__init__()
        self.config = config
        conv_out, hidden = config.conv_dim[-1], config.hidden_size
        self.feature_extractor = Wav2Vec2FeatureExtractor(config)
        self.feature_projection = Dense(conv_out, hidden, config.dtype)
        self.feature_projection_layer_norm = _layer_norm(config, hidden)
        self.encoder = Wav2Vec2Encoder(config)
        self.quantizer = Wav2Vec2Quantizer(config)
        if projection_heads:
            self.project_hid = Wav2Vec2ProjectionHead(config, hidden)
            self.project_q = Wav2Vec2ProjectionHead(config,
                                                    config.codevector_dim)

    def forward(self, inputs: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Generator = None) -> Outputs:
        """inputs [B, T] raw waveform.  In train mode also the quantized
        projected features, their perplexity and the quantizer's argmin
        indices [G, B, T'] and distances [G, B, T', V]."""
        cfg = self.config
        extract = self.feature_extractor(inputs, generator)
        hidden = self.feature_projection_layer_norm(
            self.feature_projection(extract))
        hidden = module_dropout(hidden, cfg.hidden_dropout, self.training,
                                generator)
        result = {"extract_features": extract}
        if self.training:
            quantized = self.quantizer(hidden)
            result["quantized_features"] = quantized["quantized_features"]
            result["codevector_perplexity"] = quantized["codevector_perplexity"]
            result["codevector_indices"] = quantized["indices"]
            result["codevector_distances"] = quantized["distances"]
        encoded = self.encoder(hidden, attention_mask, generator)
        result["last_hidden_state"] = encoded["last_hidden_state"]
        return result


class Wav2Vec2ForPreTraining(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.wav2vec2 = Wav2Vec2Model(config, projection_heads=True)

    def forward(self, inputs: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                generator: Generator = None) -> Outputs:
        outputs = self.wav2vec2(inputs, attention_mask, generator)
        if self.training:
            outputs["projected_states"] = self.wav2vec2.project_hid(
                outputs["last_hidden_state"], generator)
            outputs["projected_quantized_features"] = self.wav2vec2.project_q(
                outputs["quantized_features"], generator)
        return outputs


def pretraining_loss(config: Wav2Vec2Config, outputs: Outputs,
                     generator: Generator = None,
                     negative_indices: Optional[torch.Tensor] = None):
    """Contrastive + weighted diversity loss (reference
    wav2vec2_dist.py:1203-1221); negatives from ``generator`` on the host
    unless ``negative_indices`` [B, K] are given.  Returns (loss, aux)."""
    logits, contrastive = losses.contrastive_loss(
        outputs["projected_states"], outputs["projected_quantized_features"],
        generator, num_negatives=config.num_negatives,
        temperature=config.contrastive_logits_temperature,
        negative_indices=negative_indices)
    diversity = losses.diversity_loss(outputs["codevector_perplexity"])
    loss = contrastive + config.diversity_loss_weight * diversity
    return loss, {"contrastive_loss": contrastive,
                  "diversity_loss": diversity, "logits": logits}


class Wav2Vec2ForCTC(nn.Module):
    def __init__(self, config: Wav2Vec2Config, real_ctc: bool = False):
        super().__init__()
        self.config = config
        self.real_ctc = real_ctc   # the stable job's real CTC loss
        self.wav2vec2 = Wav2Vec2Model(config)
        self.lm_head = Dense(config.hidden_size, config.vocab_size,
                             config.dtype)

    def forward(self, inputs: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                generator: Generator = None) -> Outputs:
        cfg = self.config
        outputs = self.wav2vec2(inputs, attention_mask, generator)
        hidden = module_dropout(outputs["last_hidden_state"],
                                cfg.hidden_dropout, self.training, generator)
        logits = self.lm_head(hidden)
        loss = None
        if self.training and labels is not None:
            if self.real_ctc:
                loss = losses.ctc_loss(
                    logits, labels, blank_id=0,
                    zero_infinity=cfg.ctc_zero_infinity,
                    reduction=cfg.ctc_loss_reduction)
            else:
                loss = losses.dummy_ctc_loss(logits)
        return {"loss": loss, "logits": logits}


class Wav2Vec2ForSequenceClassification(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.wav2vec2 = Wav2Vec2Model(config)
        self.projector = Dense(config.hidden_size, config.classifier_proj_size,
                               config.dtype)
        self.classifier = Dense(config.classifier_proj_size,
                                config.num_labels, config.dtype)

    def forward(self, inputs: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None,
                labels: Optional[torch.Tensor] = None,
                generator: Generator = None) -> Outputs:
        cfg = self.config
        hidden = self.wav2vec2(inputs, attention_mask,
                               generator)["last_hidden_state"]
        if attention_mask is not None:
            m = attention_mask[:, :, None].to(hidden.dtype)
            pooled = (hidden * m).sum(dim=1) / m.sum(dim=1)
        else:
            pooled = hidden.mean(dim=1)
        pooled = torch.tanh(self.projector(pooled))
        pooled = module_dropout(pooled, cfg.hidden_dropout, self.training,
                                generator)
        logits = self.classifier(pooled)
        loss = None
        if self.training and labels is not None:
            loss = losses.classification_loss(logits, labels)
        return {"loss": loss, "logits": logits}


def init_weights(model: nn.Module, generator: torch.Generator) -> None:
    """Random weights drawn like the JAX model's initialisers: Glorot
    uniform for Dense and conv kernels, zero biases, LayerNorm and
    GroupNorm at scale 1 and shift 0, codevectors N(0, 1), layer weights
    1 / L; drawn in f32 on the CPU generator and copied in, so one seed
    gives the same weights on every device."""
    _init_linear_conv(model, generator)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, ReferenceGroupNorm):
                module.gamma.fill_(1.0)
                module.beta.zero_()
            elif isinstance(module, Wav2Vec2Quantizer):
                cv = module.codevectors
                cv.copy_(torch.randn(cv.shape, generator=generator).to(cv))
            elif isinstance(module, Wav2Vec2Encoder) and hasattr(
                    module, "layer_weights"):
                module.layer_weights.fill_(1.0 / len(module.layers))


def create_full_model(model_type: str = "pretraining",
                      model_size: str = "small", *, device=None,
                      seed: int = 0, num_negatives: int = 100,
                      mask_time_prob: float = 0.065,
                      mask_time_length: int = 10, real_ctc: bool = False,
                      param_dtype=torch.float32, **overrides):
    """(model, config) as the reference's create_full_model
    (speech_jobs/wav2vec2_dist.py:1157-1182), with random weights from
    ``seed``, held in ``param_dtype`` (f32 master weights) on ``device``:
    the card unless the caller passes another (``require_cuda``), in eval
    mode."""
    device = require_cuda() if device is None else torch.device(device)
    config = Wav2Vec2Config.from_size(
        model_size, num_negatives=num_negatives,
        mask_time_prob=mask_time_prob, mask_time_length=mask_time_length,
        **overrides)
    with torch.device("meta"):
        if model_type == "pretraining":
            model = Wav2Vec2ForPreTraining(config)
        elif model_type == "asr":
            model = Wav2Vec2ForCTC(config, real_ctc=real_ctc)
        elif model_type == "classification":
            model = Wav2Vec2ForSequenceClassification(config)
        else:
            model = Wav2Vec2Model(config)
    model = model.to_empty(device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(param_dtype).eval(), config
