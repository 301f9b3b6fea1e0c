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

Tensor parallelism (``parallel/tp.shard_model``, the JAX package's rule
table over the "model" axis): each sharded module holds its slice of the
parameters and a ``tp`` ``Shard`` (ops/sharding.py), as Whisper's do.
q/k/v and intermediate_dense are column-parallel (a rank projects its
H / tp heads and intermediate_size / tp columns), out_proj and
output_dense row-parallel (the partial products summed over the group,
then the replicated bias added once).  Each conv of the feature encoder
gives the rank's output channels; its GroupNorm runs on them (ops/norms.py,
gamma and beta replicated), then the GELU, and the channels are gathered
before the next conv or the replicated positional conv (whose backward
sums the ranks' partial gradients where the next conv is sharded).  The
quantizer's codevectors and its input projection are sharded over the
codevectors (V): the projection's columns are gathered, each rank takes
the distances to its codevectors, and the argmin is the group's least
distance at its first index (each rank's (min, first index), agreed over
the group), so ties go as they go unsharded; ``quantized`` is the group's
sum of one-hot x shard, and the perplexity's entropy a group sum over V.
Under tensor parallelism the quantizer's ``encodings`` and ``distances``
hold the rank's codevectors' columns.  The CTC lm_head is column-parallel
over the vocab (its bias replicated) and its logits gathered.

Sequence parallelism (parallel/sp.py): under ``ops.sharding.
seq_axis_rules`` the encoder splits its [B, T, D] rows over the seq group
at its entry (the JAX hook ``seq_constrain`` at the encoder's entry), runs
every layer on its rows (attention: local queries against K and V gathered
over the group, whose backward sums the partial dk, dv), takes the
weighted layer sum on its rows, and gathers them before
``last_hidden_state`` leaves it; the feature encoder, the quantizer and
the heads run whole.  Each head declares the encoder as its
``seq_sharded`` submodule.  A shard's dropout draws the bits of its rows,
columns or heads of the unsharded tensor (ops/dropout.Window,
ops/attention.ProbsWindow), so a sharded step drops what the unsharded one
drops.

Both hold on the stacked ``scan_layers`` layout: the one layer body holds
the [L, ...] stacks of its shards (the stack dim never split) and the
group, and runs layer i on slice i of each stacked shard; under a seq
group the rows are split before the loop and checked after each layer
(JAX's scan body re-pins the seq axis at every step).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from tethys_tpu_torch import losses
from tethys_tpu_torch.configs import Wav2Vec2Config
from tethys_tpu_torch.convert import stacked
from tethys_tpu_torch.models.whisper import init_weights as _init_linear_conv
from tethys_tpu_torch.ops import sharding
from tethys_tpu_torch.ops.activations import gelu
from tethys_tpu_torch.ops.attention import ProbsWindow, multi_head_attention
from tethys_tpu_torch.ops.conv import conv1d_same
from tethys_tpu_torch.ops.dropout import Window, module_dropout
from tethys_tpu_torch.ops.masks import padding_additive_mask
from tethys_tpu_torch.ops.norms import LayerNorm, ReferenceGroupNorm
from tethys_tpu_torch.profiling.capture import record
from tethys_tpu_torch.utils.device import require_cuda

Generator = Optional[torch.Generator]
Outputs = Dict[str, torch.Tensor]
Shard = Optional[sharding.Shard]
SeqShard = Optional[sharding.SeqShard]


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


def row_parallel(layer: Dense, x: torch.Tensor, tp: Shard) -> torch.Tensor:
    """``layer(x)`` with the layer's input dim sharded over ``tp``: the
    rank's partial product summed over the group, the replicated bias
    added once."""
    if tp is None:
        return layer(x)
    dtype = layer.compute_dtype
    y = sharding.reduce_from_group(
        F.linear(x.to(dtype), layer.weight.to(dtype)), tp)
    return y + layer.bias.to(dtype)


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

    tp: Shard = None

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

    def _norm_shard(self, norm: nn.Module, y: torch.Tensor) -> torch.Tensor:
        """``norm`` on the rank's channels of a conv output: GroupNorm
        takes the shard itself (ops/norms.py); a LayerNorm over the
        channels runs on them gathered, its parameters' gradients the
        ranks' shares summed."""
        if isinstance(norm, ReferenceGroupNorm):
            return norm(y)
        tp, channels = self.tp, norm.weight.shape[0]
        whole = sharding.gather_from_group(y, -1, tp, channels,
                                           reduce_grad=True)
        out = F.layer_norm(whole, (channels,),
                           sharding.copy_to_group(norm.weight, tp).to(y.dtype),
                           sharding.copy_to_group(norm.bias, tp).to(y.dtype),
                           norm.eps)
        start, stop = sharding.shard_range(channels, tp.size, tp.rank)
        return out.narrow(-1, start, stop - start)

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """Conv ``i``, its norm and activation; under tensor parallelism
        on the rank's output channels, gathered (module doc)."""
        cfg, tp = self.config, self.tp
        conv, norm = getattr(self, f"conv_{i}"), getattr(self, f"norm_{i}")
        if tp is None:
            y = norm(conv(x))
        else:
            dtype = cfg.dtype
            bias = (None if conv.bias is None else
                    sharding.replicated_slice(conv.bias, 0, tp).to(dtype))
            y = self._norm_shard(norm, conv1d_same(
                x.to(dtype), conv.weight.to(dtype), bias, conv.stride[0]))
        y = gelu(y) if cfg.feat_extract_activation == "gelu" else F.relu(y)
        # The next conv is sharded: each rank's gradient is a partial sum.
        sharded_next = i + 1 < len(cfg.conv_dim)
        return sharding.gather_from_group(y, -1, tp, cfg.conv_dim[i],
                                          reduce_grad=sharded_next)

    def forward(self, inputs: torch.Tensor, generator: Generator = None
                ) -> torch.Tensor:
        cfg = self.config
        x = inputs[:, :, None].to(cfg.dtype)                 # [B, T, 1]
        for i in range(len(cfg.conv_dim)):
            x = self._conv(i, x)
        x = x + self.pos_conv_embed(x)
        x = self.layer_norm(x)
        return module_dropout(x, cfg.hidden_dropout, self.training, generator)


class Wav2Vec2Attention(nn.Module):
    tp: Shard = None

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        e, dtype = config.hidden_size, config.dtype
        self.q_proj = Dense(e, e, dtype)
        self.k_proj = Dense(e, e, dtype)
        self.v_proj = Dense(e, e, dtype)
        self.out_proj = Dense(e, e, dtype)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                generator: Generator = None, seq: SeqShard = None
                ) -> torch.Tensor:
        """[B, T, E] -> [B, T, E]; under tensor parallelism on the rank's
        heads; with ``seq`` x holds the rank's rows, attending to every
        rank's keys and values."""
        cfg, tp = self.config, self.tp
        b, s, e = x.shape
        head_dim = e // cfg.num_attention_heads
        heads = self.q_proj.weight.shape[0] // head_dim    # this rank's
        x = sharding.copy_to_group(x, tp)

        def split(t):  # a reshape, as the JAX model (no split kernel)
            return t.view(b, s, heads, head_dim).transpose(1, 2)

        q = split(self.q_proj(x) * head_dim ** -0.5)
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        window = ProbsWindow()
        if seq is not None:
            k = seq.gather(k, dim=2, reduce_grad=True)
            v = seq.gather(v, dim=2, reduce_grad=True)
            window = ProbsWindow(row0=seq.start, rows=seq.total)
        elif tp is not None:
            window = ProbsWindow(head0=tp.rank * heads,
                                 heads=cfg.num_attention_heads)
        attn = multi_head_attention(
            q, k, v, bias=bias, dropout_rate=cfg.attention_dropout,
            generator=generator, training=self.training, window=window)
        return row_parallel(self.out_proj,
                            attn.transpose(1, 2).reshape(b, s, -1), tp)


class Wav2Vec2FeedForward(nn.Module):
    tp: Shard = None

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.intermediate_dense = Dense(config.hidden_size,
                                        config.intermediate_size, config.dtype)
        self.output_dense = Dense(config.intermediate_size,
                                  config.hidden_size, config.dtype)

    def forward(self, x: torch.Tensor, generator: Generator = None,
                seq: SeqShard = None) -> torch.Tensor:
        cfg, tp = self.config, self.tp
        rows = Window() if seq is None else seq.window()
        cols = rows
        if tp is not None:   # intermediate_dense's columns on this rank
            start, _ = sharding.shard_range(cfg.intermediate_size, tp.size,
                                            tp.rank)
            cols = rows._replace(col0=start, cols=cfg.intermediate_size)
        x = gelu(self.intermediate_dense(sharding.copy_to_group(x, tp)))
        x = module_dropout(x, cfg.activation_dropout, self.training, generator,
                           cols)
        x = row_parallel(self.output_dense, x, tp)
        return module_dropout(x, cfg.hidden_dropout, self.training, generator,
                              rows)


class Wav2Vec2EncoderLayer(nn.Module):
    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        self.attention = Wav2Vec2Attention(config)
        self.attention_layer_norm = _layer_norm(config, config.hidden_size)
        self.feed_forward = Wav2Vec2FeedForward(config)
        self.feed_forward_layer_norm = _layer_norm(config, config.hidden_size)

    def forward(self, x: torch.Tensor, bias: Optional[torch.Tensor] = None,
                generator: Generator = None, seq: SeqShard = None
                ) -> torch.Tensor:
        """``seq``: x holds this rank's rows (sequence parallelism)."""
        rate = self.config.hidden_dropout
        rows = Window() if seq is None else seq.window()

        def dropout(t):
            return module_dropout(t, rate, self.training, generator, rows)

        if self.config.do_stable_layer_norm:      # pre-LN
            a = self.attention(self.attention_layer_norm(x), bias, generator,
                               seq)
            x = x + dropout(a)
            return x + self.feed_forward(self.feed_forward_layer_norm(x),
                                         generator, seq)
        a = self.attention(x, bias, generator, seq)    # post-LN
        x = self.attention_layer_norm(x + dropout(a))
        return self.feed_forward_layer_norm(
            x + self.feed_forward(x, generator, seq))


class Wav2Vec2Encoder(nn.Module):
    """``scan_layers``: ``layers`` is one Wav2Vec2EncoderLayer whose every
    parameter is stacked [L, ...] (flax's nn.scan'd ``layers``), and the
    forward runs its body L times, layer i on slice i of each stacked
    parameter (module doc)."""

    def __init__(self, config: Wav2Vec2Config):
        super().__init__()
        self.config = config
        if config.scan_layers:
            self.layers = Wav2Vec2EncoderLayer(config)
            for module, name, p in self._stacked():
                module._parameters[name] = nn.Parameter(
                    p.new_empty((config.num_hidden_layers, *p.shape)),
                    requires_grad=p.requires_grad)
        else:
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
        if attention_mask is not None:     # [B, 1, 1, T]: on the keys
            bias = padding_additive_mask(attention_mask, scale=-10000.0)
        rules = sharding.current_seq_rules()
        seq = None if rules is None else sharding.SeqShard(rules, x.shape[1])
        if seq is not None:
            x = seq.split(x)
        outputs = []
        for layer in self._layer_bodies():
            x = sharding.seq_constrain(layer(x, bias, generator, seq), seq)
            outputs.append(x)
        if self.config.use_weighted_layer_sum:
            weights = torch.softmax(self.layer_weights, dim=-1).to(x.dtype)
            x = torch.einsum("l,lbth->bth", weights, torch.stack(outputs))
        if seq is not None:
            x = seq.gather(x)
        return {"last_hidden_state": x}

    def _stacked(self):
        """(module, name, parameter) of the layer body's parameters
        (stacked under ``scan_layers``), in ``named_parameters`` order."""
        return [(module, name, p) for module in self.layers.modules()
                for name, p in module._parameters.items()]

    def _layer_bodies(self):
        """The layers, in order.  Under ``scan_layers`` the one body, with
        slice i of every stacked parameter in place while layer i runs:
        the stacks are unbound once a forward, so their gradient is one
        ``stack`` of the slices' (``stacked[i]`` per layer would add L
        full-size zero-padded gradients), and the generator's draws come
        in the unrolled order."""
        if not self.config.scan_layers:
            yield from self.layers
            return
        stacked = self._stacked()
        slices = [p.unbind(0) for _, _, p in stacked]
        try:
            for i in range(self.config.num_hidden_layers):
                for (module, name, _), layer_slices in zip(stacked, slices):
                    module._parameters[name] = layer_slices[i]
                yield self.layers
        finally:
            for module, name, p in stacked:
                module._parameters[name] = p


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

    census_skip = ("indices",)   # the port's extra output (chip_smoke.py)
    tp: Shard = None

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

    def _first_min(self, distances: torch.Tensor, start: int
                   ) -> torch.Tensor:
        """The index of the least distance, the first on ties: under
        tensor parallelism (this rank's codevectors from ``start``) each
        rank's (min, first index), gathered, and the least at the first
        rank (whose indices are the lower) taken on every rank."""
        local = distances.argmin(dim=-1)                   # first on ties
        tp = self.tp
        if tp is None:
            return local
        least = distances.gather(-1, local[..., None])[..., 0]
        # The indices are exact in f32 (V < 2^24): one gather for both.
        mine = torch.stack((least, (local + start).float()))[None]
        every = sharding.all_gather(mine, 0, tp, tp.size)  # [tp, 2, G, BT]
        owner = every[:, 0].argmin(dim=0)                  # first on ties
        return every[:, 1].gather(0, owner[None])[0].long()

    def forward(self, hidden_states: torch.Tensor) -> Outputs:
        cfg, tp = self.config, self.tp
        groups = cfg.num_codevector_groups
        codevectors = self.codevectors.float()   # [G, V, d]: the rank's V
        vectors = codevectors.shape[1]
        # Column-parallel (weight and bias sharded), the columns gathered.
        projected = sharding.gather_from_group(
            self.project_to_codevector_dim(
                sharding.copy_to_group(hidden_states, tp)),
            -1, tp, cfg.codevector_dim)
        b, t, _ = projected.shape
        # [G, B*T, d]
        h = projected.float().view(b * t, groups, -1).transpose(0, 1)
        # |h - c|^2 = |h|^2 - 2 h.c + |c|^2: one matmul per group.
        distances = (h.square().sum(dim=-1, keepdim=True)
                     - 2.0 * torch.bmm(h, codevectors.transpose(1, 2))
                     + codevectors.square().sum(dim=-1)[:, None, :])
        start = 0 if tp is None else sharding.shard_range(
            cfg.num_codevectors_per_group, tp.size, tp.rank)[0]
        indices = self._first_min(distances, start)        # [G, BT]
        # The rank's codevectors: one-hot where it owns the index.
        local = indices - start
        owned = (local >= 0) & (local < vectors)
        encodings = (F.one_hot(local.clamp(0, vectors - 1), vectors)
                     * owned[..., None]).float()           # [G, BT, V]
        quantized = sharding.reduce_from_group(
            torch.bmm(encodings, codevectors), tp)         # [G, BT, d]
        quantized = quantized.transpose(0, 1).reshape(b, t, cfg.codevector_dim)
        avg_probs = encodings.mean(dim=1).clamp(1e-10, 1.0)            # [G, V]
        entropy = sharding.reduce_from_group(
            (avg_probs * torch.log(avg_probs + 1e-10)).sum(dim=-1), tp)
        perplexity = torch.exp(-entropy).mean()
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

    # The quantizer's argmin indices and distances, which the JAX model
    # does not return; chip_smoke.py compares them card against CPU.
    census_skip = ("codevector_indices", "codevector_distances")

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
        record(self, hidden, name="feature_projection_dropout")
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


# The submodule of each head that runs on a rank's rows under sequence
# parallelism: its parameters' gradients are partial sums over the seq
# group (parallel/dp.py).
SEQ_SHARDED = ("wav2vec2.encoder",)


class Wav2Vec2ForPreTraining(nn.Module):
    census_skip = Wav2Vec2Model.census_skip
    seq_sharded = SEQ_SHARDED

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
    seq_sharded = SEQ_SHARDED
    tp: Shard = None

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
        record(self, hidden, name="dropout")
        logits = self._logits(hidden)
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

    def _logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """[B, T, vocab]; under tensor parallelism each rank's columns of
        the vocab (the kernel sharded, its bias replicated), gathered."""
        tp = self.tp
        if tp is None:
            return self.lm_head(hidden)
        dtype = self.config.dtype
        logits = F.linear(
            sharding.copy_to_group(hidden, tp).to(dtype),
            self.lm_head.weight.to(dtype),
            sharding.replicated_slice(self.lm_head.bias, 0, tp).to(dtype))
        return sharding.gather_from_group(logits, -1, tp,
                                          self.config.vocab_size)


class Wav2Vec2ForSequenceClassification(nn.Module):
    seq_sharded = SEQ_SHARDED

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
        record(self, pooled, name="dropout")
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
                module.layer_weights.fill_(
                    1.0 / module.config.num_hidden_layers)


# An unrolled encoder layer's state_dict key: (encoder prefix, index, leaf).
_LAYER_KEY = re.compile(r"^((?:.*\.)?encoder\.layers)\.(\d+)\.(.+)$")


def stack_layer_params(state: Mapping[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """An unrolled state dict (``...encoder.layers.{i}.<leaf>``) -> the
    ``scan_layers`` one (``...encoder.layers.<leaf>``, the layers stacked
    [L, ...] in order, where layer 0's leaf stood); other keys untouched
    (JAX ``stack_layer_params``)."""
    out, layers = {}, {}
    for key, value in state.items():
        m = _LAYER_KEY.match(key)
        if m is None:
            out[key] = value
            continue
        stacked_key = f"{m.group(1)}.{m.group(3)}"
        if stacked_key not in layers:
            layers[stacked_key] = {}
            out[stacked_key] = None             # holds the place
        layers[stacked_key][int(m.group(2))] = value
    for key, by_index in layers.items():
        out[key] = torch.stack([by_index[i] for i in range(len(by_index))])
    return out


def unstack_layer_params(state: Mapping[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """The inverse of ``stack_layer_params``: each stacked leaf's slices
    (views) under ``...encoder.layers.{i}.<leaf>``, layer by layer, where
    the stack stood."""
    out, pending = {}, []

    def flush():
        for i in range(pending[0][1].shape[0] if pending else 0):
            for (prefix, leaf), value in pending:
                out[f"{prefix}.{i}.{leaf}"] = value[i]
        pending.clear()

    for key, value in state.items():
        prefix, _, leaf = key.partition(".layers.")
        if leaf and prefix.split(".")[-1] == "encoder" and stacked(
                key.split(".")):
            pending.append(((prefix + ".layers", leaf), value))
            continue
        flush()
        out[key] = value
    flush()
    return out


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
    def build(config):
        with torch.device("meta"):
            if model_type == "pretraining":
                return Wav2Vec2ForPreTraining(config)
            if model_type == "asr":
                return Wav2Vec2ForCTC(config, real_ctc=real_ctc)
            if model_type == "classification":
                return Wav2Vec2ForSequenceClassification(config)
            return Wav2Vec2Model(config)

    # The weights are drawn unrolled, so scan_layers stacks the same ones.
    model = build(dataclasses.replace(config, scan_layers=False))
    model = model.to_empty(device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    if config.scan_layers:
        state = stack_layer_params(model.state_dict())
        model = build(config)
        model.load_state_dict(state, assign=True)
    return model.to(param_dtype).eval(), config
