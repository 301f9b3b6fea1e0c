"""Plain float32 reference of one Wav2Vec2 contrastive pretraining step.

The architecture, as the configuration states it: the feature encoder's
convolutions with TF SAME padding and no bias, each followed by a GroupNorm
of ``num_conv_pos_embedding_groups`` groups (moments over time and the
group's channels jointly, eps 1e-5) and exact GELU; the grouped positional
convolution added; LayerNorm; dropout; the projection to the hidden size,
LayerNorm, dropout; encoder layers, post-LN (each sublayer's residual sum
then its LayerNorm) or, under ``do_stable_layer_norm``, pre-LN, with
dropout on the attention probabilities, on the attention output, after the
FFN's GELU and after its output; the hard product quantizer of the
projected features (squared distances, the first least one, one-hot, the
frozen codebook; no gradient passes it); the two projection heads with
LayerNorm and dropout.  The loss is InfoNCE against the quantized target
at each frame with ``num_negatives`` negatives a row (one set of frames a
row, the top-k of uniform draws over the frames), at temperature
``contrastive_logits_temperature``, plus ``diversity_loss_weight`` times
minus the codebook perplexity over the whole batch.

Each step first draws its negatives, then its dropout seeds, from the
step's generator.  The step runs in blocks of rows (see reference/whisper).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from tethys_bench.reference.common import (
    FLOAT32,
    Precision,
    SeedTape,
    attention,
    conv1d_same,
    dropout,
    gelu,
    layer_norm,
    linear,
    row_offset,
)


def frames(cfg: dict, samples: int) -> int:
    for stride in cfg["conv_stride"]:
        samples = -(-samples // stride)
    return samples


def param_spec(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, initialiser) of every parameter: Glorot uniform for
    kernels (a convolution's width counted in both fans), zero biases, unit
    norm scales, the codebook N(0, 1)."""
    fe, w = "wav2vec2.feature_extractor", "wav2vec2"
    spec, channels = [], 1
    for i, (dim, k) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"])):
        spec += [(f"{fe}.conv_{i}.weight", (dim, channels, k),
                  ("glorot", channels * k, dim * k)),
                 (f"{fe}.norm_{i}.gamma", (dim,), ("ones",)),
                 (f"{fe}.norm_{i}.beta", (dim,), ("zeros",))]
        channels = dim
    k, g = cfg["num_conv_pos_embeddings"], cfg["num_conv_pos_embedding_groups"]
    spec += [(f"{fe}.pos_conv_embed.weight", (channels, channels // g, k),
              ("glorot", channels // g * k, channels * k)),
             (f"{fe}.pos_conv_embed.bias", (channels,), ("zeros",))]

    def dense(name, n_in, n_out):
        return [(f"{name}.weight", (n_out, n_in), ("glorot", n_in, n_out)),
                (f"{name}.bias", (n_out,), ("zeros",))]

    def norm(name, n, gain=None):
        return [(f"{name}.weight", (n,),
                 ("ones",) if gain is None else ("const", gain)),
                (f"{name}.bias", (n,), ("zeros",))]

    e, ff = cfg["hidden_size"], cfg["intermediate_size"]
    spec += norm(f"{fe}.layer_norm", channels)
    spec += dense(f"{w}.feature_projection", channels, e)
    spec += norm(f"{w}.feature_projection_layer_norm", e)
    for i in range(cfg["num_hidden_layers"]):
        p = f"{w}.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            spec += dense(f"{p}.attention.{proj}", e, e)
        spec += norm(f"{p}.attention_layer_norm", e)
        spec += dense(f"{p}.feed_forward.intermediate_dense", e, ff)
        spec += dense(f"{p}.feed_forward.output_dense", ff, e)
        spec += norm(f"{p}.feed_forward_layer_norm", e)
    groups, cd = cfg["num_codevector_groups"], cfg["codevector_dim"]
    spec.append((f"{w}.quantizer.codevectors",
                 (groups, cfg["num_codevectors_per_group"], cd // groups),
                 ("normal",)))
    spec += dense(f"{w}.quantizer.project_to_codevector_dim", e, cd)
    pd = cfg["proj_codevector_dim"]
    gain = cfg.get("projection_norm_gain")
    spec += dense(f"{w}.project_hid.projection_head", e, pd)
    spec += norm(f"{w}.project_hid.layer_norm", pd, gain)
    spec += dense(f"{w}.project_q.projection_head", cd, pd)
    spec += norm(f"{w}.project_q.layer_norm", pd, gain)
    return spec


def frozen(cfg: dict) -> Tuple[str, ...]:
    """The parameters the configuration holds still."""
    return (("wav2vec2.quantizer.codevectors",)
            if cfg["freeze_codevectors"] else ())


def negative_indices(generator: torch.Generator, batch: int, length: int,
                     num_negatives: int) -> torch.Tensor:
    """[B, K] frames: the top-k of -draws for [B, T] uniform draws in [0,
    T), k = max(min(K, T - 1), 1), repeat-tiled up to K."""
    actual = max(min(num_negatives, length - 1), 1)
    draws = torch.randint(0, length, (batch, length), generator=generator)
    top = torch.topk(-draws.float(), actual, dim=1).indices
    if actual < num_negatives:
        top = top.repeat(1, -(-num_negatives // actual))
    return top[:, :num_negatives]


def group_norm(x, gamma, beta, groups: int, eps: float = 1e-5):
    """x [b, C, T]: moments over the group's channels and time jointly."""
    b, c, t = x.shape
    xg = x.view(b, groups, c // groups, t)
    mean = xg.mean(dim=(2, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(2, 3), keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).view(b, c, t)
    return y * gamma[:, None] + beta[:, None]


class _Block:
    def __init__(self, P, cfg, prec: Precision, tape: SeedTape, row0: int,
                 batch: int):
        self.P, self.cfg, self.prec, self.tape = P, cfg, prec, tape
        self.row0, self.batch = row0, batch

    def drop(self, x, rate, full_shape):
        if rate <= 0.0:
            return x
        return dropout(x, rate, self.tape.next(),
                       row_offset(full_shape, self.row0))

    def norm(self, x, name):
        return layer_norm(x, self.P[f"{name}.weight"], self.P[f"{name}.bias"],
                          self.cfg["layer_norm_eps"])

    def lin(self, x, name):
        return linear(x, self.P[f"{name}.weight"], self.P[f"{name}.bias"],
                      self.prec)

    def features(self, audio):
        cfg, P = self.cfg, self.P
        fe = "wav2vec2.feature_extractor"
        groups = cfg["num_conv_pos_embedding_groups"]
        x = audio[:, None, :]
        for i, stride in enumerate(cfg["conv_stride"]):
            x = conv1d_same(x, P[f"{fe}.conv_{i}.weight"], None, stride, 1,
                            self.prec)
            x = gelu(group_norm(x, P[f"{fe}.norm_{i}.gamma"],
                                P[f"{fe}.norm_{i}.beta"], groups))
        x = x + conv1d_same(x, P[f"{fe}.pos_conv_embed.weight"],
                            P[f"{fe}.pos_conv_embed.bias"], 1, groups,
                            self.prec)
        x = self.norm(x.transpose(1, 2), f"{fe}.layer_norm")
        return self.drop(x, cfg["hidden_dropout"],
                         (self.batch, *x.shape[1:]))

    def quantize(self, hidden):
        """(quantized [b, T, cd], code counts [G, V])."""
        cfg, P = self.cfg, self.P
        groups = cfg["num_codevector_groups"]
        cv = P["wav2vec2.quantizer.codevectors"]
        vectors = cv.shape[1]
        projected = self.lin(hidden, "wav2vec2.quantizer."
                                     "project_to_codevector_dim")
        b, t, cd = projected.shape
        h = projected.reshape(b * t, groups, -1).transpose(0, 1)
        distances = (h.square().sum(dim=-1, keepdim=True)
                     - 2.0 * self.prec.out(torch.bmm(
                         self.prec(h), self.prec(cv).transpose(1, 2)))
                     + cv.square().sum(dim=-1)[:, None, :])
        onehot = F.one_hot(distances.argmin(dim=-1), vectors).float()
        quantized = self.prec.out(torch.bmm(self.prec(onehot), self.prec(cv)))
        return (quantized.transpose(0, 1).reshape(b, t, cd),
                onehot.sum(dim=1))

    def encoder(self, x):
        cfg = self.cfg
        e, heads = cfg["hidden_size"], cfg["num_attention_heads"]
        hd = e // heads
        b, t, _ = x.shape
        rate = cfg["hidden_dropout"]
        pre = cfg["do_stable_layer_norm"]
        for i in range(cfg["num_hidden_layers"]):
            p = f"wav2vec2.encoder.layers.{i}"
            h = self.norm(x, f"{p}.attention_layer_norm") if pre else x

            def split(z):
                return z.view(b, t, heads, hd).transpose(1, 2)

            q = split(self.lin(h, f"{p}.attention.q_proj") * hd ** -0.5)
            k = split(self.lin(h, f"{p}.attention.k_proj"))
            v = split(self.lin(h, f"{p}.attention.v_proj"))
            arate = cfg["attention_dropout"]
            seed = self.tape.next() if arate > 0.0 else 0
            o = attention(q, k, v, arate, seed,
                          row_offset((self.batch, heads, t, t), self.row0),
                          self.prec)
            a = self.lin(o.transpose(1, 2).reshape(b, t, e),
                         f"{p}.attention.out_proj")
            x = x + self.drop(a, rate, (self.batch, t, e))
            if not pre:
                x = self.norm(x, f"{p}.attention_layer_norm")
            h = self.norm(x, f"{p}.feed_forward_layer_norm") if pre else x
            h = gelu(self.lin(h, f"{p}.feed_forward.intermediate_dense"))
            h = self.drop(h, cfg["activation_dropout"],
                          (self.batch, t, cfg["intermediate_size"]))
            h = self.lin(h, f"{p}.feed_forward.output_dense")
            x = x + self.drop(h, rate, (self.batch, t, e))
            if not pre:
                x = self.norm(x, f"{p}.feed_forward_layer_norm")
        return x

    def head(self, x, name):
        x = self.norm(self.lin(x, f"{name}.projection_head"),
                      f"{name}.layer_norm")
        return self.drop(x, self.cfg["hidden_dropout"],
                         (self.batch, *x.shape[1:]))

    def loss(self, audio, negatives):
        """(this block's share of the mean contrastive loss, code counts)."""
        cfg = self.cfg
        w = "wav2vec2"
        x = self.features(audio)
        hidden = self.norm(self.lin(x, f"{w}.feature_projection"),
                           f"{w}.feature_projection_layer_norm")
        hidden = self.drop(hidden, cfg["hidden_dropout"],
                           (self.batch, *hidden.shape[1:]))
        quantized, counts = self.quantize(hidden)
        states = self.encoder(hidden)
        h = self.head(states, f"{w}.project_hid")
        q = self.head(quantized, f"{w}.project_q")
        temp = cfg["contrastive_logits_temperature"]
        b, t, d = h.shape
        pos = (h * q).sum(dim=-1) / temp
        neg_q = torch.gather(q, 1, negatives[:, :, None].expand(-1, -1, d))
        neg = self.prec.out(torch.bmm(self.prec(h),
                                      self.prec(neg_q).transpose(1, 2))) / temp
        logits = torch.cat([pos[:, :, None], neg], dim=2)
        ce = F.cross_entropy(logits.reshape(b * t, -1),
                             torch.zeros(b * t, dtype=torch.long,
                                         device=h.device), reduction="sum")
        return ce / (self.batch * t), counts


def loss_and_grads(params: Dict[str, torch.Tensor], batch,
                   generator: torch.Generator, cfg: dict,
                   prec: Precision = FLOAT32, block_rows: int = 0,
                   rows: int = 0):
    """(loss, {name: gradient}) of one step on ``batch`` = (audio [B, S]
    float32, labels) on the device, the negatives and dropout seeds drawn
    from ``generator``; the NaN scrub of the step applied to the loss.
    ``rows`` (default all) takes only the first rows, as their own batch."""
    audio = batch[0]
    batch_rows = rows or audio.shape[0]
    block_rows = block_rows or batch_rows
    t = frames(cfg, audio.shape[1])
    negatives = negative_indices(generator, batch_rows, t,
                                 cfg["num_negatives"]).to(audio.device)
    still = frozen(cfg)
    leaves = {n: p.detach().clone().requires_grad_(n not in still)
              for n, p in params.items()}
    tape = SeedTape(generator)
    total = torch.zeros((), device=audio.device)
    counts = 0
    for row0 in range(0, batch_rows, block_rows):
        row1 = min(row0 + block_rows, batch_rows)
        tape.rewind()
        block = _Block(leaves, cfg, prec, tape, row0, batch_rows)
        part, block_counts = block.loss(audio[row0:row1],
                                        negatives[row0:row1])
        part.backward()
        total += part.detach()
        counts = counts + block_counts
    avg = (counts / (batch_rows * t)).clamp(1e-10, 1.0)
    perplexity = torch.exp(-(avg * torch.log(avg + 1e-10)).sum(-1)).mean()
    loss = total - cfg["diversity_loss_weight"] * perplexity
    loss = torch.where(torch.isnan(loss), torch.zeros_like(loss), loss)
    grads = {n: p.grad for n, p in leaves.items() if p.grad is not None}
    return float(loss), grads
