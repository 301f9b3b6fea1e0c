"""Plain float32 reference of one Whisper training step.

The architecture, as the configuration states it: conv1 (k 3, stride 1) and
conv2 (k 3, stride 2) with TF SAME padding and exact GELU; sinusoidal
positions; pre-LN encoder and decoder layers (eps from the configuration)
with a bias on every attention projection and the query scaled by
head_dim^-0.5 after its bias; a final LayerNorm on each side; an lm_head
without bias.  Dropout at the encoder input, the decoder input, after fc2
and on the attention probabilities (``dropout``, ``attention_dropout``;
``activation_dropout`` after the GELU of the FFN where it is nonzero).  The
loss is the cross-entropy of logits[:, :-1] against labels[:, 1:] over
every position, after the labels are right-shifted behind
``decoder_start_token_id`` to make the decoder's input.

The step runs in blocks of rows: each block's loss is its share of the
whole batch's mean, so the gradients summed over the blocks are the whole
batch's; each block's dropout draws the bits of its rows of the whole
tensor.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
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

NEG_INF = -1e30


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    """[max_len, d_model]: even dims sin, odd dims cos of
    pos / 10000^(2i / d_model)."""
    pe = np.zeros((max_len, d_model), dtype=np.float64)
    position = np.arange(0, max_len)[:, np.newaxis]
    div_term = np.exp(np.arange(0, d_model, 2) * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe.astype(np.float32)


def _attn_names(prefix: str, d: int):
    out = []
    for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
        out += [(f"{prefix}.{proj}.weight", (d, d), ("glorot", d, d)),
                (f"{prefix}.{proj}.bias", (d,), ("zeros",))]
    return out


def _norm(prefix: str, d: int):
    return [(f"{prefix}.weight", (d,), ("ones",)),
            (f"{prefix}.bias", (d,), ("zeros",))]


def _ffn(prefix: str, d: int, ff: int):
    return [(f"{prefix}.fc1.weight", (ff, d), ("glorot", d, ff)),
            (f"{prefix}.fc1.bias", (ff,), ("zeros",)),
            (f"{prefix}.fc2.weight", (d, ff), ("glorot", ff, d)),
            (f"{prefix}.fc2.bias", (d,), ("zeros",))]


def param_spec(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, initialiser) of every parameter: Glorot uniform
    (fan in, fan out, the kernel's width counted in both) for the kernels,
    U(-0.05, 0.05) for the embedding, zero biases, unit LayerNorm scales."""
    d, ff, mels = cfg["d_model"], cfg["d_ff"], cfg["n_mels"]
    vocab = cfg["vocab_size"]
    enc, dec = "model.encoder", "model.decoder"
    spec = [
        (f"{enc}.conv1.weight", (d, mels, 3), ("glorot", mels * 3, d * 3)),
        (f"{enc}.conv1.bias", (d,), ("zeros",)),
        (f"{enc}.conv2.weight", (d, d, 3), ("glorot", d * 3, d * 3)),
        (f"{enc}.conv2.bias", (d,), ("zeros",)),
    ]
    for i in range(cfg["encoder_layers"]):
        p = f"{enc}.layers.{i}"
        spec += (_norm(f"{p}.self_attn_layer_norm", d)
                 + _attn_names(f"{p}.self_attn", d)
                 + _norm(f"{p}.final_layer_norm", d)
                 + _ffn(f"{p}.feed_forward", d, ff))
    spec += _norm(f"{enc}.layer_norm", d)
    spec.append((f"{dec}.embed_tokens.weight", (vocab, d), ("uniform", 0.05)))
    for i in range(cfg["decoder_layers"]):
        p = f"{dec}.layers.{i}"
        spec += (_norm(f"{p}.self_attn_layer_norm", d)
                 + _attn_names(f"{p}.self_attn", d)
                 + _norm(f"{p}.encoder_attn_layer_norm", d)
                 + _attn_names(f"{p}.encoder_attn", d)
                 + _norm(f"{p}.final_layer_norm", d)
                 + _ffn(f"{p}.feed_forward", d, ff))
    spec += _norm(f"{dec}.layer_norm", d)
    spec.append(("lm_head.weight", (vocab, d), ("glorot", d, vocab)))
    return spec


class _Block:
    """One block of rows [row0, row0 + b) of a batch of ``batch`` rows."""

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

    def lin(self, x, name, bias=True):
        return linear(x, self.P[f"{name}.weight"],
                      self.P[f"{name}.bias"] if bias else None, self.prec)

    def attn(self, x, name, heads, kv=None, bias=None):
        cfg = self.cfg
        d = cfg["d_model"]
        hd = d // heads
        b, tq, _ = x.shape
        kv = x if kv is None else kv
        tk = kv.shape[1]

        def split(t, n):
            return t.view(b, n, heads, hd).transpose(1, 2)

        q = split(self.lin(x, f"{name}.q_proj") * hd ** -0.5, tq)
        k = split(self.lin(kv, f"{name}.k_proj"), tk)
        v = split(self.lin(kv, f"{name}.v_proj"), tk)
        rate = cfg["attention_dropout"]
        seed = self.tape.next() if rate > 0.0 else 0
        o = attention(q, k, v, rate, seed,
                      row_offset((self.batch, heads, tq, tk), self.row0),
                      self.prec, bias)
        return self.lin(o.transpose(1, 2).reshape(b, tq, d),
                        f"{name}.out_proj")

    def ffn(self, x, name):
        cfg = self.cfg
        b, t, _ = x.shape
        h = gelu(self.lin(x, f"{name}.fc1"))
        h = self.drop(h, cfg["activation_dropout"], (self.batch, t,
                                                     cfg["d_ff"]))
        return self.drop(self.lin(h, f"{name}.fc2"), cfg["dropout"],
                         (self.batch, t, cfg["d_model"]))

    def encoder(self, features):
        cfg, P = self.cfg, self.P
        enc = "model.encoder"
        x = gelu(conv1d_same(features, P[f"{enc}.conv1.weight"],
                             P[f"{enc}.conv1.bias"], 1, 1, self.prec))
        x = gelu(conv1d_same(x, P[f"{enc}.conv2.weight"],
                             P[f"{enc}.conv2.bias"], 2, 1, self.prec))
        x = x.transpose(1, 2)
        t, d = x.shape[1], cfg["d_model"]
        pe = torch.from_numpy(sinusoidal_table(cfg["n_ctx"], d)).to(x.device)
        x = self.drop(x + pe[:t], cfg["dropout"], (self.batch, t, d))
        for i in range(cfg["encoder_layers"]):
            p = f"{enc}.layers.{i}"
            x = x + self.attn(self.norm(x, f"{p}.self_attn_layer_norm"),
                              f"{p}.self_attn", cfg["encoder_attention_heads"])
            x = x + self.ffn(self.norm(x, f"{p}.final_layer_norm"),
                             f"{p}.feed_forward")
        return self.norm(x, f"{enc}.layer_norm")

    def decoder(self, ids, enc_out):
        cfg, P = self.cfg, self.P
        dec = "model.decoder"
        t, d = ids.shape[1], cfg["d_model"]
        pe = torch.from_numpy(sinusoidal_table(cfg["max_target_positions"],
                                               d)).to(enc_out.device)
        x = F.embedding(ids, P[f"{dec}.embed_tokens.weight"]) + pe[:t]
        x = self.drop(x, cfg["dropout"], (self.batch, t, d))
        causal = torch.ones(t, t, device=x.device).tril()
        bias = ((1.0 - causal) * NEG_INF)[None, None]
        heads = cfg["decoder_attention_heads"]
        for i in range(cfg["decoder_layers"]):
            p = f"{dec}.layers.{i}"
            x = x + self.attn(self.norm(x, f"{p}.self_attn_layer_norm"),
                              f"{p}.self_attn", heads, bias=bias)
            x = x + self.attn(self.norm(x, f"{p}.encoder_attn_layer_norm"),
                              f"{p}.encoder_attn", heads, kv=enc_out)
            x = x + self.ffn(self.norm(x, f"{p}.final_layer_norm"),
                             f"{p}.feed_forward")
        return self.norm(x, f"{dec}.layer_norm")

    def loss(self, features, labels):
        """This block's share of the batch's mean cross-entropy."""
        cfg = self.cfg
        start = torch.full((labels.shape[0], 1),
                           cfg["decoder_start_token_id"], dtype=labels.dtype,
                           device=labels.device)
        ids = torch.cat([start, labels[:, :-1]], dim=1).long()
        hidden = self.decoder(ids, self.encoder(features))
        logits = linear(hidden, self.P["lm_head.weight"], None, self.prec)
        ce = F.cross_entropy(
            logits[:, :-1].reshape(-1, logits.shape[-1]),
            labels[:, 1:].reshape(-1).long(), reduction="sum")
        return ce / (self.batch * (labels.shape[1] - 1))


def loss_and_grads(params: Dict[str, torch.Tensor], batch,
                   generator: torch.Generator, cfg: dict,
                   prec: Precision = FLOAT32, block_rows: int = 0,
                   rows: int = 0):
    """(loss, {name: gradient}) of one step on ``batch`` = (features [B,
    n_mels, T] float32, labels [B, L] int) on the device, the dropout
    seeds drawn from ``generator``.  ``rows`` (default all) takes only the
    first rows of the batch, as their own batch."""
    features, labels = batch
    batch_rows = rows or features.shape[0]
    block_rows = block_rows or batch_rows
    leaves = {n: p.detach().clone().requires_grad_(True)
              for n, p in params.items()}
    tape = SeedTape(generator)
    total = torch.zeros((), device=features.device)
    for row0 in range(0, batch_rows, block_rows):
        row1 = min(row0 + block_rows, batch_rows)
        tape.rewind()
        block = _Block(leaves, cfg, prec, tape, row0, batch_rows)
        part = block.loss(features[row0:row1], labels[row0:row1])
        part.backward()
        total += part.detach()
    grads = {n: p.grad for n, p in leaves.items() if p.grad is not None}
    return float(total), grads
