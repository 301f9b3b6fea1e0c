"""The yardstick's arithmetic: the chip's peaks, a training step's model
FLOPs, and the least work of the kernels whose roofline share is read.

Model FLOPs count every product (matmul, batched matmul, convolution) of
the forward and of the backward that autograd runs on the plain
reference, once each, as 2 * M * N * K (a convolution as its output
elements times 2 * C_in / groups * kernel); nothing recomputed.  The
backward of a product takes the gradient of each operand that needs one:
every activation that a trained parameter feeds, and every trained
parameter.  So the first convolution of each model and the products
behind Wav2Vec2's quantizer take no input gradient, and the quantizer's
distances and codebook lookup none at all.

A roofline share is the least time of the work (the larger of its
operations over the peak rate and its bytes over the peak bandwidth, each
input read once and each output written once) over the time the kernels
took.
"""

from __future__ import annotations

from typing import List, NamedTuple

# One NVIDIA H100 SXM, dense (NVIDIA's data sheet, at 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# The port's gate for its flash kernels (a query of at least 16 rows and
# either sequence at least 512), as the program states it.
FLASH_MIN_TQ = 16
FLASH_MIN_SEQ = 512


def _mm(m: int, n: int, k: int) -> float:
    return 2.0 * m * n * k


def _trained(forward: float, input_grad: bool = True,
             weight_grad: bool = True) -> float:
    return forward * (1 + int(input_grad) + int(weight_grad))


def whisper_step_flops(cfg: dict, batch: int, frames: int,
                       label_len: int) -> float:
    """Model FLOPs of one Whisper training step (forward and backward)."""
    d, ff, vocab = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    t = -(-frames // 2)
    rows_e, rows_d = batch * t, batch * label_len
    total = _trained(_mm(batch * frames, d, cfg["n_mels"] * 3),
                     input_grad=False)
    total += _trained(_mm(rows_e, d, d * 3))
    attn_e = 2 * _mm(batch * t, t, d)          # QK^T and PV over all heads
    total += cfg["encoder_layers"] * _trained(
        4 * _mm(rows_e, d, d) + 2 * _mm(rows_e, ff, d) + attn_e)
    per_dec = (4 * _mm(rows_d, d, d)                       # self q k v out
               + 2 * _mm(rows_d, d, d) + 2 * _mm(rows_e, d, d)  # cross
               + 2 * _mm(rows_d, ff, d)
               + 2 * _mm(batch * label_len, label_len, d)
               + 2 * _mm(batch * label_len, t, d))
    total += cfg["decoder_layers"] * _trained(per_dec)
    total += _trained(_mm(rows_d, vocab, d))
    return total


def wav2vec2_step_flops(cfg: dict, batch: int, samples: int) -> float:
    """Model FLOPs of one Wav2Vec2 pretraining step."""
    total, length, channels = 0.0, samples, 1
    for i, (dim, k, s) in enumerate(zip(cfg["conv_dim"], cfg["conv_kernel"],
                                        cfg["conv_stride"])):
        length = -(-length // s)
        total += _trained(_mm(batch * length, dim, channels * k),
                          input_grad=i > 0)
        channels = dim
    t, rows = length, batch * length
    g = cfg["num_conv_pos_embedding_groups"]
    total += _trained(_mm(rows, channels,
                          channels // g * cfg["num_conv_pos_embeddings"]))
    e, ff = cfg["hidden_size"], cfg["intermediate_size"]
    total += _trained(_mm(rows, e, channels))
    total += cfg["num_hidden_layers"] * _trained(
        4 * _mm(rows, e, e) + 2 * _mm(rows, ff, e) + 2 * _mm(rows, t, e))
    cd, pd = cfg["codevector_dim"], cfg["proj_codevector_dim"]
    vectors = cfg["num_codevectors_per_group"]
    groups = cfg["num_codevector_groups"]
    total += _mm(rows, cd, e)                       # projection, no grad
    total += 2 * groups * _mm(rows, vectors, cd // groups)  # distances, lookup
    total += _trained(_mm(rows, pd, e))             # project_hid
    total += _trained(_mm(rows, pd, cd), input_grad=False)  # project_q
    total += _trained(_mm(rows, cfg["num_negatives"], pd))  # negatives
    return total


class Work(NamedTuple):
    flops: float
    bytes: float

    def seconds(self) -> float:
        return max(self.flops / PEAK_BF16_FLOPS, self.bytes / PEAK_BYTES)


def flash_active(tq: int, tk: int) -> bool:
    return tq >= FLASH_MIN_TQ and (tq >= FLASH_MIN_SEQ or tk >= FLASH_MIN_SEQ)


def flash_work(bh: int, tq: int, tk: int, d: int, elem: int = 2
               ) -> List[Work]:
    """[forward, backward] of one flash site over bh batch-heads.  The
    forward: S = Q K^T and O = P V (2 products); reads Q, K, V, writes O
    and the f32 log-sum-exp.  The backward: S again, dV = P^T dO, dP =
    dO V^T, dK = dS^T Q, dQ = dS K (5 products); reads Q, K, V, O, dO and
    the log-sum-exp, writes dQ, dK, dV."""
    prod = _mm(bh * tq, tk, d)
    q, kv = bh * tq * d * elem, bh * tk * d * elem
    lse = bh * tq * 4
    return [Work(2 * prod, q + 2 * kv + q + lse),
            Work(5 * prod, 3 * q + 2 * kv + lse + q + 2 * kv)]


def whisper_flash_work(cfg: dict, batch: int, frames: int,
                       label_len: int) -> List[Work]:
    """The flash work of one Whisper step: each encoder layer's
    self-attention and each decoder layer's cross-attention where the gate
    takes them (decoder self-attention at 100 positions does not)."""
    t = -(-frames // 2)
    out = []
    for layers, heads, tq, tk in (
            (cfg["encoder_layers"], cfg["encoder_attention_heads"], t, t),
            (cfg["decoder_layers"], cfg["decoder_attention_heads"],
             label_len, t),
            (cfg["decoder_layers"], cfg["decoder_attention_heads"],
             label_len, label_len)):
        if cfg.get("use_flash_attention", True) and flash_active(tq, tk):
            out += layers * flash_work(batch * heads, tq, tk,
                                       cfg["d_model"] // heads)
    return out


def group_norm_work(batch: int, length: int, channels: int,
                    elem: int = 2) -> List[Work]:
    """[forward, backward] of one GroupNorm over [batch, length,
    channels]: the forward reads x and writes y, the backward reads x and
    dy and writes dx (the moments, scales and sums are a few bytes a
    group); bound by bytes, its operations a tenth of that at the peak."""
    n = batch * length * channels * elem
    return [Work(0.0, 2 * n), Work(0.0, 3 * n)]


def wav2vec2_group_norm_work(cfg: dict, batch: int,
                             samples: int) -> List[Work]:
    out, length = [], samples
    for dim, s in zip(cfg["conv_dim"], cfg["conv_stride"]):
        length = -(-length // s)
        out += group_norm_work(batch, length, dim)
    return out
