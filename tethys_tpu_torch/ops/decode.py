"""The decode step's attention kernels (tethys_tpu/ops/pallas_decode.py).

``decode_self_attention``: a CUDA tensor launches csrc/decode_self.cu, one
launch that writes the new column into both caches and attends over
positions <= index, the positions split over a thread-block cluster
(``decode_self_cluster`` gives its size).  A CPU tensor takes
``plain_decode_self_attention``, the unfused composition of the JAX
package's ``_xla_reference``.

``decode_cross_attention_q8``: one token against int8 cross-attention
caches with f32 per-column scales (``kv_quant="int8"``).  A CUDA tensor
launches csrc/q8_cross.cu (keys split over a cluster of
``q8_cross_cluster`` blocks), a CPU tensor takes
``plain_q8_cross_attention``.  ``quantize_kv_cols`` builds those caches
once per generate, in plain torch as JAX does it in XLA.
"""

from __future__ import annotations

import torch

from tethys_tpu_torch.ops.attention import decode_attention
from tethys_tpu_torch.ops.masks import NEG_INF
from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

_DTYPES = (torch.float32, torch.bfloat16)


def plain_decode_self_attention(query, k_new, v_new, k_buf, v_buf,
                                index: int):
    """Column writes into the caches (in place), then decode_attention with
    positions > index masked."""
    k_buf[:, :, :, index] = k_new[:, :, 0, :].to(k_buf.dtype)
    v_buf[:, :, :, index] = v_new[:, :, 0, :].to(v_buf.dtype)
    positions = torch.arange(k_buf.shape[3], device=k_buf.device)
    bias = torch.where(positions <= index, 0.0, NEG_INF)[None, None, None, :]
    out = decode_attention(query, k_buf, v_buf, bias=bias)
    return out, k_buf, v_buf


def decode_self_cuda(query, k_new, v_new, k_buf, v_buf, index: int):
    check_kernel_inputs("decode_self", query, k_new, v_new, k_buf, v_buf)
    dtypes = {t.dtype for t in (query, k_new, v_new, k_buf, v_buf)}
    if len(dtypes) != 1 or query.dtype not in _DTYPES:
        raise ValueError(f"decode_self: unsupported dtypes {sorted(map(str, dtypes))}")
    b, h, tq, d = query.shape
    t_max = k_buf.shape[3]
    if (tq != 1 or k_new.shape != query.shape or v_new.shape != query.shape
            or k_buf.shape != (b, h, d, t_max) or v_buf.shape != k_buf.shape):
        raise ValueError(
            f"decode_self: shapes q {tuple(query.shape)}, cache "
            f"{tuple(k_buf.shape)}")
    if not 0 <= index < t_max:
        raise ValueError(f"decode_self: index {index} outside [0, {t_max})")
    out = torch.empty_like(query)
    with torch.cuda.device(query.device):
        kernel_lib.DECODE_SELF(
            query.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_buf.data_ptr(), v_buf.data_ptr(), out.data_ptr(), b, h, d, t_max,
            index, int(query.dtype == torch.bfloat16),
            kernel_lib.stream_handle(query))
    return out, k_buf, v_buf


def decode_self_cluster(batch_heads: int, head_dim: int, index: int,
                        dtype) -> int:
    """The thread-block cluster size csrc/decode_self.cu takes for these
    sizes on the current CUDA device (1 to 8)."""
    return kernel_lib.library().tethys_decode_self_cluster(
        batch_heads, head_dim, index, int(dtype == torch.bfloat16))


def decode_self_attention(query, k_new, v_new, k_buf, v_buf, index: int):
    """Append (k_new, v_new) at cache column ``index`` and attend the query
    to positions <= index.

    query, k_new, v_new: [B, H, 1, D] (query pre-scaled); k_buf, v_buf:
    transposed caches [B, H, D, T_max]; index: a Python int, so a decode
    loop never waits on the device.  The caches are updated IN PLACE: the
    buffers returned are the buffers given.  Returns (out [B, H, 1, D],
    k_buf, v_buf), as the JAX function does."""
    if not isinstance(index, int):
        raise TypeError(f"decode_self_attention: index must be an int, "
                        f"got {type(index).__name__}")
    if query.is_cuda:
        return decode_self_cuda(query, k_new, v_new, k_buf, v_buf, index)
    cpu_or_raise("decode_self", query)
    return plain_decode_self_attention(query, k_new, v_new, k_buf, v_buf, index)


def quantize_kv_cols(x_t: torch.Tensor):
    """Per-column symmetric int8 quantization of a transposed cache
    (``pallas_decode.quantize_kv_cols``): x_t [B, H, D, Tk] -> (x8 int8
    [B, H, D, Tk], scale f32 [B, H, 1, Tk]) with x ~= x8 * scale, where
    scale = max(absmax over D, 1e-30) / 127 and x8 = round(x / scale)
    clipped to +-127 (``torch.round`` rounds half to even, as ``jnp.round``)."""
    x = x_t.float()
    scale = x.abs().amax(dim=2, keepdim=True).clamp_min(1e-30) / 127.0
    x8 = torch.clamp(torch.round(x / scale), -127, 127)
    return x8.to(torch.int8), scale


def plain_q8_cross_attention(query, k8, sk, v8, sv, kv_len=None):
    """The numerics of the TPU kernel ``_q8_cross_kernel``: k8 cast to the
    query's dtype (exact: |k8| <= 127), the product accumulated in f32 and
    multiplied by sk, positions >= kv_len masked, an f32 softmax, p * sv
    rounded to the compute dtype, the V product accumulated in f32.

    The JAX package's default on the chip is the XLA einsum
    ``_q8_xla_math``, which keeps p * sv in f32: in f32 the two agree, in
    bf16 they differ by that one rounding of p.  The port runs the
    kernel's form, on every device."""
    t = k8.shape[3]
    scores = torch.matmul(query.float(), k8.float()) * sk
    if kv_len is not None and kv_len < t:
        pos = torch.arange(t, device=scores.device)
        scores = torch.where(pos < kv_len, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    probs = (probs * sv).to(query.dtype)
    out = torch.matmul(probs.float(), v8.float().transpose(-1, -2))
    return out.to(query.dtype)


def q8_cross_cuda(query, k8, sk, v8, sv, kv_len=None):
    check_kernel_inputs("q8_cross", query, k8, sk, v8, sv)
    if query.dtype not in _DTYPES:
        raise ValueError(f"q8_cross: unsupported query dtype {query.dtype}")
    if (k8.dtype, v8.dtype, sk.dtype, sv.dtype) != (
            torch.int8, torch.int8, torch.float32, torch.float32):
        raise ValueError("q8_cross: caches must be int8 and scales float32")
    b, h, tq, d = query.shape
    t = k8.shape[3]
    if (tq != 1 or k8.shape != (b, h, d, t) or v8.shape != k8.shape
            or sk.shape != (b, h, 1, t) or sv.shape != sk.shape):
        raise ValueError(
            f"q8_cross: shapes q {tuple(query.shape)}, cache "
            f"{tuple(k8.shape)}, scales {tuple(sk.shape)}")
    kv_len = t if kv_len is None else int(kv_len)
    if not 0 < kv_len <= t:
        raise ValueError(f"q8_cross: kv_len {kv_len} outside [1, {t}]")
    out = torch.empty_like(query)
    with torch.cuda.device(query.device):
        kernel_lib.Q8_CROSS(
            query.data_ptr(), k8.data_ptr(), sk.data_ptr(), v8.data_ptr(),
            sv.data_ptr(), out.data_ptr(), b * h, d, t, kv_len,
            int(query.dtype == torch.bfloat16), kernel_lib.stream_handle(query))
    return out


def q8_cross_cluster(batch_heads: int, head_dim: int, kv_len: int) -> int:
    """The thread-block cluster size csrc/q8_cross.cu takes for these sizes
    on the current CUDA device (1 to 8)."""
    return kernel_lib.library().tethys_q8_cross_cluster(
        batch_heads, head_dim, kv_len)


def decode_cross_attention_q8(query, k8, sk, v8, sv, kv_len=None):
    """Cross-attention of one decode step against int8 transposed caches.

    query [B, H, 1, D] (pre-scaled, compute dtype); k8, v8 int8
    [B, H, D, Tk]; sk, sv f32 [B, H, 1, Tk]; kv_len: the true Tk when the
    caches are padded.  Returns [B, H, 1, D] in the query's dtype."""
    if query.is_cuda:
        return q8_cross_cuda(query, k8, sk, v8, sv, kv_len)
    cpu_or_raise("q8_cross", query)
    return plain_q8_cross_attention(query, k8, sk, v8, sv, kv_len)
