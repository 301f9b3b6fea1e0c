"""Decode self-attention with the KV-cache append
(tethys_tpu/ops/pallas_decode.py ``decode_self_attention``).

A CUDA tensor launches csrc/decode_self.cu: one launch writes the new
column into both caches and attends over positions <= index.  A CPU tensor
takes ``plain_decode_self_attention``, the unfused composition of the JAX
package's ``_xla_reference``.  The int8 cross-attention kernel and
``quantize_kv_cols`` are not ported yet (ROADMAP.md).
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
