"""Flash attention forward (tethys_tpu/ops/pallas_attention.py).

``flash_attention_fwd`` is the kernel's wrapper on the [B*H, T, D] layout:
it launches csrc/flash_fwd.cu for CUDA tensors and takes
``plain_flash_fwd`` for CPU tensors.  Both return ``o`` and the f32
per-row log-sum-exp ``lse`` [B*H, Tq] (the TPU kernel's residual for the
backward, which the training port will need).  ``flash_attention`` is the
[B, H, T, D] entry point.

Dropout inside the kernel and the backward wait for the training port
(ROADMAP.md, queue 2: flash attention dropout and backward); a nonzero
``dropout_rate`` raises NotImplementedError.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tethys_tpu_torch.ops.masks import NEG_INF
from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)


def supported(query, key, value, bias) -> bool:
    """Bias-free attention with head_dim <= 128 (as the TPU kernel)."""
    return bias is None and query.shape[-1] <= MAX_HEAD_DIM


def plain_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain torch: f32 scores with keys >=
    kv_len masked, unnormalised probabilities rounded to the input dtype
    before the product with v, division by the f32 row sum."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2))   # [BH, Tq, Tk]
    if kv_len < k.shape[1]:
        col = torch.arange(k.shape[1], device=q.device)
        s = torch.where(col < kv_len, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    check_kernel_inputs("flash_fwd", q, k, v)
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_fwd: unsupported dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if k.shape != (bh, tk, d) or v.shape != k.shape:
        raise ValueError(f"flash_fwd: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM or bh > 65535 or not 1 <= kv_len:
        raise ValueError(f"flash_fwd: unsupported D={d}, BH={bh}, "
                         f"kv_len={kv_len}")
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        kernel_lib.FLASH_FWD(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, tq, tk, d, int(kv_len),
            int(q.dtype == torch.bfloat16), kernel_lib.stream_handle(q))
    return o, lse


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None):
    """[BH, Tq, D] x [BH, Tk, D] -> (o [BH, Tq, D], lse f32 [BH, Tq])."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, kv_len)
    cpu_or_raise("flash_fwd", q)
    return plain_flash_fwd(q, k, v, kv_len)


def flash_attention(
    query: torch.Tensor,   # [B, H, Tq, D], pre-scaled
    key: torch.Tensor,     # [B, H, Tk, D]
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    kv_len: Optional[int] = None,  # true KV length when key/value are padded
) -> torch.Tensor:
    """Flash attention on the [B, H, T, D] layout; returns [B, H, Tq, D].
    Neither sequence needs padding: the kernel masks its own ragged edges,
    and ``kv_len`` masks keys a caller padded."""
    if bias is not None:
        raise ValueError("flash_attention handles bias-free attention only")
    if dropout_rate > 0.0:
        raise NotImplementedError(
            "flash attention dropout is not ported yet (ROADMAP.md, queue 2: "
            "flash attention dropout and backward)")
    b, h, tq, d = query.shape
    tk = key.shape[2]
    o, _ = flash_attention_fwd(
        query.reshape(b * h, tq, d).contiguous(),
        key.reshape(b * h, tk, d).contiguous(),
        value.reshape(b * h, tk, d).contiguous(), kv_len)
    return o.reshape(b, h, tq, d)
