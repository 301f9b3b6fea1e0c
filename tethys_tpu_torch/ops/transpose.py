"""Head split and merge (tethys_tpu/ops/pallas_transpose.py).

``split_heads`` launches the CUDA kernel (csrc/split_heads.cu) for a CUDA
tensor and takes its plain version for a CPU tensor.  ``merge_heads`` is
plain torch, as the JAX forward's default (``MERGE_IMPL = "xla"``); its
kernel serves only as split_heads' gradient in training and waits for the
training port.
"""

from __future__ import annotations

import torch

from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

_SPLIT_DTYPES = (torch.float32, torch.bfloat16)


def plain_split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*d] -> [B, H, T, d] (a contiguous copy)."""
    b, t, d_model = x.shape
    return (x.reshape(b, t, num_heads, d_model // num_heads)
            .transpose(1, 2).contiguous())


def split_heads_cuda(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    check_kernel_inputs("split_heads", x)
    if x.dtype not in _SPLIT_DTYPES:
        raise ValueError(f"split_heads: unsupported dtype {x.dtype}")
    b, t, d_model = x.shape
    if d_model % num_heads:
        raise ValueError(f"split_heads: {d_model} not divisible by {num_heads}")
    head_dim = d_model // num_heads
    y = torch.empty((b, num_heads, t, head_dim), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        kernel_lib.SPLIT_HEADS(
            x.data_ptr(), y.data_ptr(), b, t, num_heads, head_dim,
            x.element_size(), kernel_lib.stream_handle(x))
    return y


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*d] -> [B, H, T, d]: the kernel on CUDA, plain on CPU."""
    if x.is_cuda:
        return split_heads_cuda(x, num_heads)
    cpu_or_raise("split_heads", x)
    return plain_split_heads(x, num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, d] -> [B, T, H*d] (plain torch on every device)."""
    b, num_heads, t, head_dim = x.shape
    return x.transpose(1, 2).reshape(b, t, num_heads * head_dim)
