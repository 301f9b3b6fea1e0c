"""Head split and merge (tethys_tpu/ops/pallas_transpose.py).

``split_heads`` is an autograd Function: its forward launches
csrc/split_heads.cu, its backward the merge kernel csrc/merge_heads.cu (the
JAX ``_split_bwd``), each on a CUDA tensor; CPU tensors take the plain
versions, so the CPU tests run the same backward formula.  Where T == 1
(a decode step) or H == 1, [B, T, H*d] and [B, H, T, d] hold the same
bytes in the same order, so ``split_heads`` returns a view on every device
and launches nothing; that is decided by the shape alone.  ``merge_heads``
in the forward stays plain torch, as the JAX default (``MERGE_IMPL =
"xla"``).
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


def plain_merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, d] -> [B, T, H*d] (a contiguous copy)."""
    b, num_heads, t, head_dim = x.shape
    return x.transpose(1, 2).reshape(b, t, num_heads * head_dim).contiguous()


def merge_heads_cuda(x: torch.Tensor) -> torch.Tensor:
    check_kernel_inputs("merge_heads", x)
    if x.dtype not in _SPLIT_DTYPES:
        raise ValueError(f"merge_heads: unsupported dtype {x.dtype}")
    b, num_heads, t, head_dim = x.shape
    y = torch.empty((b, t, num_heads * head_dim), dtype=x.dtype,
                    device=x.device)
    with torch.cuda.device(x.device):
        kernel_lib.MERGE_HEADS(
            x.data_ptr(), y.data_ptr(), b, t, num_heads, head_dim,
            x.element_size(), kernel_lib.stream_handle(x))
    return y


def split_is_a_view(x: torch.Tensor, num_heads: int) -> bool:
    """True where the split moves no bytes: T == 1 or H == 1 (and x is
    contiguous, as every caller's projection output is)."""
    return (x.shape[1] == 1 or num_heads == 1) and x.is_contiguous()


def _split(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    if split_is_a_view(x, num_heads):
        b, t, d_model = x.shape
        return x.view(b, num_heads, t, d_model // num_heads)
    if x.is_cuda:
        return split_heads_cuda(x, num_heads)
    cpu_or_raise("split_heads", x)
    return plain_split_heads(x, num_heads)


def _merge(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        return merge_heads_cuda(x)
    cpu_or_raise("merge_heads", x)
    return plain_merge_heads(x)


class SplitHeads(torch.autograd.Function):
    """y = split(x); dx = merge(dy), the merge kernel on CUDA tensors."""

    @staticmethod
    def forward(ctx, x, num_heads: int):
        return _split(x, num_heads)

    @staticmethod
    def backward(ctx, dy):
        return _merge(dy.contiguous()), None


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, H*d] -> [B, H, T, d]: the kernel on CUDA, plain on CPU.
    Where the split moves no bytes it is a view, on every device (autograd
    records the view; its backward is the inverse view).  Without a
    gradient to record (serving) the Function is skipped."""
    if (torch.is_grad_enabled() and x.requires_grad
            and not split_is_a_view(x, num_heads)):
        return SplitHeads.apply(x, num_heads)
    return _split(x, num_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T, d] -> [B, T, H*d] (plain torch on every device)."""
    b, num_heads, t, head_dim = x.shape
    return x.transpose(1, 2).reshape(b, t, num_heads * head_dim)
