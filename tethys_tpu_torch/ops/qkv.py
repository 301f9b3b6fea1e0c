"""Projections around attention (tethys_tpu/ops/pallas_qkv.py).

``project_split``: y = (x @ W^T + b) * scale, then the head split to
[B, H, T, d].  ``merge_project``: the head merge, then @ W_out^T + b.
Weights use torch's Linear layout [out, in] and are cast to the input's
dtype where they are used.

Two paths, chosen at call time by ``TETHYS_FUSED_QKV`` as the JAX package
chooses them:
* unset (the default): ``F.linear`` plus the split_heads kernel
  (ops/transpose.py), as XLA computed the products outside any kernel;
* ``TETHYS_FUSED_QKV=1``: the fused kernels, csrc/qkv_proj.cu on CUDA
  tensors and ``plain_project_split_fused`` / ``plain_merge_project_fused``
  on CPU tensors, in the autograd Functions ``ProjectSplit`` and
  ``MergeProject``.  All matrices of one ``project_split`` go through one
  launch at any T; a shape the kernel cannot take (E_out % H != 0) raises.

On the card ``proj_route`` picks one of the file's four kernels by shape
(its source note says what each does): ``"wgmma"`` (bf16, M = B * T > 64),
``"stream"`` (bf16 decode steps, M <= 64), ``"mma"`` (the other bf16
shapes) and ``"ffma"`` (f32).  Each is a hand-written kernel; a launch that
fails raises, and ``ROUTE_LAUNCHES`` counts the launches of each.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from tethys_tpu_torch.ops import transpose
from tethys_tpu_torch.ops.transpose import merge_heads, split_heads
from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

_DTYPES = (torch.float32, torch.bfloat16)
MAX_MATS = 3
# Route codes of csrc/qkv_proj.cu (enum Route), in order.
ROUTES = ("ffma", "mma", "wgmma", "stream")
# Launches per route, raised after each launch that succeeded.
ROUTE_LAUNCHES = dict.fromkeys(ROUTES, 0)
STREAM_MAX_M = 64
STREAM_MAX_K = 2048


def fused_qkv_enabled() -> bool:
    return os.environ.get("TETHYS_FUSED_QKV", "0") == "1"


def plain_project_split_fused(x, weights, biases, scales, num_heads):
    """The numerics of ``_proj_split_kernel``: x @ W^T summed in f32 and
    rounded to x's dtype, + b rounded, * scale rounded, split per head."""
    outs = []
    for weight, bias, scale in zip(weights, biases, scales):
        y = torch.matmul(x.float(), weight.to(x.dtype).float().t())
        y = (y.to(x.dtype) + bias.to(x.dtype)) * scale
        outs.append(transpose.plain_split_heads(y, num_heads))
    return tuple(outs)


def plain_merge_project_fused(attn, weight, bias):
    """The numerics of ``_merge_proj_kernel``: merged @ W^T summed in f32,
    rounded to attn's dtype, then + b rounded."""
    merged = transpose.plain_merge_heads(attn)
    y = torch.matmul(merged.float(), weight.to(attn.dtype).float().t())
    return y.to(attn.dtype) + bias.to(attn.dtype)


def proj_route(m: int, n: int, k: int, head_dim: int, dtype,
               aligned: bool) -> str:
    """The kernel of csrc/qkv_proj.cu for an [m, k] x [n, k]^T projection
    with heads of ``head_dim``: f32 takes exact FFMA; bf16 takes the
    weight-streaming kernel (m <= 64 and k <= 2048, so that its x rows and
    W slab fit in shared memory) or else TMA + wgmma, where k, n and the
    head dim are multiples of 64 and every operand is 16-byte aligned
    (``aligned``), and the mma.sync kernel otherwise."""
    if dtype == torch.float32:
        return "ffma"
    if not aligned or k % 64 or n % 64 or head_dim % 64:
        return "mma"
    return "stream" if m <= STREAM_MAX_M and k <= STREAM_MAX_K else "wgmma"


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_dtype(name, x):
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")


def project_split_cuda(x, weights, biases, scales, num_heads):
    _check_dtype("proj_split", x)
    weights = [w.to(x.dtype).contiguous() for w in weights]
    biases = [b.to(x.dtype).contiguous() for b in biases]
    check_kernel_inputs("proj_split", x, *weights, *biases)
    n = len(weights)
    b, t, e_in = x.shape
    e_out = weights[0].shape[0]
    head_dim = e_out // num_heads
    outs = [torch.empty((b, num_heads, t, head_dim), dtype=x.dtype,
                        device=x.device) for _ in range(n)]
    pad = MAX_MATS - n
    ptrs = lambda ts: [u.data_ptr() for u in ts] + [None] * pad  # noqa: E731
    route = proj_route(b * t, e_out, e_in, head_dim, x.dtype,
                       _aligned(x, *weights, *biases))
    with torch.cuda.device(x.device):
        kernel_lib.PROJ_SPLIT(
            x.data_ptr(), *ptrs(weights), *ptrs(biases), *ptrs(outs),
            *(list(map(float, scales)) + [1.0] * pad), n, b, t, e_in, e_out,
            head_dim, int(x.dtype == torch.bfloat16), ROUTES.index(route),
            kernel_lib.stream_handle(x))
    ROUTE_LAUNCHES[route] += 1
    return tuple(outs)


def merge_project_cuda(attn, weight, bias):
    _check_dtype("merge_proj", attn)
    weight = weight.to(attn.dtype).contiguous()
    bias = bias.to(attn.dtype).contiguous()
    check_kernel_inputs("merge_proj", attn, weight, bias)
    b, num_heads, t, head_dim = attn.shape
    e_out = weight.shape[0]
    out = torch.empty((b, t, e_out), dtype=attn.dtype, device=attn.device)
    route = proj_route(b * t, e_out, num_heads * head_dim, head_dim,
                       attn.dtype, _aligned(attn, weight, bias))
    with torch.cuda.device(attn.device):
        kernel_lib.MERGE_PROJ(
            attn.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, num_heads, t, head_dim, e_out,
            int(attn.dtype == torch.bfloat16), ROUTES.index(route),
            kernel_lib.stream_handle(attn))
    ROUTE_LAUNCHES[route] += 1
    return out


def _check_projections(x, weights, biases, num_heads):
    e_in, e_out = x.shape[-1], weights[0].shape[0]
    if not 1 <= len(weights) <= MAX_MATS:
        raise ValueError(f"proj_split: {len(weights)} matrices, the kernel "
                         f"takes 1-{MAX_MATS}")
    if e_out % num_heads:
        raise ValueError(f"proj_split: E_out {e_out} not divisible by "
                         f"{num_heads} heads")
    if any(w.shape != (e_out, e_in) for w in weights) or any(
            bias.shape != (e_out,) for bias in biases):
        raise ValueError(f"proj_split: weights {[tuple(w.shape) for w in weights]}"
                         f" do not fit x {tuple(x.shape)}")


def _project_split_fused(x, weights, biases, scales, num_heads):
    _check_projections(x, weights, biases, num_heads)
    if x.is_cuda:
        return project_split_cuda(x, weights, biases, scales, num_heads)
    cpu_or_raise("proj_split", x)
    return plain_project_split_fused(x, weights, biases, scales, num_heads)


def _merge_project_fused(attn, weight, bias):
    b, num_heads, t, head_dim = attn.shape
    e_out = weight.shape[0]
    if weight.shape != (e_out, num_heads * head_dim) or bias.shape != (e_out,):
        raise ValueError(f"merge_proj: weight {tuple(weight.shape)} does not "
                         f"fit attn {tuple(attn.shape)}")
    if attn.is_cuda:
        return merge_project_cuda(attn, weight, bias)
    cpu_or_raise("merge_proj", attn)
    return plain_merge_project_fused(attn, weight, bias)


class ProjectSplit(torch.autograd.Function):
    """Forward: the fused kernel.  Backward: the JAX custom VJP
    (``_project_split_bwd``): each cotangent merged by the merge kernel,
    times its scale, then plain products for dx, dW and db, each gradient
    cast to its parameter's dtype."""

    @staticmethod
    def forward(ctx, x, num_heads, scales, *params):
        n = len(params) // 2
        weights, biases = params[:n], params[n:]
        ctx.scales = scales
        ctx.save_for_backward(x, *params)
        return _project_split_fused(x, weights, biases, scales, num_heads)

    @staticmethod
    def backward(ctx, *dys):
        x, *params = ctx.saved_tensors
        n = len(params) // 2
        weights, biases = params[:n], params[n:]
        b, t, e_in = x.shape
        x2 = x.reshape(b * t, e_in)
        dx, dws, dbs = None, [], []
        for weight, bias, dy, scale in zip(weights, biases, dys, ctx.scales):
            dm = transpose._merge(dy.contiguous())
            if scale != 1.0:
                dm = dm * scale
            dm2 = dm.reshape(b * t, -1)
            term = torch.matmul(dm2, weight.to(dm.dtype)).reshape(b, t, e_in)
            dx = term if dx is None else dx + term
            dws.append(torch.matmul(dm2.float().t(), x2.float()).to(weight.dtype))
            dbs.append(dm2.sum(dim=0).to(bias.dtype))
        return (dx, None, None, *dws, *dbs)


class MergeProject(torch.autograd.Function):
    """Forward: the fused kernel.  Backward: the JAX custom VJP
    (``_merge_project_bwd``): dmerged = dy @ W, split per head by the split
    kernel; dW from the merge kernel's merged attn, summed in f32; db =
    dy summed; each cast to its parameter's dtype."""

    @staticmethod
    def forward(ctx, attn, weight, bias):
        ctx.save_for_backward(attn, weight, bias)
        return _merge_project_fused(attn, weight, bias)

    @staticmethod
    def backward(ctx, dy):
        attn, weight, bias = ctx.saved_tensors
        b, num_heads, t, head_dim = attn.shape
        dmerged = torch.matmul(dy, weight.to(dy.dtype))
        dattn = transpose._split(dmerged.contiguous(), num_heads)
        am = transpose._merge(attn).reshape(b * t, num_heads * head_dim)
        dy2 = dy.reshape(b * t, -1)
        dw = torch.matmul(dy2.float().t(), am.float()).to(weight.dtype)
        return dattn, dw, dy.sum(dim=(0, 1)).to(bias.dtype)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def project_split(
        x: torch.Tensor,
        projections: Sequence[Tuple[torch.Tensor, torch.Tensor, float]],
        num_heads: int) -> Tuple[torch.Tensor, ...]:
    """[(weight [E_out, E_in], bias [E_out], scale)] -> tuple of [B, H, T, d]."""
    if fused_qkv_enabled():
        weights = tuple(p[0] for p in projections)
        biases = tuple(p[1] for p in projections)
        scales = tuple(float(p[2]) for p in projections)
        if _needs_grad(x, *weights, *biases):
            return ProjectSplit.apply(x, num_heads, scales, *weights, *biases)
        return _project_split_fused(x, weights, biases, scales, num_heads)
    outs = []
    for weight, bias, scale in projections:
        y = F.linear(x, weight.to(x.dtype), bias.to(x.dtype))
        if scale != 1.0:
            y = y * scale
        outs.append(split_heads(y, num_heads))
    return tuple(outs)


def merge_project(attn: torch.Tensor, weight: torch.Tensor,
                  bias: Optional[torch.Tensor]) -> torch.Tensor:
    """[B, H, T, d] -> [B, T, E_out]; ``bias`` None adds none (a
    row-parallel product, whose bias is added after the group's sum)."""
    if fused_qkv_enabled():
        if bias is None:
            bias = torch.zeros(weight.shape[0], dtype=attn.dtype,
                               device=attn.device)
        if _needs_grad(attn, weight, bias):
            return MergeProject.apply(attn, weight, bias)
        return _merge_project_fused(attn, weight, bias)
    return F.linear(merge_heads(attn), weight.to(attn.dtype),
                    None if bias is None else bias.to(attn.dtype))
