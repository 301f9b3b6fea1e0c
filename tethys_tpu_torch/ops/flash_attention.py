"""Flash attention forward and backward (tethys_tpu/ops/pallas_attention.py).

On the [B*H, T, D] layout:
* ``flash_attention_fwd`` launches csrc/flash_fwd.cu (``flash_fwd`` at rate
  0, ``flash_fwd_dropout`` above it) for CUDA tensors and takes
  ``plain_flash_fwd`` for CPU tensors.  Both return ``o`` and the f32
  per-row log-sum-exp ``lse`` [B*H, Tq].
* ``flash_attention_bwd`` launches csrc/flash_bwd.cu or takes
  ``plain_flash_bwd``: dq, dk, dv from q, k, v, o, lse and do, with P
  recomputed from lse and the dropout mask regenerated from the seed.
* On the card ``flash_route`` picks each kernel's route by shape: ``"wgmma"``
  (bf16, D % 16 == 0, 16-byte aligned bases: TMA and wgmma, every shape
  of the main path), ``"mma"`` (the other bf16 shapes: mma.sync) and
  ``"ffma"`` (f32: exact f32 products, as the CPU).  A route that fails
  raises; nothing falls back to another route or to the plain version.
  The kernels count their launches per route (``route_launches``), and
  ``TETHYS_FLASH_ROUTE`` (read at each call) forces one route for an A/B.
* ``flash_fwd`` is the dispatcher op ``tethys::flash_fwd`` over both, with
  flash_attention_bwd as its autograd formula (the JAX ``_flash``
  custom_vjp); it saves q, k, v, o, lse and the seed.
* ``saving(SavedOutputs())`` keeps the (o, lse) of each flash call of a
  checkpointed region's forward, and its recompute takes them back rather
  than launch the forward again: ops/remat.py's ``save_flash`` policy,
  where JAX offers them to the policy through checkpoint_name.

``flash_attention`` is the [B, H, T, D] entry point.  Dropout applies to
the unnormalised probabilities after the row max and sum are taken, scaled
by 1 / (1 - rate) at the output, with the mask of element (bh, row, col)
drawn at flat index (bh * Tq + row) * Tk + col (ops/dropout.py).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from tethys_tpu_torch.ops.dropout import (
    dropout_scale,
    dropout_threshold,
    keep_mask,
)
from tethys_tpu_torch.ops.masks import NEG_INF
from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)
# Route codes of csrc/flash_fwd.cu and csrc/flash_bwd.cu (enum Route).
ROUTES = kernel_lib.FLASH_ROUTES
_KERNELS = (kernel_lib.FLASH_FWD, kernel_lib.FLASH_FWD_DROPOUT,
            kernel_lib.FLASH_BWD)


def flash_route(dtype, d: int, aligned: bool) -> str:
    """The route of the flash kernels for head dim ``d``: f32 takes FFMA;
    bf16 takes TMA + wgmma where d is a multiple of 16 (wgmma's depth) and
    every base the kernel reads by TMA is 16-byte aligned (``aligned``),
    else mma.sync.  Raises on what no route takes: another dtype, or d
    outside 1 .. 128."""
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash_route: no route takes D={d}")
    if dtype == torch.float32:
        return "ffma"
    if dtype != torch.bfloat16:
        raise ValueError(f"flash_route: no route takes {dtype}")
    return "wgmma" if aligned and d % 16 == 0 else "mma"


def route_launches() -> dict:
    """{kernel: {route: launches}} of the three flash kernels."""
    return {k.name: dict(k.routes) for k in _KERNELS}


def _route(dtype, d: int, *tensors) -> str:
    forced = os.environ.get("TETHYS_FLASH_ROUTE")
    if forced:
        if forced not in ROUTES:
            raise ValueError(f"TETHYS_FLASH_ROUTE={forced!r}: not one of "
                             f"{ROUTES}")
        return forced
    return flash_route(dtype, d, all(t.data_ptr() % 16 == 0 for t in tensors))


def supported(query, key, value, bias) -> bool:
    """Bias-free attention with head_dim <= 128 (as the TPU kernel)."""
    return bias is None and query.shape[-1] <= MAX_HEAD_DIM


def _keep_prob(rate: float) -> float:
    """1 - rate in f32: the factor of delta in the backward."""
    return float(np.float32(1.0 - rate))


def _scores(q, k, kv_len):
    s = torch.matmul(q.float(), k.float().transpose(1, 2))   # [BH, Tq, Tk]
    if kv_len < k.shape[1]:
        col = torch.arange(k.shape[1], device=q.device)
        s = torch.where(col < kv_len, s, NEG_INF)
    return s


def plain_flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    kv_len: int, dropout_rate: float = 0.0, seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, in plain torch: f32 scores with keys >=
    kv_len masked, unnormalised probabilities (dropped, then rounded to the
    input dtype) times v, scaled by (1 / (1 - rate)) / the f32 row sum of
    the undropped probabilities."""
    s = _scores(q, k, kv_len)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    scale = 1.0
    if dropout_rate > 0.0:
        keep = keep_mask(seed, p.shape, dropout_rate, p.device)
        p = torch.where(keep, p, 0.0)
        scale = dropout_scale(dropout_rate)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) * (scale / l)
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def plain_flash_bwd(q, k, v, o, lse, do, kv_len: int,
                    dropout_rate: float = 0.0, seed: int = 0):
    """What the backward kernel computes, in plain torch (the formulas of
    pallas_attention.py:336-377): returns (dq, dk, dv)."""
    p = torch.exp(_scores(q, k, kv_len) - lse[..., None])
    inv, keep_prob = 1.0, 1.0
    dof = do.float()
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    p_drop = p
    if dropout_rate > 0.0:
        keep = keep_mask(seed, p.shape, dropout_rate, p.device)
        p_drop = torch.where(keep, p, 0.0)
        dp = torch.where(keep, dp, 0.0)
        inv, keep_prob = dropout_scale(dropout_rate), _keep_prob(dropout_rate)
    delta = (dof * o.float()).sum(dim=-1, keepdim=True)
    ds = (p * (dp - delta * keep_prob)).to(q.dtype).float()
    dv = torch.matmul(p_drop.to(do.dtype).float().transpose(1, 2), dof) * inv
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * inv
    dq = torch.matmul(ds, k.float()) * inv
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v, kv_len):
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"{name}: unsupported dtypes {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    bh, tq, d = q.shape
    tk = k.shape[1]
    if k.shape != (bh, tk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if not 1 <= d <= MAX_HEAD_DIM or bh > 65535 or not 1 <= kv_len:
        raise ValueError(f"{name}: unsupported D={d}, BH={bh}, "
                         f"kv_len={kv_len}")
    return bh, tq, tk, d


def _check_dropout(name, dropout_rate, seed):
    if not 0.0 <= dropout_rate < 1.0 or not 0 <= seed < 2 ** 32:
        raise ValueError(f"{name}: rate {dropout_rate} or seed {seed} out "
                         "of range")


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_len: int, dropout_rate: float = 0.0, seed: int = 0,
                   route: Optional[str] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on CUDA tensors; ``route`` (default: by
    ``flash_route``) names the route."""
    check_kernel_inputs("flash_fwd", q, k, v)
    bh, tq, tk, d = _check("flash_fwd", q, k, v, kv_len)
    _check_dropout("flash_fwd", dropout_rate, seed)
    route = route or _route(q.dtype, d, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bh, tq, tk, d, int(kv_len),
            int(q.dtype == torch.bfloat16))
    with torch.cuda.device(q.device):
        if dropout_rate > 0.0:
            kernel_lib.FLASH_FWD_DROPOUT(
                *args, int(seed), dropout_threshold(dropout_rate),
                dropout_scale(dropout_rate), ROUTES.index(route),
                kernel_lib.stream_handle(q), route=route)
        else:
            kernel_lib.FLASH_FWD(*args, ROUTES.index(route),
                                 kernel_lib.stream_handle(q), route=route)
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, kv_len: int,
                   dropout_rate: float = 0.0, seed: int = 0,
                   route: Optional[str] = None):
    """The backward on CUDA tensors: one call of csrc/flash_bwd.cu, which
    launches a pass that forms delta = rowsum(do . o) and zeroes the f32 dq
    buffer, the route's kernel, and for bf16 the pass that rounds dq."""
    check_kernel_inputs("flash_bwd", q, k, v, o, lse, do)
    bh, tq, tk, d = _check("flash_bwd", q, k, v, kv_len)
    _check_dropout("flash_bwd", dropout_rate, seed)
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (bh, tq):
        raise ValueError(f"flash_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)}, lse {tuple(lse.shape)}")
    if do.dtype != q.dtype or o.dtype != q.dtype or lse.dtype != torch.float32:
        raise ValueError(f"flash_bwd: do {do.dtype}, o {o.dtype}, lse "
                         f"{lse.dtype}")
    route = route or _route(q.dtype, d, q, k, v, do)
    delta = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dq_acc = (dq if q.dtype == torch.float32 else
              torch.empty((bh, tq, d), dtype=torch.float32, device=q.device))
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dropout = dropout_rate > 0.0
    with torch.cuda.device(q.device):
        kernel_lib.FLASH_BWD(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, tq, tk, d, int(kv_len), int(q.dtype == torch.bfloat16),
            int(dropout), int(seed),
            dropout_threshold(dropout_rate) if dropout else 0,
            _keep_prob(dropout_rate) if dropout else 1.0,
            dropout_scale(dropout_rate) if dropout else 1.0,
            ROUTES.index(route), kernel_lib.stream_handle(q), route=route)
    return dq, dk, dv


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_len: Optional[int] = None,
                        dropout_rate: float = 0.0, seed: int = 0):
    """[BH, Tq, D] x [BH, Tk, D] -> (o [BH, Tq, D], lse f32 [BH, Tq])."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if q.is_cuda:
        return flash_fwd_cuda(q, k, v, kv_len, dropout_rate, seed)
    cpu_or_raise("flash_fwd", q)
    return plain_flash_fwd(q, k, v, kv_len, dropout_rate, seed)


def flash_attention_bwd(q, k, v, o, lse, do, kv_len: Optional[int] = None,
                        dropout_rate: float = 0.0, seed: int = 0):
    """(dq, dk, dv) of flash_attention_fwd's o, given do."""
    kv_len = k.shape[1] if kv_len is None else int(kv_len)
    if q.is_cuda:
        return flash_bwd_cuda(q, k, v, o, lse, do, kv_len, dropout_rate, seed)
    cpu_or_raise("flash_bwd", q)
    return plain_flash_bwd(q, k, v, o, lse, do, kv_len, dropout_rate, seed)


@torch.library.custom_op(
    "tethys::flash_fwd", mutates_args=(),
    schema="(Tensor q, Tensor k, Tensor v, int kv_len, float dropout_rate, "
           "int seed) -> (Tensor, Tensor)")
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: int,
              dropout_rate: float, seed: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) of flash_attention_fwd as one dispatcher op, so that a
    checkpoint policy sees it whole (ops/remat.py's ``dots_saveable``
    recomputes it, as JAX recomputes a Pallas call that is not a dot).  Its
    backward is flash_attention_bwd."""
    return flash_attention_fwd(q, k, v, kv_len, dropout_rate, seed)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v, kv_len, dropout_rate, seed):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:2], dtype=torch.float32))


def _save(ctx, q, k, v, o, lse, kv_len, dropout_rate, seed):
    ctx.save_for_backward(q, k, v, o, lse)
    ctx.kv_len, ctx.dropout_rate, ctx.seed = kv_len, dropout_rate, seed


def _grads(ctx, do):
    q, k, v, o, lse = ctx.saved_tensors
    return flash_attention_bwd(q, k, v, o, lse, do.contiguous(), ctx.kv_len,
                               ctx.dropout_rate, ctx.seed)


def _flash_setup(ctx, inputs, output):
    _save(ctx, *inputs[:3], *output, *inputs[3:])
    ctx.mark_non_differentiable(output[1])


flash_fwd.register_autograd(
    lambda ctx, do, _dlse: (*_grads(ctx, do), None, None, None),
    setup_context=_flash_setup)


class _FlashFromSaved(torch.autograd.Function):
    """The flash op's autograd on the (o, lse) its forward gave before: o,
    with flash_attention_bwd as the backward."""

    @staticmethod
    def forward(ctx, q, k, v, o, lse, kv_len: int, dropout_rate: float,
                seed: int):
        _save(ctx, q, k, v, o, lse, kv_len, dropout_rate, seed)
        return o.view_as(o)

    @staticmethod
    def backward(ctx, do):
        return (*_grads(ctx, do), None, None, None, None, None)


class SavedOutputs:
    """The (o, lse) of every flash call in a region, in order: a forward
    under ``saving(outputs)`` appends them, a recompute under
    ``saving(outputs, replay=True)`` takes them back in the same order and
    launches no forward kernel (ops/remat.py's ``save_flash``, the JAX
    policy save_only_these_names("flash_o", "flash_lse"))."""

    def __init__(self):
        self.outputs: List[Tuple[torch.Tensor, torch.Tensor]] = []
        self.replay: Optional[Iterator] = None


# The SavedOutputs of the region running in this thread (the backward's
# recompute runs in the autograd engine's thread), or None.
_SAVING: contextvars.ContextVar = contextvars.ContextVar("flash_saving",
                                                         default=None)


@contextlib.contextmanager
def saving(outputs: SavedOutputs, replay: bool = False):
    outputs.replay = iter(outputs.outputs) if replay else None
    token = _SAVING.set(outputs)
    try:
        yield
    finally:
        _SAVING.reset(token)


def flash_attention(
    query: torch.Tensor,   # [B, H, Tq, D], pre-scaled
    key: torch.Tensor,     # [B, H, Tk, D]
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: int = 0,
    kv_len: Optional[int] = None,  # true KV length when key/value are padded
) -> torch.Tensor:
    """Flash attention on the [B, H, T, D] layout; returns [B, H, Tq, D].
    Neither sequence needs padding: the kernels mask their own ragged
    edges, and ``kv_len`` masks keys a caller padded."""
    if bias is not None:
        raise ValueError("flash_attention handles bias-free attention only")
    b, h, tq, d = query.shape
    tk = key.shape[2]
    kv_len = tk if kv_len is None else int(kv_len)
    q = query.reshape(b * h, tq, d).contiguous()
    k = key.reshape(b * h, tk, d).contiguous()
    v = value.reshape(b * h, tk, d).contiguous()
    args = (kv_len, float(dropout_rate), int(seed))
    saved = _SAVING.get()
    if saved is not None and saved.replay is not None:
        o = _FlashFromSaved.apply(q, k, v, *next(saved.replay), *args)
    else:
        o, lse = flash_fwd(q, k, v, *args)
        if saved is not None:
            saved.outputs.append((o.detach(), lse))
    return o.reshape(b, h, tq, d)
