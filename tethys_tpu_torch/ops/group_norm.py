"""GroupNorm's kernels (tethys_tpu/ops/pallas_gn.py, tethys_tpu/ops/norms.py).

Four entry points over x [B, T, C] with G groups of C / G channels; a CUDA
tensor launches the kernel, a CPU tensor takes the plain version beside
it, anything else raises:
- ``group_moments(x, groups, eps)`` -> (mean, var, rstd), f32 [B, G]:
  csrc/gn_stats.cu's forward mode, one read of x; plain: the JAX module's
  two passes (norms.py:63-66), the T-sum in [B, T, C], a fold to [B, G],
  then the centred second pass.  Neither uses E[x^2] - mu^2, which loses
  digits when conv activations sit far from zero;
- ``grad_sums(x, dy, mean, rstd, gamma, groups)`` -> (sums [2, B, C], s
  [2, B, G]): gn_stats.cu's backward mode, the VJP's joint stats pass
  (norms.py:108-115): A = sum_t dy xhat and B = sum_t dy, s1 = fold(B
  gamma) / n and s2 = fold(A gamma) / n, n = T * C / G;
- ``apply(x, gamma, beta, mean, rstd, groups, dtype)`` -> y = gamma * ((x
  - mean) * rstd) + beta in f32, rounded once to dtype (x's, the only one
  the kernel writes): csrc/gn_apply.cu;
- ``apply_bwd(x, dy, gamma, mean, rstd, s, groups)`` -> dx = rstd * (dy
  gamma - s1 - xhat s2) in x's dtype: gn_apply.cu's backward.
The kernels take x and dy of one dtype, f32 or bf16, and any T; a view
that is not 16-byte aligned takes their element-wise form.

Launch shapes come from the occupancy each kernel reports
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the SM count:
``stats_plan`` and ``apply_grid`` put every block in one wave.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

_DTYPES = (torch.float32, torch.bfloat16)
_THREADS = 256        # threads a block (gn_stats.cu, gn_apply.cu kThreads)
_MAX_CLUSTER = 8      # the portable cluster size (gn_stats.cu kMaxCluster)
_MIN_TILE_BYTES = 128  # a channel tile's bytes a row (a whole cache line)
# stats_plan's model of the moments kernel on an H100, from its plan sweep
# (PERF.md section 6): a block keeps 32 KB in flight for about 1.6 us, an
# SM serves at most about 22 GB/s and the card about 3.0 TB/s; a block's
# item ends in its slot tree and group fold, about 1 us, and a cluster's
# two barriers cost about 2 us more.
_BLOCK_INFLIGHT = 32768
_LATENCY_S = 1.6e-6
_SM_BPS = 22e9
_CARD_BPS = 3.0e12
_ITEM_S = 1.0e-6
_SYNC_S = 2e-6

Moments = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _spread(v: torch.Tensor, pg: int) -> torch.Tensor:
    """[B, G] -> [B, 1, C]."""
    return v.repeat_interleave(pg, dim=-1)[:, None, :]


def _fold(per_channel: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, C] -> [B, G] sums."""
    b, c = per_channel.shape
    return per_channel.view(b, groups, c // groups).sum(dim=-1)


def _xhat(x, mean, rstd, pg):
    return (x.float() - _spread(mean, pg)) * _spread(rstd, pg)


# ---- plain versions ---------------------------------------------------------

def plain_group_moments(x: torch.Tensor, groups: int, eps: float = 1e-5
                        ) -> Moments:
    """What the stats kernel computes, as the JAX module's two passes."""
    b, t, c = x.shape
    pg = c // groups
    n = t * pg
    xf = x.float()
    mean_g = xf.sum(dim=1).view(b, groups, pg).sum(dim=-1) / n
    centered = xf - _spread(mean_g, pg)
    var_g = centered.square().sum(dim=1).view(b, groups, pg).sum(dim=-1) / n
    return mean_g, var_g, torch.rsqrt(var_g + eps)


def plain_grad_sums(x, dy, mean, rstd, gamma, groups: int):
    """What the backward mode computes: ([A, B] [2, B, C], [s1, s2] [2, B,
    G]), in the order of the JAX VJP."""
    _, t, c = x.shape
    pg = c // groups
    n = t * pg
    dyf = dy.float()
    a = (dyf * _xhat(x, mean, rstd, pg)).sum(dim=1)
    s = dyf.sum(dim=1)
    s1 = _fold(s * gamma, groups) / n
    s2 = _fold(a * gamma, groups) / n
    return torch.stack((a, s)), torch.stack((s1, s2))


def plain_apply(x, gamma, beta, mean, rstd, groups: int,
                dtype: torch.dtype = None) -> torch.Tensor:
    """gamma * ((x - mean) * rstd) + beta in f32, rounded once to ``dtype``
    (x's by default)."""
    y = gamma * _xhat(x, mean, rstd, x.shape[-1] // groups) + beta
    return y.to(dtype or x.dtype)


def plain_apply_bwd(x, dy, gamma, mean, rstd, s, groups: int) -> torch.Tensor:
    """rstd * (dy gamma - s1 - xhat s2) in f32, rounded once to x's dtype."""
    pg = x.shape[-1] // groups
    xhat = _xhat(x, mean, rstd, pg)
    dx = _spread(rstd, pg) * (dy.float() * gamma - _spread(s[0], pg)
                              - xhat * _spread(s[1], pg))
    return dx.to(x.dtype)


# ---- launch shapes ----------------------------------------------------------

def pack_elems(t: torch.Tensor, *others: torch.Tensor) -> int:
    """Elements a thread loads at once: 16 bytes (8 bf16, 4 f32) where every
    tensor's base is 16-byte aligned and a row is whole 16-byte words, else
    1 (the kernels' element-wise form)."""
    vec = 16 // t.element_size()
    ok = t.shape[-1] % vec == 0 and all(
        u.data_ptr() % 16 == 0 for u in (t, *others))
    return vec if ok else 1


def stats_plan(b: int, t: int, c: int, groups: int, vec: int, elem: int,
               blocks_per_sm: int, sm_count: int, fit=None, inputs: int = 1
               ) -> Tuple[int, int, int]:
    """(n_ctile, cluster, n_clusters) for gn_stats.cu.  A work item is one
    batch row's channel tile (C / n_ctile channels, whole groups, one row of
    the tile a step of C / n_ctile / vec threads); a cluster of ``cluster``
    blocks splits the item's T rows evenly and loops over items; the grid,
    cluster * n_clusters blocks, is resident at once: within one wave of
    blocks_per_sm * sm_count, and n_clusters within ``fit[cluster]``, the
    clusters of that size the card holds at once
    (cudaOccupancyMaxActiveClusters; by default the wave over the size).
    Picks the least time by the model above (``inputs`` tensors of elem
    bytes an element: x, or x and dy): the card's bandwidth, or the
    busiest SM's bytes at what its blocks keep in flight, plus its blocks'
    item ends and the clusters' barriers; on a tie, the smaller cluster,
    then the wider tile."""
    wave = blocks_per_sm * sm_count
    fit = fit or {}
    row_bytes = c * elem * inputs
    best = None
    for n_ctile in range(1, groups + 1):
        ctile = c // n_ctile
        if (groups % n_ctile or ctile % vec or ctile // vec > _THREADS
                or (n_ctile > 1 and ctile * elem < _MIN_TILE_BYTES)):
            continue
        items = b * n_ctile
        for cluster in (1, 2, 4, _MAX_CLUSTER):
            if cluster > min(t, wave):
                break
            n_clusters = min(items, fit.get(cluster, wave // cluster))
            if n_clusters < 1:
                continue
            rounds = -(-items // n_clusters)
            per_sm = -(-cluster * n_clusters // sm_count)
            block_bytes = rounds * -(-t // cluster) * row_bytes // n_ctile
            sm_bps = min(_SM_BPS, per_sm * _BLOCK_INFLIGHT / _LATENCY_S)
            seconds = (max(b * t * row_bytes / _CARD_BPS,
                           per_sm * block_bytes / sm_bps)
                       + per_sm * rounds * _ITEM_S
                       + (rounds * _SYNC_S if cluster > 1 else 0.0))
            key = (seconds, cluster, n_ctile)
            if best is None or key < best[0]:
                best = (key, (n_ctile, cluster, n_clusters))
    if best is None:
        raise ValueError(f"gn_stats: no channel tile of {c} channels in "
                         f"{groups} groups fits {_THREADS} threads of {vec}")
    return best[1]


def apply_grid(rows: int, c: int, vec: int, blocks_per_sm: int,
               sm_count: int) -> int:
    """Blocks for gn_apply.cu: a block covers _THREADS // (c / vec) rows at
    once (one row when c / vec >= _THREADS); at most one wave."""
    slots = _THREADS // min(c // vec, _THREADS)
    return max(1, min(-(-rows // slots), blocks_per_sm * sm_count))


_OCCUPANCY = {}


def occupancy(query: str, *args: int) -> Tuple[int, ...]:
    """A kernel's occupancy query (kernel_lib._QUERIES), cached per device:
    (blocks an SM, SMs[, clusters that fit])."""
    key = (torch.cuda.current_device(), query, args)
    if key not in _OCCUPANCY:
        out = (ctypes.c_int * 3)()
        err = getattr(kernel_lib.library(), query)(*args, out)
        if err != 0:
            raise RuntimeError(f"{query}: CUDA error {err}")
        _OCCUPANCY[key] = tuple(out)
    return _OCCUPANCY[key]


# ---- the kernels' wrappers --------------------------------------------------

def _check(name: str, groups: int, x: torch.Tensor, *same_dtype) -> None:
    check_kernel_inputs(name, x, *same_dtype)
    if x.dtype not in _DTYPES or any(u.dtype != x.dtype for u in same_dtype):
        raise ValueError(f"{name}: unsupported dtypes "
                         f"{[u.dtype for u in (x, *same_dtype)]}")
    b, t, c = x.shape
    if c % groups or min(b, t, c) == 0:
        raise ValueError(f"{name}: shape {tuple(x.shape)} with {groups} "
                         "groups")


def _vectors(x: torch.Tensor, *vectors: torch.Tensor) -> None:
    check_kernel_inputs("gn vectors", x, *vectors)
    if any(v.dtype != torch.float32 for v in vectors):
        raise ValueError("gn vectors: gamma, beta and the moments are f32")


def stats_launch(x, groups: int, vec: int, bwd: bool):
    """(stats_plan's plan, blocks an SM, SMs, fit) for x on its card."""
    return _stats_launch(torch.cuda.current_device(), *x.shape, groups,
                         x.element_size(), vec, bwd)


@functools.lru_cache(maxsize=1024)
def _stats_launch(device: int, b: int, t: int, c: int, groups: int,
                  elem: int, vec: int, bwd: bool):
    """stats_launch, once a shape: a step asks again for the same ones."""
    key = (int(bwd), int(elem == 2), int(vec > 1))
    blocks, sms, _ = occupancy("tethys_gn_stats_occupancy", *key, 1)
    fit = {s: occupancy("tethys_gn_stats_occupancy", *key, s)[2]
           for s in (2, 4, _MAX_CLUSTER)}
    plan = stats_plan(b, t, c, groups, vec, elem, blocks, sms, fit,
                      2 if bwd else 1)
    return plan, blocks, sms, fit


def group_moments_cuda(x: torch.Tensor, groups: int, eps: float = 1e-5,
                       plan=None) -> Moments:
    """``plan``: (n_ctile, cluster, n_clusters) in place of stats_plan's."""
    _check("gn_stats", groups, x)
    b, t, c = x.shape
    vec = pack_elems(x)
    out = torch.empty((3, b, groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        n_ctile, cluster, n_clusters = plan or stats_launch(x, groups, vec,
                                                            False)[0]
        kernel_lib.GN_STATS(
            x.data_ptr(), out.data_ptr(), b, t, c, groups, n_ctile, cluster,
            n_clusters, eps, int(x.dtype == torch.bfloat16), int(vec > 1),
            kernel_lib.stream_handle(x))
    return out[0], out[1], out[2]


def grad_sums_cuda(x, dy, mean, rstd, gamma, groups: int, plan=None):
    """``plan``: as group_moments_cuda's."""
    _check("gn_grad_sums", groups, x, dy)
    _vectors(x, mean, rstd, gamma)
    b, t, c = x.shape
    vec = pack_elems(x, dy)
    sums = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    s = torch.empty((2, b, groups), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        n_ctile, cluster, n_clusters = plan or stats_launch(x, groups, vec,
                                                            True)[0]
        kernel_lib.GN_GRAD_SUMS(
            x.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
            gamma.data_ptr(), sums.data_ptr(), s.data_ptr(), b, t, c, groups,
            n_ctile, cluster, n_clusters, int(x.dtype == torch.bfloat16),
            int(vec > 1), kernel_lib.stream_handle(x))
    return sums, s


def _apply_blocks(x, vec, bwd: bool) -> int:
    b, t, c = x.shape
    blocks, sms, _ = occupancy("tethys_gn_apply_occupancy", int(bwd),
                               int(x.dtype == torch.bfloat16), int(vec > 1))
    return apply_grid(b * t, c, vec, blocks, sms)


def apply_cuda(x, gamma, beta, mean, rstd, groups: int) -> torch.Tensor:
    _check("gn_apply", groups, x)
    _vectors(x, gamma, beta, mean, rstd)
    b, t, c = x.shape
    y = torch.empty_like(x)
    vec = pack_elems(x, y)
    with torch.cuda.device(x.device):
        kernel_lib.GN_APPLY(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), y.data_ptr(), b, t, c, groups,
            _apply_blocks(x, vec, False), int(x.dtype == torch.bfloat16),
            int(vec > 1), kernel_lib.stream_handle(x))
    return y


def apply_bwd_cuda(x, dy, gamma, mean, rstd, s, groups: int) -> torch.Tensor:
    _check("gn_apply_bwd", groups, x, dy)
    _vectors(x, gamma, mean, rstd, s)
    b, t, c = x.shape
    dx = torch.empty_like(x)
    vec = pack_elems(x, dy, dx)
    with torch.cuda.device(x.device):
        kernel_lib.GN_APPLY_BWD(
            x.data_ptr(), dy.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
            rstd.data_ptr(), s.data_ptr(), dx.data_ptr(), b, t, c, groups,
            _apply_blocks(x, vec, True), int(x.dtype == torch.bfloat16),
            int(vec > 1), kernel_lib.stream_handle(x))
    return dx


# ---- the entry points -------------------------------------------------------

def group_moments(x: torch.Tensor, groups: int, eps: float = 1e-5
                  ) -> Moments:
    """(mean, var, rstd), f32 [B, G], of x [B, T, C] (module doc)."""
    if x.is_cuda:
        return group_moments_cuda(x, groups, eps)
    cpu_or_raise("gn_stats", x)
    return plain_group_moments(x, groups, eps)


def grad_sums(x, dy, mean, rstd, gamma, groups: int):
    """([A, B] f32 [2, B, C], [s1, s2] f32 [2, B, G]) (module doc)."""
    if x.is_cuda:
        return grad_sums_cuda(x, dy, mean, rstd, gamma, groups)
    cpu_or_raise("gn_grad_sums", x)
    return plain_grad_sums(x, dy, mean, rstd, gamma, groups)


def apply(x, gamma, beta, mean, rstd, groups: int,
          dtype: torch.dtype = None) -> torch.Tensor:
    """y in ``dtype``, x's by default (module doc); the kernel writes x's
    dtype only."""
    if x.is_cuda:
        if dtype not in (None, x.dtype):
            raise ValueError(f"gn_apply: writes x's dtype {x.dtype}, not "
                             f"{dtype}")
        return apply_cuda(x, gamma, beta, mean, rstd, groups)
    cpu_or_raise("gn_apply", x)
    return plain_apply(x, gamma, beta, mean, rstd, groups, dtype)


def apply_bwd(x, dy, gamma, mean, rstd, s, groups: int) -> torch.Tensor:
    """dx in x's dtype (module doc)."""
    if x.is_cuda:
        return apply_bwd_cuda(x, dy, gamma, mean, rstd, s, groups)
    cpu_or_raise("gn_apply_bwd", x)
    return plain_apply_bwd(x, dy, gamma, mean, rstd, s, groups)
