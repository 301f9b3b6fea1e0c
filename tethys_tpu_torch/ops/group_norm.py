"""GroupNorm moments (tethys_tpu/ops/pallas_gn.py, tethys_tpu/ops/norms.py).

``group_moments(x, groups)``: for x [B, T, C], the per-(batch, group) mean
and biased variance over (T, C / groups), each f32 [B, G].  A CUDA tensor
launches csrc/gn_stats.cu, which reads x once; a CPU tensor takes
``plain_group_moments``, the JAX module's two-pass form (norms.py:64-66):
the T-sum in [B, T, C], a fold to [B, G], then the centred second pass.
Neither uses E[x^2] - mu^2, which loses digits when conv activations sit
far from zero.

The JAX kernel's ``stats_chunk`` divisor rule and its small-input cutoff are
TPU tiling limits; the CUDA kernel takes any T, so there is no threshold:
every CUDA tensor goes to the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

from tethys_tpu_torch.utils import kernel_lib
from tethys_tpu_torch.utils.device import check_kernel_inputs, cpu_or_raise

_DTYPES = (torch.float32, torch.bfloat16)
_THREADS = 128           # channels a block covers (gn_stats.cu kThreads)
_ROWS = 16               # rows a thread holds at once (kRows)
_TARGET_BLOCKS = 132 * 16  # 16 blocks of 128 threads on each of 132 SMs


def plain_group_moments(x: torch.Tensor, groups: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the kernel computes, as the JAX module's two passes."""
    b, t, c = x.shape
    pg = c // groups
    n = t * pg
    xf = x.float()
    mean_g = xf.sum(dim=1).view(b, groups, pg).sum(dim=-1) / n
    centered = xf - mean_g.repeat_interleave(pg, dim=-1)[:, None, :]
    var_g = centered.square().sum(dim=1).view(b, groups, pg).sum(dim=-1) / n
    return mean_g, var_g


def stats_chunk(b: int, t: int, c: int) -> int:
    """Rows per block: a multiple of 16 chosen so that b * n_chunks *
    ceil(c / 128) blocks make about one full wave of the card."""
    tiles = b * -(-c // _THREADS)
    n_target = max(-(-_TARGET_BLOCKS // tiles), 1)
    rows = -(-t // n_target)
    return max(_ROWS, -(-rows // _ROWS) * _ROWS)


def group_moments_cuda(x: torch.Tensor, groups: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    check_kernel_inputs("gn_stats", x)
    if x.dtype not in _DTYPES:
        raise ValueError(f"gn_stats: unsupported dtype {x.dtype}")
    b, t, c = x.shape
    if c % groups or min(b, t, c) == 0:
        raise ValueError(f"gn_stats: shape {tuple(x.shape)} with {groups} "
                         "groups")
    chunk = stats_chunk(b, t, c)
    n_chunks = -(-t // chunk)
    partials = torch.empty((2, b, n_chunks, c), dtype=torch.float32,
                           device=x.device)
    moments = torch.empty((2, b, groups), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        kernel_lib.GN_STATS(
            x.data_ptr(), partials[0].data_ptr(), partials[1].data_ptr(),
            moments[0].data_ptr(), moments[1].data_ptr(), b, t, c, groups,
            chunk, int(x.dtype == torch.bfloat16),
            kernel_lib.stream_handle(x))
    return moments[0], moments[1]


def group_moments(x: torch.Tensor, groups: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean_g, var_g), f32 [B, G], of x [B, T, C] (module doc)."""
    if x.is_cuda:
        return group_moments_cuda(x, groups)
    cpu_or_raise("gn_stats", x)
    return plain_group_moments(x, groups)
