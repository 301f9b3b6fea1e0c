"""Reading a ``torch.profiler`` trace of the traced window.

The categories are a frozen copy of the program's profiler's
(tethys_tpu_torch/profiling/step_profile.py, KERNEL_CATEGORIES and
OP_CATEGORIES): a kernel falls into the first whose substrings its own
name, or else the name of an operation enclosing its launch (innermost
first), holds.  Per-layer metrics read coarser groups of them (``GROUPS``);
products (cuBLAS and cuDNN's GEMM and convolution kernels) are told by the
kernel's own name.

The traced window is the span ``tethys_bench.window`` that the harness
records around its call into the training loop.  ``busy`` is the union of
the intervals in which any operation (kernel, copy, fill) ran on the
device, clipped to the window.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, NamedTuple, Tuple

WINDOW = "tethys_bench.window"

KERNEL_CATEGORIES = (
    ("gn_stats kernel (moments)", ("gn_moments_kernel",)),
    ("gn_grad_sums kernel", ("gn_grad_sums_kernel",)),
    ("gn_apply kernel", ("gn_apply_kernel",)),
    ("gn_apply_bwd kernel", ("gn_apply_bwd_kernel",)),
    ("dropout kernel", ("dropout_kernel",)),
    ("flash_bwd kernel", ("flash_bwd_",)),
    ("flash_fwd kernel", ("flash_fwd_",)),
    ("split/merge heads kernels", ("split_heads_kernel", "merge_heads_kernel")),
)
OP_CATEGORIES = (
    ("optimizer + clips", ("Optimizer.step", "_foreach_")),
    ("GroupNorm (torch around its kernels)", ("GroupNormFunction",)),
    ("conv (cuDNN)", ("convolution",)),
    ("cross-entropy loss", ("log_softmax", "LogSoftmax", "nll_loss",
                            "NllLoss")),
    ("attention (bmm, softmax)", ("bmm", "softmax", "Bmm", "Softmax")),
    ("dense GEMMs", ("addmm", "aten::mm", "MmBackward", "aten::linear")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("GELU", ("gelu", "Gelu")),
)
OTHER = "other (casts, copies, elementwise, loss)"

# Substrings of the names of product kernels (cuBLAS, cuBLASLt, cuDNN).
PRODUCT_KERNELS = ("gemm", "xmma", "nvjet", "cutlass", "splitKreduce",
                   "implicit_convolve", "fprop", "dgrad", "wgrad",
                   "conv2d", "convolve")

# Coarse groups that the per-layer metrics read.
GROUPS = ("flash", "group_norm", "optimizer", "products", "input_copy",
          "elementwise")


def categorise(kernel_name: str, op_names) -> str:
    for category, keys in KERNEL_CATEGORIES:
        if any(k in kernel_name for k in keys):
            return category
    for name in op_names:
        for category, keys in OP_CATEGORIES:
            if any(k in name for k in keys):
                return category
    return OTHER


def group(kernel_name: str, category: str) -> str:
    """The coarse group of a device operation."""
    if category.startswith("flash_"):
        return "flash"
    if category.startswith(("gn_stats", "gn_grad_sums", "gn_apply")):
        return "group_norm"
    if category == "optimizer + clips":
        return "optimizer"
    if kernel_name.startswith("Memcpy HtoD"):
        return "input_copy"
    lowered = kernel_name.lower()
    if any(k.lower() in lowered for k in PRODUCT_KERNELS):
        return "products"
    return "elementwise"


class Reading(NamedTuple):
    window_s: float
    busy_s: float
    by_group_s: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _union(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1][1] = end
        else:
            out.append([start, end])
    return out


def read(prof) -> Reading:
    """The window's device time by group and category, busy time, and the
    breakdown: the ten device operations that took most time, and the ten
    host operations during which the device sat idle longest (the
    innermost host operation running at the middle of each idle gap;
    ``no_host_operation`` where none ran)."""
    events = prof.events()
    host = [e for e in events if e.device_type.name == "CPU"]
    window = [e for e in host if e.name == WINDOW]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} window spans")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    host = [e for e in host if e.name != WINDOW]
    # A host span (record_function, the optimizer's step) also shows on the
    # device's timeline as an annotation: it is no operation.
    spans = {e.name for e in host} | {WINDOW}
    device = [e for e in events if e.device_type.name == "CUDA"
              and not getattr(e, "is_user_annotation", False)
              and e.name not in spans]
    intervals = [(max(e.time_range.start, w0), min(e.time_range.end, w1))
                 for e in device
                 if e.time_range.end > w0 and e.time_range.start < w1]
    busy = _union(intervals)
    busy_us = sum(end - start for start, end in busy)

    by_group = collections.Counter()
    by_name = collections.Counter()
    for e in host:
        if not e.kernels:
            continue
        chain, parent = [e.name], e.cpu_parent
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        for k in e.kernels:
            if k.name in spans:
                continue
            category = categorise(k.name, chain)
            by_group[group(k.name, category)] += k.duration
            by_name[k.name] += k.duration

    gaps = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    if busy:
        gaps = [(w0, busy[0][0])] + gaps + [(busy[-1][1], w1)]
    host_iv = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in host if e.time_range.end > w0
                     and e.time_range.start < w1)
    starts = [h[0] for h in host_iv]
    idle = collections.Counter()
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) / 2
        name = "no_host_operation"
        i = bisect.bisect_right(starts, mid)
        for j in range(i - 1, max(i - 400, -1), -1):
            if host_iv[j][1] >= mid:
                name = host_iv[j][2]
                break
        idle[name] += g1 - g0
    us = 1e-6
    return Reading(
        (w1 - w0) * us, busy_us * us,
        {g: by_group.get(g, 0.0) * us for g in GROUPS},
        [(n, v * us) for n, v in by_name.most_common(10)],
        [(n, v * us) for n, v in idle.most_common(10)])
