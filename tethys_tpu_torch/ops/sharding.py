"""Collectives with autograd, and the sequence-parallel context
(tethys_tpu/ops/sharding.py, and the collectives XLA's partitioner inserts
for the JAX package's meshes).

``Shard`` is this rank's place in a group of ranks that together hold one
tensor: the process group (None for a group of one), its size and this
rank's index.  Uneven lengths split in chunks of ceil(n / size), the last
ones shorter (``shard_range``), as XLA pads an uneven activation's shards.

The operators, each a ``torch.autograd.Function`` (Megatron's f and g):
* ``copy_to_group``: forward the identity, backward the SUM all-reduce of
  the gradient.  Before a sharded computation that reads a replicated
  tensor: each rank's gradient is a partial sum.
* ``reduce_from_group``: forward the SUM all-reduce, backward the identity.
  After a row-parallel product.  (``torch.distributed.nn``'s all_reduce
  all-reduces again in its backward, which counts the gradient ``size``
  times.)
* ``gather_from_group``: the all-gather along a dim (uneven pieces padded
  to the chunk for the transfer and cut back); backward this rank's slice
  of the gradient when the consumer is replicated (every rank holds the
  whole gradient), or with ``reduce_grad`` the slice of its SUM over the
  group when the consumer is sharded (a reduce-scatter: the gathered K and
  V of sequence parallelism, each rank's attention a partial dk, dv).
* ``split_to_group``: forward this rank's slice, backward the all-gather.
* ``replicated_slice``: this rank's slice of a replicated tensor (a
  parameter every rank holds whole, used on a shard: GroupNorm's gamma and
  beta on a channel shard, a bias beside a column-parallel kernel); its
  backward places the slice's gradient in the whole and sums the group's,
  so every rank gets the whole gradient (``copy_to_group`` then a
  ``narrow``).

``permute`` is a pipeline's hop between two stages, a broadcast over
their two-rank group (parallel/pp.py).

``TRANSPORTS`` counts the collectives by (backend, device type, op), and
``BYTES`` the bytes each kind moved: on one card several ranks share it
over gloo, which takes CUDA tensors for all_reduce, broadcast and
all_gather (torch 2.11), so every op is gloo's own; nothing moves to the
CPU.

The sequence-parallel context: ``seq_axis_rules(shard)`` installs the seq
group for the duration of a step (thread-local, as the JAX rules table);
the Whisper encoder reads ``current_seq_rules()`` once per forward, splits
its rows over the group after the stem (``SeqShard``, handed to each layer
as an argument, so a layer's recompute under remat sees the same split)
and gathers them before the final LayerNorm.  ``seq_constrain(x, seq)``
holds a layer boundary to the split.  Outside the context every call is the
identity, so model code never depends on a trainer module.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from tethys_tpu_torch.ops.dropout import Window


class Shard(NamedTuple):
    group: Any        # torch.distributed ProcessGroup, None for one rank
    size: int
    rank: int


def shard_range(total: int, size: int, rank: int) -> Tuple[int, int]:
    """[start, stop) of rank ``rank``'s piece of ``total`` over ``size``
    ranks: chunks of ceil(total / size), the last ones shorter."""
    chunk = -(-total // size)
    start = min(rank * chunk, total)
    return start, min(start + chunk, total)


def shard_sizes(total: int, size: int) -> List[int]:
    return [b - a for a, b in (shard_range(total, size, r)
                               for r in range(size))]


TRANSPORTS: dict = {}
# Bytes handed to each kind of collective ("all-reduce", "all-gather"),
# for the collective report (profiling/comm.py).
BYTES: dict = {}


def _note(op: str, t: torch.Tensor, group, kind: Optional[str] = None
          ) -> None:
    key = (dist.get_backend(group), t.device.type, op)
    TRANSPORTS[key] = TRANSPORTS.get(key, 0) + 1
    kind = kind or op.replace("_", "-")
    BYTES[kind] = BYTES.get(kind, 0) + t.numel() * t.element_size()


def all_reduce(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """SUM all-reduce of ``t`` in place over the group; returns ``t``."""
    _note("all_reduce", t, shard.group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=shard.group)
    return t


def all_gather(x: torch.Tensor, dim: int, shard: Shard,
               total: int) -> torch.Tensor:
    """The pieces of every rank along ``dim`` (``total`` in all, split as
    ``shard_range`` splits them), concatenated."""
    sizes = shard_sizes(total, shard.size)
    chunk = max(sizes)
    x = x.contiguous()
    if x.shape[dim] != sizes[shard.rank]:
        raise ValueError(f"all_gather: rank {shard.rank} holds "
                         f"{x.shape[dim]} of {total} along dim {dim}, not "
                         f"{sizes[shard.rank]}")
    if x.shape[dim] < chunk:
        pad = list(x.shape)
        pad[dim] = chunk - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim)
    parts = [torch.empty_like(x) for _ in range(shard.size)]
    _note("all_gather", x, shard.group)
    dist.all_gather(parts, x, group=shard.group)
    return torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)], dim)


def permute(t: torch.Tensor, group, src: int) -> torch.Tensor:
    """One hop between two pipeline stages (JAX's ``ppermute``): ``t``
    broadcast from the global rank ``src`` over the two-rank ``group``, in
    place on the other rank; returns ``t``.  A broadcast, which gloo takes
    for CUDA tensors, so one transport serves the CPU, ranks that share a
    card and NCCL; both ranks count its bytes as "collective-permute", the
    kind JAX's HLO report gives the ppermute.  ``t`` must be contiguous on
    both ranks: the bytes move as they lie."""
    if not t.is_contiguous():
        raise ValueError(f"permute: a tensor of strides {t.stride()} is not "
                         "contiguous")
    _note("broadcast", t, group, "collective-permute")
    dist.broadcast(t, src, group=group)
    return t


def _local(x: torch.Tensor, dim: int, shard: Shard, total: int):
    start, stop = shard_range(total, shard.size, shard.rank)
    return x.narrow(dim, start, stop - start)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        ctx.shard = shard
        return x.view_as(x)

    @staticmethod
    def backward(ctx, dy):
        return all_reduce(dy.contiguous().clone(), ctx.shard), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard):
        return all_reduce(x.contiguous().clone(), shard)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard, total, reduce_grad):
        ctx.args = dim, shard, total, reduce_grad
        return all_gather(x, dim, shard, total)

    @staticmethod
    def backward(ctx, dy):
        dim, shard, total, reduce_grad = ctx.args
        if reduce_grad:
            dy = all_reduce(dy.contiguous().clone(), shard)
        return _local(dy, dim, shard, total).contiguous(), None, None, None, \
            None


class _SplitToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, shard):
        ctx.args = dim, shard, x.shape[dim]
        return _local(x, dim, shard, x.shape[dim]).contiguous()

    @staticmethod
    def backward(ctx, dy):
        dim, shard, total = ctx.args
        return all_gather(dy, dim, shard, total), None, None


def _one(shard: Optional[Shard]) -> bool:
    return shard is None or shard.size == 1


def copy_to_group(x: torch.Tensor, shard: Optional[Shard]) -> torch.Tensor:
    return x if _one(shard) else _CopyToGroup.apply(x, shard)


def reduce_from_group(x: torch.Tensor,
                      shard: Optional[Shard]) -> torch.Tensor:
    return x if _one(shard) else _ReduceFromGroup.apply(x, shard)


def gather_from_group(x: torch.Tensor, dim: int, shard: Optional[Shard],
                      total: int, reduce_grad: bool = False) -> torch.Tensor:
    if _one(shard):
        return x
    return _GatherFromGroup.apply(x, dim, shard, int(total), reduce_grad)


def split_to_group(x: torch.Tensor, dim: int,
                   shard: Optional[Shard]) -> torch.Tensor:
    return x if _one(shard) else _SplitToGroup.apply(x, dim, shard)


def replicated_slice(x: torch.Tensor, dim: int,
                     shard: Optional[Shard]) -> torch.Tensor:
    """This rank's piece along ``dim`` (``shard_range``) of a tensor every
    rank holds whole; the gradient that reaches ``x`` is the group's sum of
    the pieces' gradients, the whole gradient on every rank."""
    if _one(shard):
        return x
    start, stop = shard_range(x.shape[dim], shard.size, shard.rank)
    return copy_to_group(x, shard).narrow(dim, start, stop - start)


class SeqShard(NamedTuple):
    """This rank's rows of a [B, T, D] activation split over the seq
    group: rows [start, stop) of ``total``."""
    shard: Shard
    total: int

    @property
    def start(self) -> int:
        return shard_range(self.total, self.shard.size, self.shard.rank)[0]

    @property
    def stop(self) -> int:
        return shard_range(self.total, self.shard.size, self.shard.rank)[1]

    def window(self) -> Window:
        """The dropout window of this rank's rows (ops/dropout.py)."""
        return Window(row0=self.start, rows=self.total)

    def split(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, D] -> this rank's rows; backward the all-gather."""
        if min(shard_sizes(self.total, self.shard.size)) < 1:
            raise ValueError(f"sequence parallelism: {self.total} rows over "
                             f"{self.shard.size} ranks leaves one empty")
        return split_to_group(x, 1, self.shard)

    def gather(self, x: torch.Tensor, dim: int = 1,
               reduce_grad: bool = False) -> torch.Tensor:
        """Every rank's rows along ``dim``, in order."""
        return gather_from_group(x, dim, self.shard, self.total, reduce_grad)


_tls = threading.local()


def current_seq_rules() -> Optional[Shard]:
    return getattr(_tls, "seq", None)


@contextlib.contextmanager
def seq_axis_rules(shard: Optional[Shard]) -> Iterator[None]:
    """Install ``shard`` as the seq group of the [B, T, D] encoder
    activations for the duration of the context (thread-local)."""
    prev = getattr(_tls, "seq", None)
    _tls.seq = None if _one(shard) else shard
    try:
        yield
    finally:
        _tls.seq = prev


def seq_constrain(x: torch.Tensor, seq: Optional[SeqShard]) -> torch.Tensor:
    """A layer boundary of the sharded region: ``x`` must hold this rank's
    rows; the identity without a split."""
    if seq is not None and x.shape[1] != seq.stop - seq.start:
        raise ValueError(f"sequence parallelism: a layer boundary holds "
                         f"{x.shape[1]} rows, this rank's are "
                         f"[{seq.start}, {seq.stop})")
    return x
