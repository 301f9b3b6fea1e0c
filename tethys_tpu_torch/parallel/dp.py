"""Train steps and their optimizers (tethys_tpu/parallel/dp.py).

* ``KerasAdam``: tf.keras Adam's exact rule, written by hand.  Keras folds
  the bias corrections into the step size and adds eps to the UNCORRECTED
  sqrt(v):

      m += (g - m) (1 - b1);  v += (g^2 - v) (1 - b2)
      alpha_t = lr sqrt(1 - b2^t) / (1 - b1^t)
      p -= alpha_t m / (sqrt(v) + eps)

  ``torch.optim.Adam`` adds eps to the corrected sqrt(v_hat), which drifts
  from Keras over a trajectory, so it is not the port.  Moments live in the
  parameter dtype (bf16 under bf16 master weights, as optax keeps them);
  the update runs as a few multi-tensor (``_foreach``) passes over all
  parameters.  With ``clipnorm`` each gradient is first
  clipped by its own L2 norm (Keras ``Adam(clipnorm=)``,
  ``per_variable_clipnorm``), a shard's by its whole variable's under
  tensor parallelism (``squared_norms``, which the train step sets).
* ``whisper_optimizer``: Keras defaults, eps 1e-7.  ``wav2vec2_optimizer``:
  ``per_variable_clipnorm(1.0)`` then Keras Adam with eps 1e-8 (reference
  wav2vec2_dist.py:1271-1275).
* ``make_train_step(loss_fn, optimizer, hardened=False)``: one replica's
  step -- forward, backward, the gradients' all-reduce, optimizer --
  returning the loss as a detached device tensor (no host sync).  With a
  process group up (``parallel/mesh.initialize_distributed``) every rank
  keeps one replica, and the step aggregates as the JAX step's ``psum``
  does (the reference's MultiWorkerMirroredStrategy): the gradients are
  SUMMED over the replicas, not averaged, and so is the logged loss.  The
  hardened step (Wav2Vec2, reference wav2vec2_dist.py:1186-1260) scrubs a
  NaN loss to 0, divides it by the number of replicas N, and clips the
  replica's own gradients to a global norm of 1.0 BEFORE the all-reduce;
  the optimizer's per-variable clip then clips the sum again: the
  reference's double clip (quirk #8), kept.  A parameter that took no
  gradient (the frozen codevectors) is left out of both clips, of the
  all-reduce and of the update, as the JAX step's zero gradient leaves it.
* ``remat`` and ``grad_accum`` of ``make_train_step``: the whole-loss
  checkpoint and gradient accumulation in f32 over microbatches, each
  drawing from ``microbatch_generator`` (JAX ``scan_grad_accum``).
* ``GradientReducer``: the SUM all-reduce as flat buckets of about 25 MB,
  one dtype each, taken after the backward (``DistributedDataParallel``
  would average, and would start reducing before the hardened clip has
  seen the replica's whole gradient).  A bucket of one contiguous tensor,
  the flat gradient of ``flat_spec``, is reduced in place.
* ``flat_spec`` of ``make_train_step`` (parallel/flat.py, ``--flat_opt``):
  the parameters and gradients are views of one flat f32 master and its
  gradient buffer, so the clips, the all-reduce (one collective, then the
  loss's) and Keras Adam each act on one vector.
* ``layout`` of ``make_train_step`` (parallel/mesh: ``make_2d_mesh``,
  ``make_seq_mesh``): a replica is one model or seq group, so the replica
  count is the data group's size, and the gradients, the logged loss and
  ``replica_mean`` reduce over the data group only (JAX's partial-manual
  shard_map, "data" manual).  Under sequence parallelism the step runs
  inside ``ops.sharding.seq_axis_rules`` and first sums the partial
  gradients over the seq group (those of the submodules the model names
  in its ``seq_sharded``, which run on a rank's rows), then broadcasts
  the others from the group's first rank: each rank computed them whole,
  but the flash backward's dq atomics do not give every rank the same
  bits, and the replicas' copies of the parameters must stay equal.
  Under tensor parallelism the replicated parameters' gradients (whole on
  every rank of a model group) are broadcast from the group's first rank
  likewise (cuDNN's grouped-conv weight gradient need not give every rank
  the same bits), and the sharded ones stay each rank's own.
  Without a layout: one replica a rank (``make_data_mesh``).
* The hardened chain over a layout, per replica (one model or seq group),
  as the JAX step runs it on the replica's whole (GSPMD-partitioned)
  variables: the NaN scrub and 1/N (N the data group's size); the seq
  group's partial sums and broadcast; the global-norm clip on the norm of
  the whole model (a sharded gradient's squares summed over the model
  group, a replicated one counted once: ``ShardNorms``); the data group's
  SUM (the replicated gradients in buckets of their own, so they lie at
  the same place in every data group's buffers and keep equal bits);
  Keras Adam's per-variable clipnorm on each whole variable's norm.
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from tethys_tpu_torch.ops import remat as remat_lib
from tethys_tpu_torch.ops import sharding
from tethys_tpu_torch.parallel import mesh
from tethys_tpu_torch.utils import tracing


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    # The (data, model|seq) layout the state is sharded or replicated over
    # (parallel/mesh.Layout); None: one replica a rank.
    layout: Any = None


def _keras_alpha(lr: float, b1: float, b2: float, count: int) -> np.float32:
    """lr sqrt(1 - b2^t) / (1 - b1^t) in f32, as Keras (and the JAX port)
    compute it in the variable dtype; on the host, so no device sync."""
    one, c = np.float32(1.0), np.float32(count)
    return (np.float32(lr) * np.sqrt(one - np.float32(b2) ** c)
            / (one - np.float32(b1) ** c))


SquaredNorms = Callable[[List[torch.Tensor]], torch.Tensor]


def per_variable_clipnorm(grads: List[torch.Tensor], max_norm: float,
                          squared_norms: Optional[SquaredNorms] = None
                          ) -> None:
    """Keras ``clipnorm``: each gradient scaled in place by min(1,
    max_norm / max(|g|, 1e-12)), its own L2 norm (not the global one).
    ``squared_norms(grads)``: the squared norms of the whole variables
    when ``grads`` are shards (``ShardNorms``)."""
    if not grads:
        return
    if squared_norms is None:
        norms = torch.stack(torch._foreach_norm(grads)).float()
    else:
        norms = squared_norms(grads).sqrt()
    scales = (max_norm / norms.clamp_min(1e-12)).clamp_max(1.0)
    torch._foreach_mul_(grads, list(scales.to(grads[0].dtype).unbind()))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        squared_norms: Optional[SquaredNorms] = None
                        ) -> None:
    """optax ``clip_by_global_norm``: every gradient scaled in place by
    max_norm / |g| when the global norm |g| is at least max_norm (of the
    whole variables under ``squared_norms``, as per_variable_clipnorm)."""
    if not grads:
        return
    if squared_norms is None:
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)).float())
    else:
        norm = squared_norms(grads).sum().sqrt()
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))


class ShardNorms:
    """The squared L2 norms of whole variables from a model group's
    gradients: a sharded gradient's squares summed over the group (one
    SUM all-reduce of a vector of them), a replicated one's counted once.
    ``sharded``: the ids of the sharded gradients' tensors.  A stacked
    ``scan_layers`` leaf's gradient is one [L, ...] tensor (the stack of
    its layer slices'), so its norm is the whole stacked variable's, as
    JAX's per-variable clipnorm takes the stacked leaf."""

    def __init__(self, shard: sharding.Shard, sharded):
        self.shard = shard
        self.sharded = sharded

    def __call__(self, grads: List[torch.Tensor]) -> torch.Tensor:
        squares = torch.stack(torch._foreach_norm(grads)).float().square()
        mask = torch.tensor([id(g) in self.sharded for g in grads],
                            device=squares.device)
        summed = sharding.all_reduce(torch.where(mask, squares, 0.0),
                                     self.shard)
        return torch.where(mask, summed, squares)


class KerasAdam(torch.optim.Optimizer):
    """tf.keras.optimizers.Adam's update rule (module doc).
    ``squared_norms``: the clipnorm's norms of whole variables when the
    parameters are shards (``ShardNorms``; None: each gradient's own)."""

    squared_norms: Optional[SquaredNorms] = None

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7,
                 clipnorm: Optional[float] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      clipnorm=clipnorm))

    def clip(self, grads: List[torch.Tensor], max_norm: float) -> None:
        """Keras ``clipnorm``, each gradient by its own norm (the flat
        optimizer's, parallel/flat.py, by each variable's slice)."""
        per_variable_clipnorm(grads, max_norm, self.squared_norms)

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("KerasAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                state["step"] += 1
            count = self.state[params[0]]["step"]
            grads = [p.grad for p in params]
            if group["clipnorm"] is not None:
                self.clip(grads, group["clipnorm"])
            ms = [self.state[p]["m"] for p in params]
            vs = [self.state[p]["v"] for p in params]
            b1, b2 = group["b1"], group["b2"]
            # m + (g - m) * (1 - b1), v + (g^2 - v) * (1 - b2)
            # Each pass's temporaries are freed before the next one's are
            # made, so the update holds at most two parameter-sized lists.
            dm = torch._foreach_sub(grads, ms)
            torch._foreach_mul_(dm, 1.0 - b1)
            torch._foreach_add_(ms, dm)
            del dm
            dv = torch._foreach_mul(grads, grads)
            torch._foreach_sub_(dv, vs)
            torch._foreach_mul_(dv, 1.0 - b2)
            torch._foreach_add_(vs, dv)
            del dv
            alpha = float(_keras_alpha(group["lr"], b1, b2, count))
            denom = torch._foreach_sqrt(vs)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_mul(ms, -alpha)
            torch._foreach_div_(update, denom)
            del denom
            torch._foreach_add_(params, update)
        return None


def whisper_optimizer(params, learning_rate: float = 1e-4) -> KerasAdam:
    """Adam with Keras defaults (eps 1e-7) and Keras's eps placement
    (reference whisper_dist.py:894-901)."""
    return KerasAdam(params, lr=learning_rate, b1=0.9, b2=0.999, eps=1e-7)


def wav2vec2_optimizer(params, learning_rate: float = 3e-5) -> KerasAdam:
    """Per-variable clipnorm(1.0), then Keras Adam with eps 1e-8 (reference
    wav2vec2_dist.py:1271-1275)."""
    return KerasAdam(params, lr=learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                     clipnorm=1.0)


LossFn = Callable[[torch.nn.Module, Any, torch.Generator], Any]

BUCKET_BYTES = 25 * 2 ** 20


class GradientReducer:
    """SUM all-reduce of one replica's gradients over a process group
    (``group``: the world's by default; the data group under a layout), or
    with ``src`` (a global rank of the group) their broadcast from it.

    The gradients are packed in order into flat buckets, one dtype each, a
    new bucket begun once one holds ``BUCKET_BYTES`` (and at ``split``, so
    that the gradients before it and those after it never share one);
    each bucket is all-reduced with SUM and copied back.  The buckets
    follow the parameters that took a gradient, which is the same list on
    every rank.
    ``bytes_per_step`` is what the last step handed to ``all_reduce``
    (buckets and loss), for the collective report.  Nothing here waits for
    the device: NCCL queues the all-reduce behind the backward."""

    def __init__(self, group=None, src: Optional[int] = None):
        self.group = group
        self.src = src
        self.bytes_per_step = 0

    @staticmethod
    def buckets(grads: List[torch.Tensor],
                split: int = 0) -> List[List[torch.Tensor]]:
        by_dtype = {}
        for i, g in enumerate(grads):
            by_dtype.setdefault((i >= split, g.dtype), []).append(g)
        out = []
        for group in by_dtype.values():
            bucket, size = [], 0
            for g in group:
                if bucket and size >= BUCKET_BYTES:
                    out.append(bucket)
                    bucket, size = [], 0
                bucket.append(g)
                size += g.numel() * g.element_size()
            out.append(bucket)
        return out

    def __call__(self, grads: List[torch.Tensor],
                 loss: Optional[torch.Tensor],
                 split: int = 0) -> Optional[torch.Tensor]:
        """Sums ``grads`` in place over the group; returns the SUM of the
        ranks' ``loss`` (None for None)."""
        dist = torch.distributed
        moved = 0
        for bucket in self.buckets(grads, split) if grads else ():
            # A bucket of one contiguous tensor (the flat gradient of
            # parallel/flat.py) is reduced in place: no concat, no copy.
            alone = len(bucket) == 1 and bucket[0].is_contiguous()
            flat = (bucket[0].view(-1) if alone
                    else torch.cat([g.reshape(-1) for g in bucket]))
            if self.src is None:
                dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            else:
                dist.broadcast(flat, self.src, group=self.group)
            if not alone:
                torch._foreach_copy_(bucket, [
                    part.view_as(g) for part, g in
                    zip(flat.split([g.numel() for g in bucket]), bucket)])
            moved += flat.numel() * flat.element_size()
        if loss is not None:
            loss = loss.clone()
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=self.group)
            moved += loss.numel() * loss.element_size()
        self.bytes_per_step = moved
        return loss


def aux_leaves(tree, path=()):
    """(key path, value) of every leaf of a nested dict."""
    if isinstance(tree, dict):
        for key, value in tree.items():
            yield from aux_leaves(value, path + (key,))
    else:
        yield path, tree


def aux_tree(leaves) -> dict:
    """The nested dict of (key path, value) pairs (aux_leaves' inverse)."""
    tree: dict = {}
    for path, value in leaves:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    return tree


def replica_mean(aux: dict, layout: Optional[mesh.Layout] = None) -> dict:
    """The mean over the replicas (the data group of ``layout``, default
    one replica a rank) of every tensor of the nested dict ``aux`` (JAX's
    ``pmean``), as one SUM all-reduce of their f32 values; ``aux`` itself
    without a process group."""
    layout = layout or mesh.make_data_mesh()
    if layout.data_group is None or not aux:
        return aux
    leaves = [(path, t.detach()) for path, t in aux_leaves(aux)]
    flat = torch.cat([t.float().reshape(-1) for _, t in leaves])
    torch.distributed.all_reduce(flat, op=torch.distributed.ReduceOp.SUM,
                                 group=layout.data_group)
    flat /= layout.data
    parts = flat.split([t.numel() for _, t in leaves])
    return aux_tree((path, part.view_as(t).to(t.dtype))
                    for (path, t), part in zip(leaves, parts))


def accumulate(model: torch.nn.Module, batch, generator: torch.Generator,
               n: int, value_and_grad: Callable):
    """Gradient accumulation over ``n`` microbatches (JAX
    ``scan_grad_accum``): the batch's tensors split into ``n`` equal
    chunks along the leading dim, in order (raises when it does not
    divide).  ``value_and_grad(model, microbatch, generator)`` runs one
    forward and backward into ``p.grad`` and returns (loss, aux);
    microbatch i draws from ``microbatch_generator(generator, i)``.  The
    gradients are summed in f32 whatever the parameters' dtype (a bf16
    running sum would round each add to 8 bits), then divided by ``n`` and
    cast back once; a parameter that took no gradient keeps none.  Returns
    (the mean loss, the mean of each aux leaf)."""
    lead = batch[0].shape[0]
    if lead % n:
        raise ValueError(f"per-replica batch {lead} is not divisible by "
                         f"grad_accum={n}")
    size = lead // n
    sums, losses, auxes = {}, [], []
    for i in range(n):
        mb = tuple(x[i * size:(i + 1) * size] for x in batch)
        loss, aux = value_and_grad(model, mb, microbatch_generator(generator,
                                                                   i))
        losses.append(loss.float())
        auxes.append(list(aux_leaves(aux or {})))
        for p in model.parameters():
            if p.grad is None:
                continue
            if p in sums:
                sums[p] += p.grad
            else:
                sums[p] = p.grad.float()
            p.grad = None
    for p, total in sums.items():
        p.grad = (total / n).to(p.dtype)
    aux = aux_tree((path, torch.stack([a[j][1] for a in auxes]).mean(0))
                   for j, (path, _) in enumerate(auxes[0]))
    return torch.stack(losses).sum() / n, aux


def seq_sharded_prefixes(model: torch.nn.Module) -> tuple:
    """The name prefixes of the parameters whose gradients are partial
    sums over a seq group: those of the submodules the model declares in
    its ``seq_sharded``.  Raises for a model that declares none."""
    names = getattr(model, "seq_sharded", ())
    if not names:
        raise ValueError(f"{type(model).__name__} declares no seq_sharded "
                         "submodules: it has no sequence parallelism")
    return tuple(f"{name}." for name in names)


def make_train_step(loss_fn: LossFn, optimizer: torch.optim.Optimizer,
                    hardened: bool = False, return_aux: bool = False,
                    grad_aux_fn: Optional[Callable] = None,
                    remat: bool = False, grad_accum: int = 1,
                    layout: Optional[mesh.Layout] = None, flat_spec=None):
    """step(state, batch, generator) -> (state, loss) on one replica.

    loss_fn(model, batch, generator) -> (scalar loss, aux).  The model and
    the optimizer are updated in place; ``loss`` is detached and stays on
    the device.  ``hardened``: the NaN scrub, 1/N and the global-norm clip
    (module doc); none of them waits on the device.  With a process group
    up the step sums the gradients and the loss over the replicas
    (``step.reducer``, a ``GradientReducer``); without one it is the
    identity of a sum over one replica and reduces nothing.

    With ``return_aux`` the step returns (state, loss, aux) (JAX dp.py
    :177-192): loss_fn's aux (a dict of tensors) averaged over the
    replicas (``replica_mean``), and with ``grad_aux_fn`` also
    ``aux["grad_aux"] = grad_aux_fn(grads)``, where ``grads`` maps each
    parameter's name to its gradient summed over the replicas, before the
    optimizer's own clip; a parameter that took no gradient gives zeros,
    as in JAX.  Every value stays on the device.

    ``remat``: the whole loss_fn runs under ``ops/remat.checkpoint`` with
    the ``dots_saveable`` policy (JAX's jax.checkpoint with
    dots_with_no_batch_dims_saveable), its draws replayed in the recompute.
    ``grad_accum=N``: the batch is split into N microbatches along its
    leading dim (``accumulate``): the NaN scrub and 1/N run on each, the
    loss and the aux are their means, and the global-norm clip runs once,
    on the accumulated gradients, before the all-reduce.  N = 1 is the
    unaccumulated step, with the same draws.

    ``layout``: the module doc.  ``step.collective_bytes`` holds the bytes
    the last step handed to each kind of collective (the gradient reduces
    and, under a layout, the model's own).

    Spans (``utils/tracing``): ``tethys.step.zero_grad``;
    ``tethys.step.forward`` (loss_fn and the NaN scrub) and
    ``tethys.step.backward``, each microbatch's, timed on the device too;
    ``tethys.step.reduce`` around each reducer that runs,
    ``tethys.step.clip`` around the hardened global clip, and
    ``tethys.step.optimizer`` (the optimizer's step and the flat scatter,
    on the device too).

    ``flat_spec`` (a ``parallel/flat.FlatSpec`` bound to the model, with
    its ``flat.*_optimizer``; JAX's ``flat_spec=``): the gradients exist
    only in the spec's flat buffer, which the step zeroes in place; the
    NaN scrub and 1/N act on the loss as before, the global clip, the one
    all-reduce of the whole buffer (then the loss's) and Adam on the flat
    vector; ``grad_aux_fn`` still sees the gradients by name.  It takes no
    ``grad_accum`` above 1, no ``remat`` and no layout but data
    parallelism: no JAX entry point combines them."""
    layout = layout or mesh.make_data_mesh()
    if flat_spec is not None:
        for flag, on in (("grad_accum > 1", grad_accum > 1),
                         ("--remat", remat),
                         ("TP, SP or PP layout", layout.inner > 1)):
            if on:
                raise ValueError(f"flat_spec (--flat_opt) takes no {flag}: "
                                 "no JAX entry point combines them")
    n_replicas = layout.data
    inner = None
    if layout.inner > 1:
        inner = sharding.Shard(layout.inner_group, layout.inner,
                               layout.inner_rank)
    seq = inner if layout.axis == "seq" else None
    model_group = inner if layout.axis == "model" else None
    reducer = (None if layout.data_group is None
               else GradientReducer(layout.data_group))
    seq_reducer = broadcast = None
    if inner is not None:
        # The replica's copies from the group's first rank.
        broadcast = GradientReducer(inner.group,
                                    src=layout.data_rank * layout.inner)
    if seq is not None:
        seq_reducer = GradientReducer(seq.group)
    if grad_accum < 1:
        raise ValueError(f"grad_accum={grad_accum} must be at least 1")
    if remat:
        inner_loss_fn = loss_fn

        def loss_fn(model, batch, generator):  # noqa: F811
            return remat_lib.checkpoint(inner_loss_fn, model, batch,
                                        generator=generator,
                                        policy="dots_saveable")

    def value_and_grad(model, batch, generator):
        with tracing.span("tethys.step.forward", device=True):
            loss, aux = loss_fn(model, batch, generator)
            if hardened:
                loss = torch.where(torch.isnan(loss), torch.zeros_like(loss),
                                   loss) / n_replicas
        with tracing.span("tethys.step.backward", device=True):
            loss.backward()
        return loss.detach(), aux

    def step(state: TrainState, batch, generator: torch.Generator):
        with tracing.span("tethys.step.zero_grad"):
            if flat_spec is None:
                optimizer.zero_grad(set_to_none=True)
            else:
                flat_spec.zero_grad()
        before = dict(sharding.BYTES)
        with sharding.seq_axis_rules(seq):
            if grad_accum > 1:
                loss, aux = accumulate(state.model, batch, generator,
                                       grad_accum, value_and_grad)
            else:
                loss, aux = value_and_grad(state.model, batch, generator)
        named = [] if flat_spec is not None else [
            (n, p.grad) for n, p in state.model.named_parameters()
            if p.grad is not None]
        own, norms = [], None
        if seq_reducer is not None:
            # The row-sharded submodules' partial sums.
            prefixes = seq_sharded_prefixes(state.model)
            own = [g for n, g in named if n.startswith(prefixes)]
            with tracing.span("tethys.step.reduce"):
                seq_reducer(own, None)
        elif model_group is not None:
            # Each rank's own shards.
            sizes = getattr(state.model, "_tp_full_sizes", {})
            own = [g for n, g in named if n in sizes]
            norms = ShardNorms(model_group, {id(g) for g in own})
        # Every other gradient as the group's first rank computed it,
        # first in the list, so that the reducer buckets it apart.
        mine = {id(g) for g in own}
        replicated = ([flat_spec.gather_grad()] if flat_spec is not None
                      else [g for _, g in named if id(g) not in mine])
        grads = replicated + own
        if broadcast is not None:
            with tracing.span("tethys.step.reduce"):
                broadcast(replicated, None)
        if hardened:   # per replica, before the sum
            with tracing.span("tethys.step.clip"):
                clip_by_global_norm(grads, 1.0, norms)
        if reducer is not None:
            with tracing.span("tethys.step.reduce"):
                loss = reducer(grads, loss, split=len(replicated))
        if isinstance(optimizer, KerasAdam):
            optimizer.squared_norms = norms
        moved = {kind: n - before.get(kind, 0)
                 for kind, n in sharding.BYTES.items()
                 if n > before.get(kind, 0)}
        for r in (seq_reducer, broadcast, reducer):
            if r is not None:
                kind = "all-reduce" if r.src is None else "broadcast"
                moved[kind] = moved.get(kind, 0) + r.bytes_per_step
        step.collective_bytes = moved
        if return_aux:
            aux = dict(replica_mean(aux or {}, layout))
            if grad_aux_fn is not None:
                aux["grad_aux"] = grad_aux_fn(
                    flat_spec.named_grads() if flat_spec is not None else {
                        name: torch.zeros_like(p) if p.grad is None
                        else p.grad
                        for name, p in state.model.named_parameters()})
        with tracing.span("tethys.step.optimizer", device=True):
            optimizer.step()
            if flat_spec is not None:
                flat_spec.scatter()
        if return_aux:
            return state, loss, aux
        return state, loss

    step.reducer = reducer
    step.flat_spec = flat_spec
    step.remat = remat
    step.collective_bytes = {}
    return step


def _splitmix64(z: int) -> int:
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def step_generator(seed: int, step: int, replica: int = 0) -> torch.Generator:
    """The CPU generator of one step's dropout seeds and negatives, a
    function of (run seed, step) as JAX's fold_in(rng, step) is: a
    splitmix64 mix of both.  A replica other than 0 folds its rank in with
    one more mix, as the JAX step's fold_in(rng, axis_index) does, so each
    replica draws its own; replica 0 keeps the one-process draws."""
    z = _splitmix64((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF))
    if replica:
        z = _splitmix64(z ^ replica)
    return torch.Generator().manual_seed(z)


def microbatch_generator(generator: torch.Generator,
                         index: int) -> torch.Generator:
    """The generator of microbatch ``index`` of a step whose generator is
    ``generator``, a function of (seed, step, replica, index) as JAX's
    fold_in(rng, index) is: the step generator's seed folded with the index
    as ``step_generator`` folds the replica."""
    return torch.Generator().manual_seed(
        _splitmix64(generator.initial_seed() ^ index))
