"""Pipeline-parallel (data x stage) Whisper training
(tethys_tpu/parallel/pp.py).

A world of n processes laid out (n // S, S) (parallel/mesh.make_pp_mesh):
the batch is split over the data group, and each stage group holds one
replica.  Stage s keeps the encoder layers s·L/S … (s+1)·L/S − 1 and
everything else of the model (JAX's ``"other"``) replicated
(``split_stages``); its optimizer is built on exactly those parameters, so
each stage's Adam moments exist only there.  A layer keeps its global
name in the checkpoints and the whole parameters (``global_name``): a
stage's ``model.encoder.layers.<i>`` is ``model.encoder.layers.<first +
i>``.

The GPipe fill and drain, once per accumulation chunk
(``make_pp_train_step``):

* stage 0 runs the stem (models/whisper.py ``WhisperEncoder.stem``) on the
  local batch and splits it into M contiguous microbatches, as JAX's
  ``micro`` reshape does;
* each stage, for m = 0 … M − 1 in order, receives microbatch m from
  stage s − 1 (stage 0 takes it from the split) as a leaf that requires
  grad, runs its layers on it and sends the output on to stage s + 1;
* the last stage concatenates the M outputs, runs the head (the encoder's
  final LayerNorm, then ``model.head``: the decoder and the loss) on the
  whole local batch, calls ``backward`` once and sends each microbatch
  input's gradient to stage s − 1, in order;
* every earlier stage receives the M output gradients, in order, calls
  ``torch.autograd.backward`` once over its M outputs (stage 0's stem
  graph is shared by them) and sends its inputs' gradients on.

A hop is ``ops/sharding.permute``: a broadcast from the sending stage over
the pair's two-rank group (``Layout.hops``), counted as
"collective-permute".  Broadcasts block, and the two ranks of a pair call
theirs in the same order (the M forward hops, then the M backward hops,
each in microbatch order), so the hops cannot deadlock: forward hops run
from stage to stage + 1 and backward hops start only after every forward
hop of the chunk.

Around the chunks, as the JAX step runs them: ``grad_accum`` chunks go
through ``dp.accumulate`` (f32 sums, their mean; JAX ``scan_grad_accum``);
each replicated parameter's gradient (zeros where the stage did not use
it: a parameter without one would be skipped by the optimizer and drift)
is summed over the stage group, then every gradient over the data group
(JAX's ``psum(grads["other"], "stage")`` then ``psum(grads, "data")``),
with ``dp.GradientReducer``; the logged loss is the last stage's, summed
over the stage group (the others hold 0) and then over the data group.

Dropout: stage layer i of microbatch m draws from a generator that is a
function of (seed, step, replica, chunk, global layer index, microbatch)
(``dp.microbatch_generator`` folds), the stem and the head from their
own folds.  JAX folds (global layer, tick), which makes its masks depend
on S; these do not, so a step's draws are the same for every S.
``remat`` runs each stage layer under ``ops/remat.checkpoint`` with the
``none`` policy (JAX's ``jax.checkpoint(body)``), its draws replayed.

``gather_params`` and ``gather_optimizer_state`` collect the whole state
in the canonical names over the stage group, so checkpoints and final
weights are whole; ``stage_params`` and ``stage_optimizer_state`` take a
rank's part of a whole state, so a checkpoint restores into any layout
(checkpoint.py).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping

import torch
import torch.distributed as dist
from torch import nn

from tethys_tpu_torch.models.whisper import _run_layer
from tethys_tpu_torch.ops import remat as remat_lib
from tethys_tpu_torch.ops import sharding
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.parallel.mesh import Layout, make_pp_mesh

__all__ = ["make_pp_mesh", "split_stages", "init_pp_state", "gather_named",
           "gather_params", "gather_optimizer_state", "stage_params",
           "stage_optimizer_state", "make_pp_train_step"]

LAYERS = "model.encoder.layers."
# The folds of a chunk's generator (JAX's split of the chunk rng in 3).
_STEM, _LAYERS, _HEAD = range(3)


def stage_span(config, layout: Layout):
    """(first, count): the global index of this rank's first encoder layer
    and its number of layers; raises unless the stages divide the layers
    (JAX's error)."""
    total, stages = config.encoder_layers, layout.inner
    if total % stages:
        raise ValueError(f"{total} encoder layers not divisible by "
                         f"{stages} stages")
    per = total // stages
    return layout.inner_rank * per, per


def split_stages(model: nn.Module, layout: Layout) -> nn.Module:
    """Drops every encoder layer but this rank's stage's (in place); the
    identity at one stage."""
    first, per = stage_span(model.config, layout)
    encoder = model.model.encoder
    encoder.layers = nn.ModuleList(list(encoder.layers)[first:first + per])
    model._pp_first_layer = first
    return model


def global_name(name: str, first: int) -> str:
    """A stage's parameter name in the whole model's names."""
    if not name.startswith(LAYERS):
        return name
    index, rest = name[len(LAYERS):].split(".", 1)
    return f"{LAYERS}{int(index) + first}.{rest}"


def _first(model: nn.Module) -> int:
    return getattr(model, "_pp_first_layer", 0)


def init_pp_state(model: nn.Module, make_optimizer: Callable,
                  layout: Layout) -> dp.TrainState:
    """Keep this rank's stage of a whole model and build its optimizer on
    exactly those parameters (``make_optimizer(parameters)``)."""
    split_stages(model, layout)
    return dp.TrainState(model, make_optimizer(model.parameters()), layout)


def _whole_names(model: nn.Module, params: bool = False) -> List[str]:
    """The whole model's state-dict (or, with ``params``, parameter)
    names, in its order (no memory)."""
    with torch.device("meta"):
        whole = type(model)(model.config)
    if params:
        return [n for n, _ in whole.named_parameters()]
    return list(whole.state_dict())


def _param_names(model: nn.Module, optimizer) -> List[str]:
    """The optimizer state dict's parameter index -> parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _from_stages(model: nn.Module, layout: Layout, entries: Mapping,
                 gathered: Callable) -> Dict:
    """{global name: value} of every stage's ``entries`` ({local layer
    name: value}, the same names on every rank), each of stage s's values
    broadcast from it over the stage group (``gathered(value, src)`` does
    one)."""
    _, per = stage_span(model.config, layout)
    out = {}
    for s in range(layout.inner):
        src = layout.data_rank * layout.inner + s
        for name, value in entries.items():
            out[global_name(name, s * per)] = gathered(value, src)
    return out


def _broadcast_to_host(t: torch.Tensor, src: int, layout: Layout,
                       mine: bool) -> torch.Tensor:
    buf = t.detach().clone() if mine else torch.empty_like(t)
    if layout.inner > 1:
        dist.broadcast(buf, src, group=layout.inner_group)
    return buf.cpu()


def gather_named(tensors: Mapping[str, torch.Tensor], model: nn.Module,
                 layout: Layout) -> Dict[str, torch.Tensor]:
    """Whole tensors in the canonical names from ``tensors`` under a
    stage's names of ``model``'s state (its parameters, its gradients), on
    the host, on every rank of the stage group (a collective of the
    group): each stage's layers broadcast from it, the replicated rest
    this rank's own; in the whole model's order."""
    me = layout.data_rank * layout.inner + layout.inner_rank
    layers = {n: t for n, t in tensors.items() if n.startswith(LAYERS)}
    out = {n: t.detach().cpu() for n, t in tensors.items()
           if not n.startswith(LAYERS)}
    out.update(_from_stages(model, layout, layers, lambda t, src:
                            _broadcast_to_host(t, src, layout, src == me)))
    return {n: out[n] for n in _whole_names(model) if n in out}


def gather_params(model: nn.Module, layout: Layout) -> Dict[str, torch.Tensor]:
    """The whole state dict of a stage's model (``gather_named``)."""
    return gather_named(model.state_dict(), model, layout)


def gather_optimizer_state(optimizer, model: nn.Module,
                           layout: Layout) -> dict:
    """The optimizer's state dict as a whole model's optimizer would hold
    it (its parameters indexed in the whole model's order), every stage's
    moments broadcast from it over the stage group (a collective of the
    group); one parameter group."""
    sd = optimizer.state_dict()
    if len(sd["param_groups"]) != 1:
        raise ValueError("pipeline parallelism takes one parameter group")
    me = layout.data_rank * layout.inner + layout.inner_rank
    local = _param_names(model, optimizer)
    whole = _whole_names(model, params=True)
    index = {n: i for i, n in enumerate(whole)}
    by_name = {local[int(i)]: entry for i, entry in sd["state"].items()}
    state = {index[n]: entry for n, entry in by_name.items()
             if not n.startswith(LAYERS)}

    def moments(entry, src):
        return {k: _broadcast_to_host(v, src, layout, src == me)
                if torch.is_tensor(v) and v.dim() > 0 else v
                for k, v in entry.items()}

    layers = {n: e for n, e in by_name.items() if n.startswith(LAYERS)}
    for name, entry in _from_stages(model, layout, layers, moments).items():
        state[index[name]] = entry
    return {"state": dict(sorted(state.items())),
            "param_groups": [dict(sd["param_groups"][0],
                                  params=list(range(len(whole))))]}


def stage_params(state: Mapping[str, torch.Tensor],
                 model: nn.Module) -> Dict[str, torch.Tensor]:
    """This stage's part of a whole state dict, in its local names."""
    first = _first(model)
    return {n: state[global_name(n, first)] for n in model.state_dict()}


def stage_optimizer_state(optimizer_state: dict, optimizer,
                          model: nn.Module) -> dict:
    """This stage's part of a whole optimizer state dict (as
    ``gather_optimizer_state`` writes it, or a one-process run's)."""
    first = _first(model)
    local = {global_name(n, first): i
             for i, n in enumerate(_param_names(model, optimizer))}
    whole = _whole_names(model, params=True)
    state = {local[whole[int(i)]]: entry
             for i, entry in optimizer_state["state"].items()
             if whole[int(i)] in local}
    groups = optimizer_state["param_groups"]
    return {"state": state,
            "param_groups": [dict(groups[0], params=list(range(len(local))))]}


def _fold(generator: torch.Generator, *indices: int) -> torch.Generator:
    for index in indices:
        generator = dp.microbatch_generator(generator, index)
    return generator


def make_pp_train_step(model: nn.Module, optimizer, layout: Layout,
                       num_microbatches: int = 2, remat: bool = False,
                       grad_accum: int = 1):
    """step(state, batch, generator) -> (state, loss) over the (data,
    stage) layout (module doc).  ``batch`` is the replica's (features,
    labels), the same on every stage of it; the loss is a detached device
    tensor.  ``step.collective_bytes`` holds the bytes the last step
    handed to the hops ("collective-permute") and to the gradient sums
    ("all-reduce")."""
    cfg = model.config
    stages, stage = layout.inner, layout.inner_rank
    first, per = stage_span(cfg, layout)
    me = layout.data_rank * stages + stage
    last = stage == stages - 1
    prev, nxt = layout.hops
    micro_n = num_microbatches
    if micro_n < 1 or grad_accum < 1:
        raise ValueError(f"num_microbatches={micro_n} and grad_accum="
                         f"{grad_accum} must be at least 1")
    encoder = model.model.encoder
    stage_reducer = (None if layout.inner_group is None
                     else dp.GradientReducer(layout.inner_group))
    reducer = (None if layout.data_group is None
               else dp.GradientReducer(layout.data_group))

    def run_layers(x, generator, m):
        for i, layer in enumerate(encoder.layers):
            g = _fold(generator, _LAYERS, first + i, m)
            if remat:
                x = remat_lib.checkpoint(layer, x, None, generator=g,
                                         policy="none")
            else:
                x = _run_layer(cfg, layer, x, None, generator=g)
        return x

    def chunk(model, batch, generator):
        """One fill and drain: forward, backward into ``p.grad``; returns
        (the last stage's loss, 0 elsewhere; {})."""
        features, labels = batch
        rows = features.shape[0] // micro_n
        # conv2's stride-2 SAME output: ceil(frames / 2) rows a sample.
        shape = (rows, -(-features.shape[-1] // 2), cfg.d_model)
        inputs, outputs = [], []
        if stage == 0:
            micro = encoder.stem(features, _fold(generator, _STEM)).split(rows)
        for m in range(micro_n):
            if stage == 0:
                x = micro[m]
            else:
                x = torch.empty(shape, dtype=cfg.dtype,
                                device=features.device)
                sharding.permute(x, prev, me - 1).requires_grad_(True)
                inputs.append(x)
            y = run_layers(x, generator, m)
            if not last:
                sharding.permute(y.detach().contiguous(), nxt, me)
            outputs.append(y)
        if last:
            hidden = encoder.layer_norm(torch.cat(outputs))
            loss = model.head(hidden, labels=labels,
                              generator=_fold(generator, _HEAD))["loss"]
            loss.backward()
        else:
            # Row-major buffers: a layer's output keeps the strides of the
            # stem's transpose, and the hop moves the bytes as they lie.
            grads = [sharding.permute(torch.empty_like(
                y, memory_format=torch.contiguous_format), nxt, me + 1)
                for y in outputs]
            torch.autograd.backward(outputs, grads)
            loss = torch.zeros((), dtype=torch.float32,
                               device=features.device)
        for x in inputs:
            sharding.permute(x.grad.contiguous(), prev, me)
        return loss.detach(), {}

    def step(state: dp.TrainState, batch, generator: torch.Generator):
        lead = batch[0].shape[0]
        if lead % (grad_accum * micro_n):
            raise ValueError(
                f"local batch {lead} not divisible by grad_accum="
                f"{grad_accum} x num_microbatches={micro_n}")
        optimizer.zero_grad(set_to_none=True)
        before = sharding.BYTES.get("collective-permute", 0)
        if grad_accum > 1:
            loss, _ = dp.accumulate(state.model, batch, generator,
                                    grad_accum, chunk)
        else:
            loss, _ = chunk(state.model, batch, generator)
        named = [(n, p) for n, p in state.model.named_parameters()
                 if p.requires_grad]
        replicated = [p for n, p in named if not n.startswith(LAYERS)]
        for p in replicated:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in replicated]
        own = [p.grad for n, p in named
               if n.startswith(LAYERS) and p.grad is not None]
        if stage_reducer is not None:
            loss = stage_reducer(grads, loss)
        if reducer is not None:
            loss = reducer(grads + own, loss, split=len(grads))
        moved = {}
        permuted = sharding.BYTES.get("collective-permute", 0) - before
        if permuted:
            moved["collective-permute"] = permuted
        reducers = [r for r in (stage_reducer, reducer) if r is not None]
        if reducers:
            moved["all-reduce"] = sum(r.bytes_per_step for r in reducers)
        step.collective_bytes = moved
        optimizer.step()
        return state, loss

    step.collective_bytes = {}
    return step
