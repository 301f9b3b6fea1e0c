"""Tensor-parallel (data x model) training and serving
(tethys_tpu/parallel/tp.py).

A world of n processes laid out (n // tp, tp) (parallel/mesh.make_2d_mesh):
the batch is split over the data group, and each model group holds one
replica whose parameters are Megatron-sharded over its tp ranks by the JAX
package's rule table (``_spec_for``, on flax paths; ``shard_dim`` maps a
spec to the dim of the port's tensor, whose Linear and Conv weights are
flax's kernels transposed, so a column-parallel kernel P(None, "model") is
dim 0 of the torch weight):

* column-parallel: q/k/v, fc1 and intermediate_dense (their biases too)
  and lm_head (Wav2Vec2's CTC bias replicated);
* row-parallel: out_proj, fc2 and output_dense, their biases replicated
  (added once, after the group's sum: models/whisper.py, wav2vec2.py);
* the embedding over its vocab, the conv kernels over their output
  channels (Whisper's conv biases too; Wav2Vec2's grouped positional conv
  replicated), Wav2Vec2's codevectors over V and their input projection;
* everything else replicated: the norms (Wav2Vec2's GroupNorm gamma and
  beta on a channel shard take their slices, ops/sharding.
  replicated_slice), the positional conv, the feature projection, the
  pretraining heads.

A rank holds exactly the shard JAX's ``param_shardings`` gives its device.
Wav2Vec2's stacked ``scan_layers`` layout is read as JAX's ``_spec_for``
reads it: the stack dim [L] first, never split, so a stacked leaf is one
variable whose slices are all cut on the same dim; its one layer body's
attention and feed-forward take the group, and every function below works
on the stacked names (a whole checkpoint holds the canonical
``...encoder.layers.<leaf>`` [L, ...] tensors).
A dim the group does not divide, which JAX's NamedSharding refuses (the
vocab of whisper-large-v3, 51866, over 4), splits in chunks of
ceil(n / tp), the last one shorter (ops/sharding.shard_range).

Aggregation keeps the JAX step's semantics: a replica is one model group;
the gradients and the logged loss are summed over the data group only
(parallel/dp.make_train_step with the layout).  Each rank holds only its
shards of Adam's moments.  ``gather_params`` and ``gather_optimizer_state``
rebuild the whole state on every rank of the group (collective), so rank 0
writes checkpoints and final weights in the unsharded format;
``shard_params`` and ``shard_optimizer_state`` slice a whole state for a
rank, so a checkpoint restores into any layout.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from tethys_tpu_torch.convert import flax_path, stacked
from tethys_tpu_torch.ops import sharding
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.parallel.mesh import Layout, make_2d_mesh

__all__ = ["make_2d_mesh", "param_shardings", "shard_params",
           "gather_params", "shard_model", "init_tp_state",
           "make_tp_train_step"]


def _spec_for(path: Tuple[str, ...], ndim: int) -> tuple:
    """The JAX package's Megatron rule table (tethys_tpu/parallel/tp.py
    ``_spec_for``) on a flax path: the PartitionSpec's entries, None or
    "model" per dim, () for a replicated leaf."""
    names = [str(p) for p in path]
    joined = "/".join(names)

    def last_is(*keys):
        return any(joined.endswith(k) for k in keys)

    def rule(expected_rank: int, *spec_entries) -> tuple:
        if ndim == expected_rank + 1 and "layers" in names:
            return (None, *spec_entries)
        return tuple(spec_entries)

    # Column-parallel: output dim sharded.
    if last_is("q_proj/kernel", "k_proj/kernel", "v_proj/kernel",
               "fc1/kernel", "intermediate_dense/kernel"):
        return rule(2, None, "model")
    if last_is("q_proj/bias", "k_proj/bias", "v_proj/bias",
               "fc1/bias", "intermediate_dense/bias"):
        return rule(1, "model")
    # Row-parallel: input dim sharded.
    if last_is("out_proj/kernel", "fc2/kernel", "output_dense/kernel"):
        return rule(2, "model", None)
    # Vocab-sharded embedding / LM head.
    if last_is("embed_tokens/embedding"):
        return rule(2, "model", None)
    if last_is("lm_head/kernel"):
        return rule(2, None, "model")
    # Conv kernels [k, in, out]: output channels (the grouped positional
    # conv stays replicated).
    if (last_is("conv1/kernel", "conv2/kernel")
            or any(n.startswith("conv_") for n in names)
            and joined.endswith("kernel")):
        if "pos_conv_embed" not in joined:
            return rule(3, None, None, "model")
    if last_is("conv1/bias", "conv2/bias"):
        return rule(1, "model")
    # Quantizer: codebook [G, V, d] over codevectors; its input projection
    # column-parallel.
    if last_is("quantizer/codevectors"):
        return rule(3, None, "model", None)
    if last_is("project_to_codevector_dim/kernel"):
        return rule(2, None, "model")
    if last_is("project_to_codevector_dim/bias"):
        return rule(1, "model")
    return ()


def shard_dim(name: str, ndim: int) -> Optional[int]:
    """The dim of the state_dict leaf ``name`` that is split over the
    model group, or None for a replicated one."""
    path = flax_path(name, ndim)
    spec = _spec_for(path, ndim)
    if "model" not in spec:
        return None
    dim = spec.index("model")
    # Dense and Conv kernels are stored transposed (convert.py), behind a
    # stacked leaf's [L].
    if path[-1] != "kernel":
        return dim
    return ndim - dim if stacked(path) else ndim - 1 - dim


def param_shardings(params) -> Dict[str, Optional[int]]:
    """{name: shard dim or None} of a model's parameters or a state dict."""
    if isinstance(params, torch.nn.Module):
        params = dict(params.named_parameters())
    return {name: shard_dim(name, t.dim()) for name, t in params.items()}


def _shard(layout: Layout) -> sharding.Shard:
    return sharding.Shard(layout.inner_group, layout.inner, layout.inner_rank)


def shard_params(state: Mapping[str, torch.Tensor],
                 layout: Layout) -> Dict[str, torch.Tensor]:
    """This rank's slices of a whole state dict (contiguous copies)."""
    out = {}
    for name, t in state.items():
        dim = shard_dim(name, t.dim())
        if dim is not None and layout.inner > 1:
            start, stop = sharding.shard_range(t.shape[dim], layout.inner,
                                               layout.inner_rank)
            t = t.narrow(dim, start, stop - start)
        out[name] = t.contiguous().clone()
    return out


def _gather(name: str, t: torch.Tensor, model, layout: Layout):
    sizes = getattr(model, "_tp_full_sizes", {})
    if name not in sizes or layout.inner == 1:
        return t
    # On the host at once, so the card never holds more than one whole
    # tensor beside the shards.
    return sharding.all_gather(t.detach(), shard_dim(name, t.dim()),
                               _shard(layout), sizes[name]).cpu()


def gather_named(tensors: Mapping[str, torch.Tensor], model: torch.nn.Module,
                 layout: Layout) -> Dict[str, torch.Tensor]:
    """Whole tensors from the shards ``tensors`` holds under the names of
    ``model``'s parameters (its state, its gradients), on every rank of
    the model group (a collective of the group); the gathered ones on the
    host."""
    return {name: _gather(name, t, model, layout)
            for name, t in tensors.items()}


def gather_params(model: torch.nn.Module,
                  layout: Layout) -> Dict[str, torch.Tensor]:
    """The whole state dict of a sharded model, on every rank of the
    model group (a collective of the group)."""
    return gather_named(model.state_dict(), model, layout)


def _param_names(model: torch.nn.Module, optimizer) -> Dict[int, str]:
    """The optimizer state dict's parameter index -> parameter name."""
    names = {id(p): n for n, p in model.named_parameters()}
    out, i = {}, 0
    for group in optimizer.param_groups:
        for p in group["params"]:
            out[i] = names[id(p)]
            i += 1
    return out


def _map_state(optimizer_state: dict, model, optimizer, fn) -> dict:
    names = _param_names(model, optimizer)
    params = dict(model.named_parameters())
    state = {}
    for idx, entry in optimizer_state["state"].items():
        name = names[int(idx)]
        state[idx] = {k: fn(name, v, params[name])
                      if torch.is_tensor(v) and v.dim() > 0 else v
                      for k, v in entry.items()}
    return {"state": state, "param_groups": optimizer_state["param_groups"]}


def gather_optimizer_state(optimizer, model, layout: Layout) -> dict:
    """The optimizer's state dict with every moment whole (a collective of
    the model group)."""
    return _map_state(optimizer.state_dict(), model, optimizer,
                      lambda name, v, p: _gather(name, v, model, layout))


def shard_optimizer_state(optimizer_state: dict, optimizer, model,
                          layout: Layout) -> dict:
    """This rank's slices of a whole optimizer state dict."""
    def cut(name, v, p):
        return shard_params({name: v}, layout)[name]

    return _map_state(optimizer_state, model, optimizer, cut)


def check_divides(config, tp: int, name: str = "") -> None:
    """Raises unless ``tp`` divides the heads, d_model and d_ff of a
    Whisper config, or the heads and intermediate_size of a Wav2Vec2 one
    (the vocab, the conv channels and the codevectors may split
    unevenly)."""
    if hasattr(config, "num_attention_heads"):
        family = "Wav2Vec2"
        sizes = {"num_attention_heads": config.num_attention_heads,
                 "intermediate_size": config.intermediate_size}
    else:
        family = "Whisper"
        sizes = {"encoder_attention_heads": config.encoder_attention_heads,
                 "decoder_attention_heads": config.decoder_attention_heads,
                 "d_model": config.d_model, "d_ff": config.d_ff}
    bad = {k: v for k, v in sizes.items() if v % tp}
    if bad:
        raise ValueError(f"tp={tp} does not divide {bad} of "
                         f"{name or f'the {family} config'} {sizes}")


def shard_model(model: torch.nn.Module, layout: Layout) -> torch.nn.Module:
    """Replaces every sharded parameter of a whole model by this rank's
    slice (in place) and hands the sharded modules the model group; the
    identity at tp 1."""
    if layout.inner == 1:
        return model
    if hasattr(model, "config"):
        check_divides(model.config, layout.inner)
    params = dict(model.named_parameters())
    model._tp_full_sizes = {
        name: params[name].shape[dim]
        for name, dim in param_shardings(params).items() if dim is not None}
    local = shard_params({n: p.detach() for n, p in params.items()}, layout)
    for name, p in params.items():
        if name in model._tp_full_sizes:
            owner, leaf = name.rsplit(".", 1)
            setattr(model.get_submodule(owner), leaf, torch.nn.Parameter(
                local[name], requires_grad=p.requires_grad))
    shard = _shard(layout)
    for module in model.modules():
        if hasattr(type(module), "tp"):
            module.tp = shard
    return model


def init_tp_state(model: torch.nn.Module,
                  make_optimizer: Callable, layout: Layout) -> dp.TrainState:
    """Shard a whole model over the layout's model group and build its
    optimizer on the shards (``make_optimizer(parameters)``), so Adam's
    moments exist only as shards."""
    shard_model(model, layout)
    return dp.TrainState(model, make_optimizer(model.parameters()), layout)


def make_tp_train_step(loss_fn, optimizer, layout: Layout,
                       remat: bool = False, hardened: bool = False,
                       return_aux: bool = False, grad_aux_fn=None,
                       grad_accum: int = 1):
    """The train step over the (data, model) layout: dp.make_train_step's
    replica step, its gradients and loss summed over the data group."""
    return dp.make_train_step(loss_fn, optimizer, hardened=hardened,
                              return_aux=return_aux, grad_aux_fn=grad_aux_fn,
                              remat=remat, grad_accum=grad_accum,
                              layout=layout)
