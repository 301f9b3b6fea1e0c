"""Flax parameter tree <-> state_dict of the port's Whisper and Wav2Vec2 models.

Flax paths become module paths: ``model/encoder/layers_0/self_attn/q_proj``
-> ``model.encoder.layers.0.self_attn.q_proj``.  Leaves:

* Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in] (transposed);
* Conv ``kernel`` [k, in / groups, out] -> Conv1d ``weight``
  [out, in / groups, k] (the grouped positional conv included);
* LayerNorm ``scale`` -> ``weight``; ``bias`` -> ``bias``;
* Embed ``embedding`` [vocab, E] -> ``weight`` (same layout);
* ``lm_head/kernel`` [E, vocab] -> ``lm_head.weight`` [vocab, E];
* the leaves the port keeps under their flax names, as they are: GroupNorm
  ``gamma`` and ``beta``, the quantizer's ``codevectors`` [G, V, d], the
  encoder's ``layer_weights`` [L] and RelativePositionalEncoding's
  ``pos_embedding`` [max_length, dim].

Values stay f32; ``load_state_dict`` casts them to the dtype the model
holds (config.dtype).

Wav2Vec2's stacked ``scan_layers`` tree: a leaf under a ``layers`` part
with no index after it (flax ``encoder/layers/...``, torch
``encoder.layers.attention...``) carries the layers in a leading [L] dim,
which stays first: a stacked Dense kernel [L, in, out] -> [L, out, in].
Whether a leaf is stacked is read from its path, never from its rank (a
stacked LayerNorm scale is 2-D, a stacked Dense kernel 3-D).

The inverse: ``flax_path(name, ndim)`` and ``flax_shape(name, shape)`` give
a state_dict leaf's flax path and shape (a ``weight`` of rank 1 is a
LayerNorm ``scale``, of rank 3 a Conv ``kernel``, of rank 2 a Dense
``kernel`` unless it is an embedding's table, each rank one more when
stacked; Dense and Conv kernels are transposed back), and
``flax_from_state_dict`` the whole nested tree, so
``params_from_flax(flax_from_state_dict(sd))`` equals ``sd``.  The
tensorsize profiler names its parameter and gradient rows with them, as the
JAX profiler names them from the flax tree.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")
_NAMED = ("gamma", "beta", "codevectors", "layer_weights", "pos_embedding")
_INDEX = re.compile(r"^\d+$")
# The port's nn.Embedding modules: their 2-D ``weight`` is flax's
# ``embedding`` [vocab, E], kept as it is.
_EMBEDDINGS = ("embed_tokens",)


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def torch_name(flax_path: tuple) -> str:
    """('model', 'encoder', 'layers_0', ..., 'kernel') -> 'model.encoder.
    layers.0....weight'."""
    parts = []
    for part in flax_path[:-1]:
        m = _LAYER.match(part)
        parts.extend(["layers", m.group(1)] if m else [part])
    leaf = flax_path[-1]
    parts.append(leaf if leaf in ("bias",) + _NAMED else "weight")
    return ".".join(parts)


def stacked(parts: Sequence[str]) -> bool:
    """Whether the leaf at ``parts`` (a flax path, or a torch name split at
    its dots) lies in the stacked ``scan_layers`` layout: under a
    ``layers`` part with no layer index after it."""
    parts = list(parts)
    return any(part == "layers" and not _INDEX.match(parts[i + 1])
               for i, part in enumerate(parts[:-1]))


def _kernel_axes(ndim: int, stack: bool) -> Tuple[int, ...]:
    """The transposition between a flax kernel and a torch weight (its own
    inverse): all dims reversed, but a stacked leaf's leading [L]."""
    lead = 1 if stack else 0
    if ndim - lead not in (2, 3):   # Dense [in, out], Conv [k, in, out]
        raise ValueError(f"kernel of rank {ndim}")
    return tuple(range(lead)) + tuple(range(ndim - 1, lead - 1, -1))


def _convert_leaf(flax_path: tuple, value: np.ndarray) -> np.ndarray:
    leaf = flax_path[-1]
    if leaf == "kernel":
        try:
            return value.transpose(_kernel_axes(value.ndim,
                                                stacked(flax_path)))
        except ValueError as e:
            raise ValueError(f"{'/'.join(flax_path)}: {e}") from None
    if leaf in ("bias", "scale", "embedding") + _NAMED:
        return value
    raise ValueError(f"{'/'.join(flax_path)}: unknown leaf {leaf!r}")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (nested dict of arrays, the ``"params"`` collection)
    -> state_dict of the port's model of the same tree (f32)."""
    state = {}
    for path, value in _flatten(params).items():
        arr = _convert_leaf(path, value).astype(np.float32)
        state[torch_name(path)] = torch.tensor(arr)  # a contiguous copy
    return state


def flax_module_path(name: str) -> Tuple[str, ...]:
    """A module's dotted name -> its flax path: 'model.encoder.layers.0'
    -> ('model', 'encoder', 'layers_0'); '' (the root) -> ()."""
    path = []
    for part in name.split(".") if name else ():
        if _INDEX.match(part) and path and path[-1] == "layers":
            path[-1] = f"layers_{part}"
        else:
            path.append(part)
    return tuple(path)


def flax_path(name: str, ndim: int) -> Tuple[str, ...]:
    """'model.encoder.layers.0.fc1.weight' (of rank ``ndim``) -> ('model',
    'encoder', 'layers_0', 'fc1', 'kernel'): the inverse of ``torch_name``.
    A stacked leaf's rank counts its leading [L]."""
    parts = name.split(".")
    path = list(flax_module_path(".".join(parts[:-1])))
    leaf = parts[-1]
    if leaf == "weight":
        rank = ndim - stacked(parts)
        if rank == 1:
            leaf = "scale"
        elif rank == 2 and path[-1] in _EMBEDDINGS:
            leaf = "embedding"
        elif rank in (2, 3):
            leaf = "kernel"
        else:
            raise ValueError(f"{name}: weight of rank {ndim}")
    elif leaf not in ("bias",) + _NAMED:
        raise ValueError(f"{name}: unknown leaf {leaf!r}")
    return tuple(path) + (leaf,)


def flax_shape(name: str, shape: Sequence[int]) -> Tuple[int, ...]:
    """The flax shape of the state_dict leaf ``name`` of ``shape``: Dense
    kernels [in, out], Conv kernels [k, in / groups, out] (behind a
    stacked leaf's [L])."""
    shape = tuple(int(n) for n in shape)
    if flax_path(name, len(shape))[-1] == "kernel":
        return tuple(shape[i] for i in _kernel_axes(
            len(shape), stacked(name.split("."))))
    return shape


def flax_from_state_dict(state: Mapping[str, torch.Tensor]) -> dict:
    """state_dict of the port's model -> the flax ``params`` tree (nested
    dict of f32 numpy arrays) that ``params_from_flax`` maps back to it."""
    tree: dict = {}
    for name, tensor in state.items():
        value = tensor.detach().cpu().float().numpy()
        path = flax_path(name, value.ndim)
        if path[-1] == "kernel":
            value = value.transpose(_kernel_axes(value.ndim, stacked(path)))
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return tree
