"""Flax parameter tree -> state_dict of the port's Whisper model.

Flax paths become module paths: ``model/encoder/layers_0/self_attn/q_proj``
-> ``model.encoder.layers.0.self_attn.q_proj``.  Leaves:

* Dense ``kernel`` [in, out] -> Linear ``weight`` [out, in] (transposed);
* Conv ``kernel`` [k, in, out] -> Conv1d ``weight`` [out, in, k];
* LayerNorm ``scale`` -> ``weight``; ``bias`` -> ``bias``;
* Embed ``embedding`` [vocab, E] -> ``weight`` (same layout);
* ``lm_head/kernel`` [E, vocab] -> ``lm_head.weight`` [vocab, E].

Values stay f32; ``load_state_dict`` casts them to the dtype the model
holds (config.dtype).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"^layers_(\d+)$")


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
    parts.append("bias" if leaf == "bias" else "weight")
    return ".".join(parts)


def _convert_leaf(flax_path: tuple, value: np.ndarray) -> np.ndarray:
    leaf = flax_path[-1]
    if leaf == "kernel":
        if value.ndim == 2:                       # Dense [in, out]
            return value.T
        if value.ndim == 3:                       # Conv [k, in, out]
            return value.transpose(2, 1, 0)
        raise ValueError(f"{'/'.join(flax_path)}: kernel of rank {value.ndim}")
    if leaf in ("bias", "scale", "embedding"):
        return value
    raise ValueError(f"{'/'.join(flax_path)}: unknown leaf {leaf!r}")


def params_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (nested dict of arrays, the ``"params"`` collection)
    -> state_dict of ``WhisperForConditionalGeneration`` (f32)."""
    state = {}
    for path, value in _flatten(params).items():
        arr = _convert_leaf(path, value).astype(np.float32)
        state[torch_name(path)] = torch.tensor(arr)  # a contiguous copy
    return state
