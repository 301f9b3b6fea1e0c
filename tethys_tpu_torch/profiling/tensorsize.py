"""Tiresias per-iteration tensor size and skewness profiler
(tethys_tpu/profiling/tensorsize.py).

The twin of the JAX profiler, with the same functions, files, headers,
columns and number formats:

* **Byte accounting is static.**  The shapes of a step do not change, so
  the rows of a step are computed once from shapes and dtypes: the batch as
  the data pipeline yields it, the model's outputs, the activation census
  (``intermediate_inventory``), the intra-op tensors no module returns
  (``whisper_intra_op_inventory``, ``wav2vec2_intra_op_inventory``) and the
  gradients.  Parameter and gradient rows carry their flax paths and flax
  shapes (``convert.flax_path``), so every row reads as JAX's does.
* **The activation census is shape-only**, the counterpart of
  ``jax.eval_shape`` over flax's ``capture_intermediates``: the model is
  built from its config under ``FakeTensorMode`` on the CPU (no parameter
  is allocated and nothing is computed; the plain versions of the kernels
  run on fake tensors), with every dropout rate 0 (dropout changes no
  shape, and its seed is drawn from a value a fake tensor does not have).
  Forward hooks record the modules' outputs and ``profiling/capture.record``
  the layers the port runs through functions, under flax's names
  (``<path>/__call__/<call>[/<index or key>]``), in flax's order.
* **Per-value skewness** (the Wav2Vec2 flavor) is computed on the device in
  f32 with the reference's 1e-8 epsilons and comes back through the train
  step's aux, fetched with the step's loss (train/loop.py).
  ``tree_value_skewness`` takes the moments of all its tensors at once:
  one copy into a flat f32 buffer whose tensors start on 4096-element
  chunks, chunk sums in f32, and each tensor's sum of its own chunk sums
  in f64 (``torch.segment_reduce``); the padding is set to its tensor's
  mean before the central moments, so it adds nothing to them.  About 20
  launches for any number of tensors.
* Size-distribution skewness is the Fisher-Pearson estimator
  (scipy.stats.skew, bias=True) in numpy.

Files: ``tensor_sizes.txt``, ``memory_usage.txt``, ``summary.txt``,
``tiresias_tensorsize.txt``, ``skewness_analysis.{txt,json}``,
``final_summary.json``, ``tiresias_result.json``,
``legacy_skewness_result.txt``, and the per-task ``/result`` copies
(``*_tensor_summary.txt``, ``*_tiresias.txt``, ``*_skewness.txt``,
``*_combined.txt``).  Tiresias tensorsize = the mean per-step total MB
after dropping min(3, steps // 4) warm-up steps.  ``gpu_memory_mb`` is
``torch.cuda.memory_allocated`` on a CUDA device and 0.0 on the CPU, as
the JAX profiler reads 0 where a device has no memory stats.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import (Any, Callable, Dict, Iterable, List, Mapping,
                    NamedTuple, Optional, Tuple)

import numpy as np
import torch

from tethys_tpu_torch.convert import flax_module_path, flax_path, flax_shape
from tethys_tpu_torch.profiling import capture

Row = Tuple[str, tuple, str, int]


class TensorSpec(NamedTuple):
    """A shape and a dtype (jax.ShapeDtypeStruct's counterpart)."""
    shape: tuple
    dtype: Any


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace("torch.", "")
    return np.dtype(dtype).name if not isinstance(dtype, str) else dtype


# ---------------------------------------------------------------------------
# Value statistics on the device (Wav2Vec2 flavor)

def value_skewness(x: torch.Tensor) -> torch.Tensor:
    """0-d E[((x - mean)/std)^3] in f32 with the reference's epsilons."""
    flat = x.detach().reshape(-1).float()
    mean = flat.mean()
    variance = (flat - mean).square().mean()
    std = torch.sqrt(variance + 1e-8)
    normalized = (flat - mean) / (std + 1e-8)
    return (normalized ** 3).mean()


_CHUNK = 4096


@functools.lru_cache(maxsize=8)
def _layout(numels: Tuple[int, ...], device: torch.device):
    """Where each tensor starts in the flat buffer, in chunks (a host
    list), and on the device: each chunk's tensor, the chunks of each
    tensor, the element counts, and the padding's positions and tensors."""
    chunks = np.array([-(-n // _CHUNK) for n in numels])
    starts = np.concatenate([[0], np.cumsum(chunks)]).astype(np.int64)
    ends = starts[:-1] * _CHUNK + np.array(numels)
    pad = [np.arange(e, s * _CHUNK) for e, s in zip(ends, starts[1:])]

    def dev(a, dtype):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return (starts.tolist(),
            dev(np.repeat(np.arange(len(numels)), chunks), torch.int64),
            dev(chunks, torch.int64), dev(numels, torch.float64),
            dev(np.concatenate(pad), torch.int64),
            dev(np.repeat(np.arange(len(numels)), [len(p) for p in pad]),
                torch.int64))


def tree_value_skewness(tree: Mapping[str, torch.Tensor], prefix: str
                        ) -> Dict[str, torch.Tensor]:
    """{prefix/name: 0-d skew} over the tensors of more than one element of
    ``tree`` (names as the caller gives them), with ``value_skewness``'s
    epsilons; every moment of every tensor in one pass (module doc)."""
    items = [(name, t.detach()) for name, t in tree.items() if t.numel() > 1]
    if not items:
        return {}
    device = items[0][1].device
    starts, seg, chunks, n, pad_at, pad_of = _layout(
        tuple(t.numel() for _, t in items), device)
    flat = torch.zeros(starts[-1] * _CHUNK, dtype=torch.float32,
                       device=device)
    views = [flat[s * _CHUNK:s * _CHUNK + t.numel()].view(t.shape)
             for s, (_, t) in zip(starts, items)]
    torch._foreach_copy_(views, [t for _, t in items])
    x = flat.view(-1, _CHUNK)

    def tensor_sums(chunk_sums):
        # Each tensor's own chunks, summed in f64 (no tensor sees another).
        return torch.segment_reduce(chunk_sums.double(), "sum", lengths=chunks)

    mean = (tensor_sums(x.sum(1)) / n).float()
    flat[pad_at] = mean[pad_of]        # the padding adds 0 to each moment
    d = x - mean[seg][:, None]
    p = d.square()
    m2 = tensor_sums(p.sum(1)) / n
    p.mul_(d)
    m3 = tensor_sums(p.sum(1)) / n
    std = torch.sqrt(m2 + 1e-8)
    skew = (m3 / (std + 1e-8) ** 3).float()
    return {f"{prefix}/{name}": skew[i] for i, (name, _) in enumerate(items)}


# ---------------------------------------------------------------------------
# Static inventories

def _nbytes(shape, dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * getattr(
        torch, _dtype_name(dtype)).itemsize


def _row(name: str, shape, dtype) -> Row:
    shape = tuple(int(n) for n in shape)
    return (name, shape, _dtype_name(dtype), _nbytes(shape, dtype))


def _sort_key(path: tuple) -> tuple:
    # Keys of one dict are strings, items of one tuple integers, as in the
    # flattening of a pytree.
    return tuple((0, p, "") if isinstance(p, int) else (1, 0, p)
                 for p in path)


def _leaves(value, path=(), skip=()):
    """(path, tensor-like) of every leaf with a shape: dict keys and
    sequence indices become path parts; None is no leaf."""
    if value is None:
        return
    if isinstance(value, Mapping):
        for key, v in value.items():
            if key not in skip:
                yield from _leaves(v, path + (str(key),))
    elif isinstance(value, (tuple, list)) and not isinstance(value, TensorSpec):
        for i, v in enumerate(value):
            yield from _leaves(v, path + (i,))
    elif hasattr(value, "shape"):
        yield path, value


def tensor_inventory(tree: Any, prefix: str) -> List[Row]:
    """[(name, shape, dtype, bytes)] for every leaf of ``tree`` (nested
    mappings and sequences of tensors or TensorSpecs), in the order of a
    flattened pytree (dict keys sorted)."""
    leaves = sorted(_leaves(tree), key=lambda leaf: _sort_key(leaf[0]))
    return [_row("/".join([prefix, *map(str, path)]), v.shape, v.dtype)
            for path, v in leaves]


def parameter_tree(model: torch.nn.Module) -> dict:
    """The model's parameters as the flax params tree of TensorSpecs: flax
    paths, flax shapes, the parameters' dtype."""
    tree: dict = {}
    for name, p in model.named_parameters():
        path = flax_path(name, p.dim())
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = TensorSpec(flax_shape(name, p.shape), p.dtype)
    return tree


def _without_dropout(config):
    """``config`` with every dropout rate 0: the census's forward draws no
    dropout seed (it comes from a value a fake tensor does not hold), and
    dropout changes no shape."""
    return dataclasses.replace(config, **{
        f.name: 0.0 for f in dataclasses.fields(config)
        if f.name.endswith("dropout")})


def _fake_forward(build: Callable, config, args, kwargs, training: bool):
    """Builds ``build(config)`` under FakeTensorMode on the CPU and runs
    its forward on zero TensorSpec inputs; returns (the model, its output,
    the census records, the modules' names)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def fake(v):
        if isinstance(v, TensorSpec):
            return torch.zeros(v.shape, dtype=v.dtype)
        return v

    with FakeTensorMode():
        model = build(_without_dropout(config)).train(training)
        names = {id(m): name for name, m in model.named_modules()}
        with capture.capturing() as records:
            hooks = [m.register_forward_hook(
                lambda mod, _, out: capture.record(mod, out))
                for m in model.modules()]
            try:
                out = model(*map(fake, args),
                            **{k: fake(v) for k, v in kwargs.items()})
            finally:
                for h in hooks:
                    h.remove()
            records = list(records)
    return model, out, records, names


def _specs(tree):
    """A forward's output as TensorSpecs (outside FakeTensorMode)."""
    if isinstance(tree, Mapping):
        return {k: _specs(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_specs(v) for v in tree)
    if hasattr(tree, "shape"):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    return tree


def eval_shape(build: Callable, config, *args, training: bool = False,
               **kwargs):
    """The shapes of ``build(config)(*args, **kwargs)``'s output as a tree
    of TensorSpecs, without computing it (jax.eval_shape's counterpart),
    less the keys the model returns beyond the JAX model's
    (``census_skip``)."""
    model, out, _, _ = _fake_forward(build, config, args, kwargs, training)
    if isinstance(out, Mapping):
        skip = getattr(model, "census_skip", ())
        out = {k: v for k, v in out.items() if k not in skip}
    return _specs(out)


def intermediate_inventory(build: Callable, config, *args,
                           training: bool = False, **kwargs) -> List[Row]:
    """The activation census of ``build(config)``'s forward on ``args``
    (TensorSpecs): every module call's output under the name flax's
    capture_intermediates gives it, ``activation/<flax path>/__call__/<k>``
    and the leaf's index or key, in flax's order (module doc).  Zero device
    compute; no parameter is allocated."""
    _, _, records, names = _fake_forward(build, config, args, kwargs,
                                         training)
    calls: Dict[tuple, int] = {}
    leaves = []
    for module, name, value, channels_first in records:
        path = flax_module_path(names[id(module)]) + ((name,) if name else ())
        k = calls.get(path, 0)
        calls[path] = k + 1
        base = path + ("__call__", k)
        skip = ()
        if name is None:
            base += (0,) if getattr(module, "census_pair", False) else ()
            skip = getattr(module, "census_skip", ())
        for sub, v in _leaves(value, skip=skip):
            shape = tuple(v.shape)
            if channels_first:
                shape = (shape[0], *shape[2:], shape[1])
            leaves.append((base + sub, shape, v.dtype))
    leaves.sort(key=lambda leaf: _sort_key(leaf[0]))
    return [_row("/".join(["activation", *map(str, path)]), shape, dtype)
            for path, shape, dtype in leaves]


def whisper_intra_op_inventory(config, batch_size: int,
                               enc_len: int = 1500, dec_len: int = 100,
                               ) -> List[Row]:
    """The reference profiler's INTRA-OP track points (reference
    whisper_dist_tensorsize.py:646-777) that no module returns: q/k/v
    states, attention scores and probabilities [B, H, Tq, Tkv], the
    pre-merge attention output, the decoder's additive mask (f32, as the
    reference casts it before logging) and the gelu output."""
    act = _dtype_name(config.dtype)
    H_e, H_d = config.encoder_attention_heads, config.decoder_attention_heads
    d_e, d_d = config.d_model // H_e, config.d_model // H_d
    B = batch_size
    items: List[Row] = []

    def add(name, shape, dtype):
        items.append(_row(name, shape, dtype))

    def attention(prefix, heads, head_dim, t_q, t_kv, mask=False):
        add(f"{prefix}/query_states", (B, heads, t_q, head_dim), act)
        add(f"{prefix}/key_states", (B, heads, t_kv, head_dim), act)
        add(f"{prefix}/value_states", (B, heads, t_kv, head_dim), act)
        add(f"{prefix}/attention_scores", (B, heads, t_q, t_kv), act)
        if mask:
            add(f"{prefix}/attention_mask", (B, t_q, t_kv), "float32")
        add(f"{prefix}/attention_probs", (B, heads, t_q, t_kv), act)
        add(f"{prefix}/attention_output_raw", (B, heads, t_q, head_dim), act)

    for i in range(config.encoder_layers):
        attention(f"encoder/layers_{i}/self_attn", H_e, d_e, enc_len, enc_len)
        add(f"encoder/layers_{i}/feed_forward/activation_output",
            (B, enc_len, config.d_ff), act)
    for i in range(config.decoder_layers):
        attention(f"decoder/layers_{i}/self_attn", H_d, d_d, dec_len, dec_len,
                  mask=True)
        attention(f"decoder/layers_{i}/cross_attn", H_d, d_d, dec_len, enc_len)
        add(f"decoder/layers_{i}/feed_forward/activation_output",
            (B, dec_len, config.d_ff), act)
    return items


def wav2vec2_intra_op_inventory(config, batch_size: int, frames: int,
                                ) -> List[Row]:
    """Per encoder layer, attention_scores and attention_probs [B, H, T, T]
    (the reference's attention track points that no module returns)."""
    act = _dtype_name(config.dtype)
    shape = (batch_size, config.num_attention_heads, frames, frames)
    return [_row(f"encoder/layers_{i}/attention/{point}", shape, act)
            for i in range(config.num_hidden_layers)
            for point in ("attention_scores", "attention_probs")]


def conv_output_length(length: int, strides) -> int:
    """TF SAME-padding frame count through the conv stack."""
    for s in strides:
        length = -(-length // s)
    return length


def fisher_pearson_skew(values: List[float]) -> float:
    """scipy.stats.skew (bias=True) semantics in numpy."""
    arr = np.asarray(values, dtype=np.float64)
    if arr.size < 3:
        return 0.0
    m = arr.mean()
    m2 = np.mean((arr - m) ** 2)
    if m2 == 0:
        return 0.0
    m3 = np.mean((arr - m) ** 3)
    return float(m3 / m2 ** 1.5)


def device_memory_mb(device=None) -> float:
    """Bytes the caching allocator holds in tensors on ``device``, in MB:
    torch.cuda.memory_allocated on a CUDA device, 0.0 on the CPU."""
    device = torch.device(device if device is not None else "cpu")
    if device.type == "cuda":
        return torch.cuda.memory_allocated(device) / (1024 * 1024)
    return 0.0


def host_memory_mb() -> float:
    """The process's resident set in MB (psutil, else /proc/self/statm)."""
    try:
        import psutil

        return psutil.Process().memory_info().rss / (1024 * 1024)
    except ImportError:
        pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / (1024 * 1024)
    except (OSError, ValueError, IndexError):
        return 0.0


# Hard-coded external comparison constants printed by the reference next to
# its own measurement (reference wav2vec2_dist_tensorsize.py:2117-2164; they
# describe *other* models, not this one).
REFERENCE_TENSORSIZE_MB = {
    "alexnet": 6.7, "vgg16": 527.8, "resnet50": 97.5, "inception3": 94.7,
    "bert": 1560.0, "gpt2": 4000.0,
}
REFERENCE_SKEWNESS = {
    "alexnet": 2.6, "vgg16": 2.2, "resnet50": 1.5, "inception3": 1.8,
    "bert": 9.2, "gpt2m": 9.9,
}


class TensorProfiler:
    """Per-step tensor byte accounting with the reference's file contracts.
    ``device``: where ``gpu_memory_mb`` is read (the CPU reads 0.0)."""

    def __init__(self, log_dir: Optional[str] = None,
                 model_name: str = "whisper_small",
                 flavor: str = "whisper", device=None):
        from tethys_tpu_torch.utils.artifacts import workspace_dir

        self.log_dir = log_dir or os.path.join(workspace_dir(), "tensor_logs")
        self.model_name = model_name
        self.flavor = flavor
        self.device = device
        self.current_step = 0
        self.current_step_size = 0
        self.step_tensor_sizes: List[float] = []
        self.operation_tensor_sizes: Dict[str, List[int]] = {}
        self.tensor_details: List[dict] = []
        self.value_skews: Dict[str, List[float]] = {}
        self.memory_usage: List[dict] = []
        self.parameter_stats: Optional[dict] = None

        os.makedirs(self.log_dir, exist_ok=True)
        self.tensor_log_file = open(
            os.path.join(self.log_dir, "tensor_sizes.txt"), "w")
        if flavor == "wav2vec2":
            self.tensor_log_file.write(
                "step,operation,tensor_type,size_bytes,size_mb,shape,dtype\n")
        else:
            self.tensor_log_file.write(
                "step,operation,tensor_type,size_bytes,size_mb,shape\n")
        self.memory_log_file = open(
            os.path.join(self.log_dir, "memory_usage.txt"), "w")
        self.memory_log_file.write("step,gpu_memory_mb,cpu_memory_mb\n")
        self.summary_log_file = open(
            os.path.join(self.log_dir, "summary.txt"), "w")
        self.summary_log_file.write(
            "step,total_tensor_size_mb,num_operations,avg_tensor_size_mb\n")
        self.tiresias_log_file = open(
            os.path.join(self.log_dir, "tiresias_tensorsize.txt"), "w")
        self.tiresias_log_file.write("step,tensorsize_mb\n")
        print(f"TensorProfiler initialized - log dir: {self.log_dir}")

    # -- logging --------------------------------------------------------

    def log_tensor_size(self, name: str, shape, dtype,
                        tensor_type: str = "activation") -> int:
        size_bytes = _nbytes(shape, dtype)
        size_mb = size_bytes / (1024 * 1024)
        self.current_step_size += size_bytes
        self.operation_tensor_sizes.setdefault(name, []).append(size_bytes)
        self.tensor_details.append({
            "step": self.current_step, "operation": name,
            "tensor_type": tensor_type, "size_bytes": size_bytes,
            "size_mb": size_mb, "shape": list(shape),
        })
        shape_str = str(list(shape)).replace(",", ";")
        if self.flavor == "wav2vec2":
            self.tensor_log_file.write(
                f"{self.current_step},{name},{tensor_type},{size_bytes},"
                f"{size_mb:.4f},{shape_str},{_dtype_name(dtype)}\n")
        else:
            self.tensor_log_file.write(
                f"{self.current_step},{name},{tensor_type},{size_bytes},"
                f"{size_mb:.4f},{shape_str}\n")
        return size_bytes

    def log_inventory(self, inventory: Iterable[Row], tensor_type: str
                      ) -> None:
        for name, shape, dtype, _ in inventory:
            self.log_tensor_size(name, shape, dtype, tensor_type)

    def log_model_parameters(self, model: torch.nn.Module) -> dict:
        """The model's parameters, as the JAX profiler logs the params
        tree: flax paths and shapes, in the tree's order."""
        total = 0
        for name, shape, dtype, nbytes in tensor_inventory(
                parameter_tree(model), "param"):
            self.log_tensor_size(name, shape, dtype, "parameter")
            total += nbytes
        self.parameter_stats = {
            "step": self.current_step,
            "total_parameters_mb": total / (1024 * 1024),
            "trainable_parameters_mb": total / (1024 * 1024),
            "non_trainable_parameters_mb": 0.0,
        }
        return self.parameter_stats

    def log_value_skews(self, skews: Dict[str, float]) -> None:
        for name, value in skews.items():
            self.value_skews.setdefault(name, []).append(float(value))

    def log_memory_usage(self) -> dict:
        info = {
            "step": self.current_step,
            "gpu_memory_mb": device_memory_mb(self.device),
            "cpu_memory_mb": host_memory_mb(),
        }
        self.memory_usage.append(info)
        self.memory_log_file.write(
            f"{self.current_step},{info['gpu_memory_mb']:.2f},"
            f"{info['cpu_memory_mb']:.2f}\n")
        self.memory_log_file.flush()
        return info

    def start_step(self, step: int) -> None:
        self.current_step = step
        self.current_step_size = 0

    def end_step(self) -> float:
        step_size_mb = self.current_step_size / (1024 * 1024)
        self.step_tensor_sizes.append(step_size_mb)
        num_ops = len([d for d in self.tensor_details
                       if d["step"] == self.current_step])
        avg = step_size_mb / num_ops if num_ops else 0.0
        self.summary_log_file.write(
            f"{self.current_step},{step_size_mb:.4f},{num_ops},{avg:.4f}\n")
        self.summary_log_file.flush()
        self.tiresias_log_file.write(
            f"{self.current_step},{step_size_mb:.4f}\n")
        self.tiresias_log_file.flush()
        return step_size_mb

    # -- analytics ------------------------------------------------------

    def get_tiresias_tensorsize(self) -> float:
        if not self.step_tensor_sizes:
            return 0.0
        warmup = min(3, len(self.step_tensor_sizes) // 4)
        stable = self.step_tensor_sizes[warmup:]
        if not stable:
            return float(np.mean(self.step_tensor_sizes))
        return float(np.mean(stable))

    def calculate_tensor_skewness(self) -> float:
        sizes = [d["size_mb"] for d in self.tensor_details
                 if d["size_bytes"] > 0]
        return fisher_pearson_skew(sizes)

    def calculate_operation_skewness(self) -> Dict[str, float]:
        out = {}
        for op, sizes in self.operation_tensor_sizes.items():
            if len(sizes) >= 3:
                out[op] = fisher_pearson_skew(
                    [s / (1024 * 1024) for s in sizes])
        return out

    def calculate_layer_type_skewness(self) -> Dict[str, float]:
        by_type: Dict[str, List[float]] = {}
        for d in self.tensor_details:
            if d["size_mb"] > 0:
                by_type.setdefault(d["tensor_type"], []).append(d["size_mb"])
        return {t: fisher_pearson_skew(v)
                for t, v in by_type.items() if len(v) >= 3}

    def get_skewness_summary(self) -> dict:
        sizes = [d["size_mb"] for d in self.tensor_details if d["size_mb"] > 0]
        summary = {
            "model_skewness": self.calculate_tensor_skewness(),
            "operation_skewness": self.calculate_operation_skewness(),
            "layer_type_skewness": self.calculate_layer_type_skewness(),
            "tensor_count": len(sizes),
            "mean_tensor_size_mb": float(np.mean(sizes)) if sizes else 0,
            "std_tensor_size_mb": float(np.std(sizes)) if sizes else 0,
            "min_tensor_size_mb": float(np.min(sizes)) if sizes else 0,
            "max_tensor_size_mb": float(np.max(sizes)) if sizes else 0,
        }
        if self.value_skews:
            summary["value_skewness"] = {
                name: float(np.mean(vals))
                for name, vals in self.value_skews.items()
            }
        return summary

    def log_skewness_analysis(self) -> dict:
        summary = self.get_skewness_summary()
        with open(os.path.join(self.log_dir, "skewness_analysis.txt"), "w") as f:
            f.write("=== Tensor Skewness Analysis ===\n")
            f.write(f"Model Skewness: {summary['model_skewness']:.2f}\n")
            f.write(f"Total Tensors: {summary['tensor_count']}\n")
            f.write(f"Mean Tensor Size: {summary['mean_tensor_size_mb']:.4f} MB\n")
            f.write(f"Std Tensor Size: {summary['std_tensor_size_mb']:.4f} MB\n")
            f.write(f"Min Tensor Size: {summary['min_tensor_size_mb']:.4f} MB\n")
            f.write(f"Max Tensor Size: {summary['max_tensor_size_mb']:.4f} MB\n")
            f.write("\n=== Layer Type Skewness ===\n")
            for layer_type, skew in summary["layer_type_skewness"].items():
                f.write(f"{layer_type}: {skew:.2f}\n")
            f.write("\n=== Top 10 Operation Skewness ===\n")
            top = sorted(summary["operation_skewness"].items(),
                         key=lambda kv: abs(kv[1]), reverse=True)[:10]
            for op, skew in top:
                f.write(f"{op}: {skew:.2f}\n")
        with open(os.path.join(self.log_dir, "skewness_analysis.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)
        return summary

    def get_summary(self) -> dict:
        if not self.step_tensor_sizes:
            return {}
        skew = self.get_skewness_summary()
        summary = {
            "total_steps": len(self.step_tensor_sizes),
            "tiresias_tensorsize_mb": self.get_tiresias_tensorsize(),
            "avg_step_tensorsize_mb": float(np.mean(self.step_tensor_sizes)),
            "max_step_tensorsize_mb": float(np.max(self.step_tensor_sizes)),
            "min_step_tensorsize_mb": float(np.min(self.step_tensor_sizes)),
            "std_step_tensorsize_mb": float(np.std(self.step_tensor_sizes)),
            "total_operations": len(self.tensor_details),
            "step_tensor_sizes": self.step_tensor_sizes,
            "model_skewness": skew["model_skewness"],
            "skewness_analysis": skew,
            "avg_memory_usage": float(np.mean(
                [m["gpu_memory_mb"] for m in self.memory_usage]))
            if self.memory_usage else 0.0,
            "peak_memory_usage": float(np.max(
                [m["gpu_memory_mb"] for m in self.memory_usage]))
            if self.memory_usage else 0.0,
        }
        op_stats = {}
        for op, sizes in self.operation_tensor_sizes.items():
            op_stats[op] = {
                "total_size_mb": sum(sizes) / (1024 * 1024),
                "avg_size_mb": float(np.mean(sizes)) / (1024 * 1024),
                "count": len(sizes),
            }
        summary["operation_stats"] = op_stats
        return summary

    def save_final_results(self) -> dict:
        summary = self.get_summary()
        with open(os.path.join(self.log_dir, "final_summary.json"), "w") as f:
            json.dump(summary, f, indent=2, default=str)
        tiresias_result = {
            "model": self.model_name,
            "tensorsize_mb": summary.get("tiresias_tensorsize_mb", 0.0),
            "skewness": summary.get("model_skewness", 0.0),
            "total_steps": summary.get("total_steps", 0),
            "measurement_method": "Tiresias_style",
        }
        with open(os.path.join(self.log_dir, "tiresias_result.json"), "w") as f:
            json.dump(tiresias_result, f, indent=2)
        with open(os.path.join(self.log_dir,
                               "legacy_skewness_result.txt"), "w") as f:
            f.write("model,skewness\n")
            f.write(f"{self.model_name},"
                    f"{summary.get('model_skewness', 0.0):.1f}\n")
        self.log_skewness_analysis()
        return summary

    def write_result_copies(self, jct: float, task_type: str,
                            task_index: int) -> None:
        """Per-task /result copies (reference
        wav2vec2_dist_tensorsize.py:2215-2259)."""
        from tethys_tpu_torch.utils.artifacts import read_model_name, result_dir

        name = read_model_name()
        if name is None:
            return
        base = os.path.join(result_dir(), name)
        prefix = f"{task_type}_{task_index}"
        summary = self.get_summary()
        tiresias = summary.get("tiresias_tensorsize_mb", 0.0)
        skew = summary.get("model_skewness", 0.0)
        try:
            with open(os.path.join(base, f"{prefix}_tensor_summary.txt"), "w") as f:
                f.write(f"Model Size: {self.model_name}\n")
                f.write(f"Total Steps: {summary.get('total_steps', 0)}\n")
                f.write(f"Average GPU Memory (MB): "
                        f"{summary.get('avg_memory_usage', 0.0):.2f}\n")
                f.write(f"Peak GPU Memory (MB): "
                        f"{summary.get('peak_memory_usage', 0.0):.2f}\n")
                f.write(f"Tiresias TensorSize (MB): {tiresias:.2f}\n")
                f.write(f"Model Skewness: {skew:.4f}\n")
                f.write(f"JCT (seconds): {jct:.2f}\n")
            with open(os.path.join(base, f"{prefix}_tiresias.txt"), "w") as f:
                f.write("model\ttensorsizes\n")
                f.write(f"{self.model_name}\t{tiresias:.1f}\n")
            with open(os.path.join(base, f"{prefix}_skewness.txt"), "w") as f:
                f.write("model,skewness\n")
                f.write(f"{self.model_name},{skew:.1f}\n")
            with open(os.path.join(base, f"{prefix}_combined.txt"), "w") as f:
                f.write("model,tensorsize_mb,skewness\n")
                f.write(f"{self.model_name},{tiresias:.1f},{skew:.1f}\n")
        except Exception as e:  # noqa: BLE001 — /result may be absent
            print(f"result copy write failed: {e}")

    def print_comparison_tables(self) -> None:
        """Reference-style comparison against external model constants."""
        tiresias = self.get_tiresias_tensorsize()
        skew = self.calculate_tensor_skewness()
        print("\n=== Tiresias TensorSize comparison (MB/iteration) ===")
        for model, size in REFERENCE_TENSORSIZE_MB.items():
            print(f"  {model:<12} {size:>8.1f}")
        print(f"  {self.model_name:<12} {tiresias:>8.1f}  <- measured")
        print("\n=== Skewness comparison ===")
        for model, s in REFERENCE_SKEWNESS.items():
            print(f"  {model:<12} {s:>8.1f}")
        print(f"  {self.model_name:<12} {skew:>8.1f}  <- measured")

    def close(self) -> None:
        for f in (self.tensor_log_file, self.memory_log_file,
                  self.summary_log_file, self.tiresias_log_file):
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass
        print("TensorProfiler closed")
