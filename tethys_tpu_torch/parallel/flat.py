"""Flat-buffer master parameters for the train step (tethys_tpu/parallel/
flat.py, ``--flat_opt``).

The layout is the JAX package's: a module's parameters, in
``named_parameters`` order, each padded to whole chunks of ``CHUNK``
elements, end to end in one f32 vector; ``chunk2var`` maps a chunk to its
parameter, so per-variable sums of squares are chunk partial sums and a
segment sum (Keras ``clipnorm`` on the flat vector).

The PyTorch design needs no relayout.  ``FlatSpec.bind(model)`` makes the
f32 master vector and a gradient buffer of the same layout, and turns
every parameter into a view of its slice of the master (``p.data``) and
its ``p.grad`` into a view of its slice of the gradient buffer.  Autograd
then adds each gradient into its view in place (``AccumulateGrad`` on a
defined ``.grad``), so the gradients exist only in flat form, as in JAX,
with no concatenation and no copy: the step zeroes the buffer in place,
clips it, all-reduces it as one collective, and Keras Adam updates the
one flat parameter (``spec.param``).  A parameter that takes no gradient
(the frozen codevectors, the quantizer's projection behind its argmin)
keeps a zero slice, as JAX's zero gradient: Adam's update of it is exactly
0.

Under bf16 master weights (``master_dtype="bfloat16"``) JAX's flat master
stays f32 (``FlatSpec.flatten`` casts every leaf) and the loss sees bf16
leaves.  So does this one: the model's bf16 parameters and gradients are
views of bf16 shadow buffers of the same layout; ``gather_grad`` casts the
shadow gradient into the f32 one before the clips, ``scatter`` the updated
master back into the shadow after the update, one cast each way.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple, Union

import torch

from tethys_tpu_torch.parallel import dp

# One chunk = one (8, 128) f32 tile on the TPU; every parameter is padded
# to whole chunks, so a per-variable reduction never straddles one.
CHUNK = 1024

Named = Union[torch.nn.Module, Iterable[Tuple[str, torch.Tensor]]]


class FlatSpec:
    """Static layout of a module's parameters inside one flat f32 vector;
    after ``bind`` also the flat buffers the parameters are views of."""

    def __init__(self, named: Named):
        if isinstance(named, torch.nn.Module):
            named = named.named_parameters()
        named = list(named)
        self.names = [n for n, _ in named]
        self.shapes = [tuple(t.shape) for _, t in named]
        self.dtypes = [t.dtype for _, t in named]
        self.sizes = [t.numel() for _, t in named]
        self.padded = [-(-n // CHUNK) * CHUNK for n in self.sizes]
        self.offsets = [0]
        for n in self.padded:
            self.offsets.append(self.offsets[-1] + n)
        self.total = self.offsets[-1]
        self.n_chunks = self.total // CHUNK
        self.n_vars = len(named)
        # Chunks per variable: the segments of chunk2var, which is sorted.
        self.chunks_per_var = torch.tensor([n // CHUNK for n in self.padded])
        self.chunk2var = torch.repeat_interleave(
            torch.arange(self.n_vars), self.chunks_per_var)
        self.param: Optional[torch.nn.Parameter] = None

    # -- flat <-> named tensors ------------------------------------------

    def flatten(self, tensors: Union[Dict[str, torch.Tensor],
                                     List[torch.Tensor]]) -> torch.Tensor:
        """Tensors (by name, or in order) -> a [total] f32 vector, zero
        between them."""
        if isinstance(tensors, dict):
            tensors = [tensors[n] for n in self.names]
        flat = torch.zeros(self.total, dtype=torch.float32,
                           device=tensors[0].device)
        for view, t in zip(self._views(flat), tensors):
            view.copy_(t.detach())
        return flat

    def unflatten(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """[total] -> {name: the view of its slice, shaped}."""
        return dict(zip(self.names, self._views(flat)))

    def _views(self, flat: torch.Tensor) -> List[torch.Tensor]:
        return [flat[off:off + n].view(shape) for off, n, shape in
                zip(self.offsets, self.sizes, self.shapes)]

    # -- per-variable norms on the flat vector -----------------------------

    def _segments(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.chunk2var.device != device:
            self.chunk2var = self.chunk2var.to(device)
            self.chunks_per_var = self.chunks_per_var.to(device)
        return self.chunk2var, self.chunks_per_var

    def per_variable_sumsq(self, flat: torch.Tensor) -> torch.Tensor:
        """[n_vars] f32 sums of squares, one per parameter: chunk partial
        sums, then a segment sum over each parameter's chunks (each sum in
        one fixed order: the same bits every run)."""
        _, lengths = self._segments(flat.device)
        chunk_sq = torch.linalg.vector_norm(
            flat.float().view(self.n_chunks, CHUNK), dim=1).square()
        return torch.segment_reduce(chunk_sq, "sum", lengths=lengths)

    def broadcast_per_variable(self, values: torch.Tensor,
                               flat: torch.Tensor) -> torch.Tensor:
        """``flat`` times a per-variable scalar ([n_vars])."""
        chunk2var, _ = self._segments(flat.device)
        return (flat.view(self.n_chunks, CHUNK)
                * values[chunk2var][:, None]).view(-1)

    def clipnorm_(self, flat: torch.Tensor, max_norm: float) -> None:
        """Keras ``clipnorm`` on the flat vector, in place: each
        parameter's slice scaled by min(1, max_norm / max(|g|, 1e-12)),
        its own L2 norm (``dp.per_variable_clipnorm``'s rule)."""
        norms = self.per_variable_sumsq(flat).sqrt()
        scales = (max_norm / norms.clamp_min(1e-12)).clamp_max(1.0)
        chunk2var, _ = self._segments(flat.device)
        flat.view(self.n_chunks, CHUNK).mul_(
            scales.to(flat.dtype)[chunk2var][:, None])

    # -- the bound buffers -------------------------------------------------

    def bind(self, model: torch.nn.Module) -> torch.nn.Parameter:
        """Makes the f32 master vector (``param``, its ``.grad`` the flat
        gradient) from ``model``'s parameters and turns each parameter and
        its gradient into views of them (of bf16 shadows under bf16
        parameters); returns ``param``."""
        params = [p for _, p in model.named_parameters()]
        if [tuple(p.shape) for p in params] != self.shapes:
            raise ValueError("the model's parameters are not the spec's")
        dtypes = {p.dtype for p in params}
        if len(dtypes) != 1:
            raise ValueError(f"flat parameters take one dtype, not {dtypes}")
        (dtype,) = dtypes
        master = self.flatten(params)
        self.param = torch.nn.Parameter(master)
        self.param.grad = torch.zeros_like(master)
        self.shadow, self.shadow_grad = master, self.param.grad
        self.cast = dtype != torch.float32
        if self.cast:
            self.shadow = master.to(dtype)
            self.shadow_grad = torch.zeros_like(self.shadow)
        for p, view, grad in zip(params, self._views(self.shadow),
                                 self._views(self.shadow_grad)):
            p.data = view
            if p.requires_grad:
                p.grad = grad
        return self.param

    def zero_grad(self) -> None:
        """Zeroes the gradient buffer in place (the views stay)."""
        self.shadow_grad.zero_()

    def gather_grad(self) -> torch.Tensor:
        """The flat f32 gradient the clips, the all-reduce and Adam take:
        the buffer itself, or the bf16 shadow's cast into it."""
        if self.cast:
            self.param.grad.copy_(self.shadow_grad)
        return self.param.grad

    def scatter(self) -> None:
        """The updated master into the bf16 shadow the model reads (no-op
        when the parameters are views of the master itself)."""
        if self.cast:
            self.shadow.copy_(self.param.detach())

    def named_grads(self) -> Dict[str, torch.Tensor]:
        """The flat gradient by parameter name, each in its parameter's
        dtype (JAX's ``unflatten`` of the flat gradient)."""
        return {name: g if g.dtype == dtype else g.to(dtype)
                for (name, g), dtype in zip(
                    self.unflatten(self.param.grad).items(), self.dtypes)}


class FlatKerasAdam(dp.KerasAdam):
    """Keras Adam on the one flat parameter, its ``clipnorm`` per variable
    on the flat vector (``FlatSpec.clipnorm_``)."""

    def __init__(self, spec: FlatSpec, **kwargs):
        if spec.param is None:
            raise ValueError("bind the FlatSpec to its model first")
        super().__init__([spec.param], **kwargs)
        self.spec = spec

    def clip(self, grads: List[torch.Tensor], max_norm: float) -> None:
        (flat,) = grads
        self.spec.clipnorm_(flat, max_norm)


def whisper_optimizer(spec: FlatSpec,
                      learning_rate: float = 1e-4) -> FlatKerasAdam:
    """Flat twin of dp.whisper_optimizer: Keras Adam, eps 1e-7."""
    return FlatKerasAdam(spec, lr=learning_rate, b1=0.9, b2=0.999, eps=1e-7)


def wav2vec2_optimizer(spec: FlatSpec,
                       learning_rate: float = 3e-5) -> FlatKerasAdam:
    """Flat twin of dp.wav2vec2_optimizer: per-variable clipnorm(1.0) on
    the flat vector, then Keras Adam with eps 1e-8."""
    return FlatKerasAdam(spec, lr=learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                         clipnorm=1.0)
