"""Activation checkpointing with the JAX package's policies (jax.checkpoint
and flax's nn.remat).

``checkpoint(fn, *args, generator=g, policy=p)`` runs ``fn(*args, g)``
under non-reentrant ``torch.utils.checkpoint``: the forward keeps what the
policy saves, and the backward recomputes the rest of the region.  The
policies:

* ``save_flash``: JAX's ``save_only_these_names("flash_o", "flash_lse")``
  (models/whisper.py's ``_remat_policy``): the (o, lse) of each flash
  call are kept (ops/flash_attention.saving), so the recompute launches no
  flash forward; everything else is recomputed.  This is not a torch
  selective-checkpoint policy: those run every op of the region through a
  Python dispatch mode, forward and recompute, and on the card that cost
  more host time than the flash forward it saves (PERF.md);
* ``none``: everything is recomputed, the flash forward too;
* ``dots_saveable``: JAX's ``dots_with_no_batch_dims_saveable``, the
  policy of the whole-loss remat (parallel/dp.make_train_step(remat=True)):
  the outputs of 2-D products (``aten.mm`` and ``aten.addmm``, what
  ``F.linear`` dispatches to) are saved; ``bmm``, the flash op, the
  csrc/qkv_proj.cu projections and all else are recomputed (JAX's Pallas
  custom calls are not dots either), through torch's selective
  checkpointing.

Generator replay.  Dropout seeds and Wav2Vec2's negatives are drawn on the
host from an explicit CPU ``torch.Generator``, which
``preserve_rng_state`` does not restore: a naive recompute would draw
other seeds and backpropagate through other masks than the forward used.
So the generator's state is taken before the region, and the recompute
draws from a clone restored to it.  The forward draws from the caller's
generator itself, which ends where it would without the checkpoint: with
remat on and off the same seeds are drawn in the same order.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils import checkpoint as torch_checkpoint
from torch.utils.checkpoint import CheckpointPolicy

from tethys_tpu_torch.ops import flash_attention, sharding

POLICIES = ("save_flash", "none", "dots_saveable")
# The values of WhisperConfig.remat_policy, as the JAX config's.
LAYER_POLICIES = ("save_flash", "none")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_saveable(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE




def check_policy(policy: str, allowed=POLICIES) -> None:
    """Raises for a policy not in ``allowed`` (as JAX's ``_remat_policy``
    raises when the model is built)."""
    if policy not in allowed:
        raise ValueError(f"unknown remat_policy: {policy!r}")


def checkpoint(fn: Callable, *args, generator: Optional[torch.Generator],
               policy: str):
    """``fn(*args, generator)`` with its activations checkpointed under
    ``policy`` and the generator's draws replayed in the recompute (module
    doc)."""
    check_policy(policy)
    state = None if generator is None else generator.get_state()
    flash = flash_attention.SavedOutputs()
    # The recompute runs in the autograd engine's thread: it gets the
    # forward's sequence-parallel rules back (ops/sharding.py).
    seq_rules = sharding.current_seq_rules()
    calls = 0

    def run(*inner_args):
        nonlocal calls
        calls += 1
        replaying = calls > 1
        draws = generator
        if replaying and generator is not None:
            draws = torch.Generator(device=generator.device)
            draws.set_state(state)
        with sharding.seq_axis_rules(seq_rules):
            if policy != "save_flash":
                return fn(*inner_args, draws)
            with flash_attention.saving(flash, replay=replaying):
                return fn(*inner_args, draws)

    kwargs = {}
    if policy == "dots_saveable":
        kwargs["context_fn"] = functools.partial(
            torch_checkpoint.create_selective_checkpoint_contexts,
            _dots_saveable)
    return torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                       **kwargs)
