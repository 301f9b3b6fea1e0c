"""Checkpoints with the reference's layout (tethys_tpu/checkpoint.py).

Tagged saves of the model and optimizer state into
``<workspace>/checkpoints/<tag>/`` (the per-epoch cadence of
reference whisper_dist.py:916-919,956) and the final weights-only save into
``<workspace>/model_cache/<name>/`` (whisper_dist.py:1024-1026), with
``torch.save``.  The reference never restores; ``restore``,
``restore_like`` and ``latest_tag`` are the JAX package's extension, which
makes the jobs resumable (``--resume``).

Under a process group the checkpoints are rank 0's: ``save`` and
``save_final_weights`` write on rank 0 alone (``save`` then holds every
rank at a barrier, so no two ranks race on one tag directory), and
``restore_like`` reads on rank 0 and broadcasts what it read (the
parameters, the optimizer's moments and count), so a rank whose
filesystem holds no checkpoint resumes too; the jobs take the tag to
resume from rank 0's ``latest_tag`` the same way.

A save writes into a hidden temporary directory and renames it into place,
so a save cut short leaves no half-written tag, and a tag saved again
becomes the newest: ``latest_tag`` orders the tags by the time their save
finished.  The optimizer's state dict carries ``KerasAdam``'s step count,
so a restored run goes on with the same bias corrections.  The weights
map to the flax params tree with ``convert.flax_from_state_dict`` (the
inverse of ``convert.params_from_flax``).

Under tensor or pipeline parallelism (a state whose ``layout`` has a
model or stage group) a checkpoint and the final weights are still whole:
the ranks of the first model or stage group gather the parameters and
Adam's moments (parallel/tp.py, parallel/pp.py, in the whole model's
names and order) and rank 0 writes them, so a TP or PP checkpoint has a
DP checkpoint's format; a restore reads the whole state and each rank
loads its slices or its stage's layers, so any checkpoint restores into
any layout.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional, Tuple

import torch

from tethys_tpu_torch.parallel import mesh
from tethys_tpu_torch.utils.artifacts import workspace_dir

_MODEL = "model.pt"
_OPTIMIZER = "optimizer.pt"


class CheckpointManager:
    """Tagged synchronous checkpoints of a TrainState."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or os.path.join(workspace_dir(),
                                                   "checkpoints")
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, tag: str) -> str:
        return os.path.abspath(os.path.join(self.directory, tag))

    def save(self, tag: str, state) -> str:
        """Writes ``tag`` on rank 0, then waits for every rank."""
        path = self._path(tag)
        dicts = whole_state_dicts(state)
        if mesh.rank() == 0:
            self._write(path, tag, *dicts)
        mesh.barrier()
        return path

    def _write(self, path: str, tag: str, model_sd, optimizer_sd) -> None:
        tmp = tempfile.mkdtemp(prefix=f".{tag}.", dir=self.directory)
        torch.save(model_sd, os.path.join(tmp, _MODEL))
        torch.save(optimizer_sd, os.path.join(tmp, _OPTIMIZER))
        os.utime(tmp)           # the time the save finished
        old = None
        if os.path.exists(path):
            old = tempfile.mkdtemp(prefix=f".{tag}.old.", dir=self.directory)
            os.rename(path, os.path.join(old, tag))
        os.rename(tmp, path)
        if old is not None:
            shutil.rmtree(old)

    def restore(self, tag: str) -> Tuple[dict, dict]:
        """(model state dict, optimizer state dict) of ``tag``, on the
        host."""
        path = self._path(tag)
        return tuple(torch.load(os.path.join(path, name), map_location="cpu",
                                weights_only=True)
                     for name in (_MODEL, _OPTIMIZER))

    def restore_like(self, tag: str, state):
        """Loads ``tag`` into the live ``state`` (its model and optimizer,
        on their device; the optimizer's moments take their parameter's
        dtype) and returns it.  Under a process group rank 0 reads ``tag``
        and every rank loads what it broadcasts (its slices under tensor
        parallelism, its stage's layers under pipeline parallelism)."""
        model_sd, optimizer_sd = mesh.broadcast_object(
            self.restore(tag) if mesh.rank() == 0 else None)
        layout = _split_layout(state)
        if layout is not None and layout.axis == "model":
            from tethys_tpu_torch.parallel import tp

            model_sd = tp.shard_params(model_sd, layout)
            optimizer_sd = tp.shard_optimizer_state(
                optimizer_sd, state.optimizer, state.model, layout)
        elif layout is not None:
            from tethys_tpu_torch.parallel import pp

            model_sd = pp.stage_params(model_sd, state.model)
            optimizer_sd = pp.stage_optimizer_state(
                optimizer_sd, state.optimizer, state.model)
        state.model.load_state_dict(model_sd)
        state.optimizer.load_state_dict(optimizer_sd)
        return state

    def latest_tag(self, prefix: Optional[str] = None) -> Optional[str]:
        """The tag whose save finished last, optionally among the tags that
        start with ``prefix``: jobs share the checkpoint directory, so each
        passes its own prefix and never restores another job's state."""
        tags = [
            d for d in os.listdir(self.directory)
            if not d.startswith(".")
            and os.path.isdir(os.path.join(self.directory, d))
            and (prefix is None or d.startswith(prefix))
        ]
        if not tags:
            return None
        return max(tags, key=lambda t: os.path.getmtime(self._path(t)))


def _split_layout(state):
    """The state's layout when its parameters are split over a model group
    (tensor parallelism) or a stage group (pipeline parallelism), else
    None."""
    layout = getattr(state, "layout", None)
    if (layout is not None and layout.axis in ("model", "stage")
            and layout.inner > 1):
        return layout
    return None


def whole_state_dicts(state, with_optimizer: bool = True
                      ) -> Optional[Tuple[dict, Optional[dict]]]:
    """(model, optimizer) state dicts of the whole, unsharded state (the
    optimizer's None without ``with_optimizer``), on rank 0; None
    elsewhere.  Under tensor or pipeline parallelism the ranks of the
    first model or stage group gather them (a collective every one of them
    must reach)."""
    layout = _split_layout(state)
    dicts = None
    if layout is None and mesh.rank() == 0:
        dicts = (state.model.state_dict(), state.optimizer.state_dict()
                 if with_optimizer else None)
    elif layout is not None and layout.data_rank == 0:
        if layout.axis == "model":
            from tethys_tpu_torch.parallel import tp as split
        else:
            from tethys_tpu_torch.parallel import pp as split

        dicts = (split.gather_params(state.model, layout),
                 split.gather_optimizer_state(state.optimizer, state.model,
                                              layout)
                 if with_optimizer else None)
    return dicts if mesh.rank() == 0 else None


def save_final_weights(model: torch.nn.Module, name: str,
                       cache_dir: Optional[str] = None,
                       state_dict: Optional[dict] = None) -> Optional[str]:
    """Final weights-only save into ``<workspace>/model_cache/<name>``, on
    rank 0 alone (None on the others): ``state_dict`` when given (the
    whole model's, from ``whole_state_dicts``), else the model's own."""
    if mesh.rank() != 0:
        return None
    cache_dir = cache_dir or os.path.join(workspace_dir(), "model_cache")
    path = os.path.abspath(os.path.join(cache_dir, name))
    os.makedirs(path, exist_ok=True)
    torch.save(model.state_dict() if state_dict is None else state_dict,
               os.path.join(path, "model.pt"))
    return path
