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
        if mesh.rank() == 0:
            self._write(path, tag, state)
        mesh.barrier()
        return path

    def _write(self, path: str, tag: str, state) -> None:
        tmp = tempfile.mkdtemp(prefix=f".{tag}.", dir=self.directory)
        torch.save(state.model.state_dict(), os.path.join(tmp, _MODEL))
        torch.save(state.optimizer.state_dict(), os.path.join(tmp, _OPTIMIZER))
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
        and every rank loads what it broadcasts."""
        model_sd, optimizer_sd = mesh.broadcast_object(
            self.restore(tag) if mesh.rank() == 0 else None)
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


def save_final_weights(model: torch.nn.Module, name: str,
                       cache_dir: Optional[str] = None) -> Optional[str]:
    """Final weights-only save into ``<workspace>/model_cache/<name>``, on
    rank 0 alone (None on the others)."""
    if mesh.rank() != 0:
        return None
    cache_dir = cache_dir or os.path.join(workspace_dir(), "model_cache")
    path = os.path.abspath(os.path.join(cache_dir, name))
    os.makedirs(path, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(path, "model.pt"))
    return path
