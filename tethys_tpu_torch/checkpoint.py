"""Checkpoint saves with the reference's layout (tethys_tpu/checkpoint.py).

Tagged saves of the model and optimizer state into
``<workspace>/checkpoints/<tag>/`` (the per-epoch cadence of
reference whisper_dist.py:916-919,956) and the final weights-only save into
``<workspace>/model_cache/<name>/`` (whisper_dist.py:1024-1026), with
``torch.save``.  Restore, ``--resume`` and flax interop are not ported yet
(ROADMAP.md, queue 1 item 4).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from tethys_tpu_torch.utils.artifacts import workspace_dir


class CheckpointManager:
    """Tagged synchronous checkpoints of a TrainState."""

    def __init__(self, directory: Optional[str] = None):
        self.directory = directory or os.path.join(workspace_dir(),
                                                   "checkpoints")
        os.makedirs(self.directory, exist_ok=True)

    def save(self, tag: str, state) -> str:
        path = os.path.abspath(os.path.join(self.directory, tag))
        os.makedirs(path, exist_ok=True)
        torch.save(state.model.state_dict(), os.path.join(path, "model.pt"))
        torch.save(state.optimizer.state_dict(),
                   os.path.join(path, "optimizer.pt"))
        return path


def save_final_weights(model: torch.nn.Module, name: str,
                       cache_dir: Optional[str] = None) -> str:
    """Final weights-only save into ``<workspace>/model_cache/<name>``."""
    cache_dir = cache_dir or os.path.join(workspace_dir(), "model_cache")
    path = os.path.abspath(os.path.join(cache_dir, name))
    os.makedirs(path, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(path, "model.pt"))
    return path
