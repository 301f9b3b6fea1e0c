"""Sequence-parallel (data x seq) training (tethys_tpu/parallel/sp.py).

A world of n processes laid out (n // sp, sp) (parallel/mesh.
make_seq_mesh): the batch is split over the data group, and each seq group
holds one replica with every parameter replicated.  Inside the replica the
encoder's time axis is split over the seq group (models/whisper.py and
models/wav2vec2.py under ``ops.sharding.seq_axis_rules``, which the step
installs): Whisper's stem and Wav2Vec2's feature encoder and quantizer run
whole on every rank, the encoder layers on the rank's rows (attention
against K and V gathered over the group), and the rows are gathered before
Whisper's final LayerNorm and decoder, or as Wav2Vec2's encoder output
leaves it for the heads and the loss.

So a parameter of the model's ``seq_sharded`` submodules (the encoder
layers; Wav2Vec2's weighted layer sum too) has a partial gradient on each
rank (its rows' share), summed over the seq group once (parallel/dp.py);
every other parameter has the whole gradient on every rank and is not
summed over the seq group: it is broadcast from the group's first rank,
since the flash backward's atomics (and cuDNN's convolution backward)
leave the ranks' bits a rounding apart and the copies of a replica must
not drift.  Then, as in the JAX step, the gradients and the logged loss
are summed over the data group only; the hardened step (Wav2Vec2) clips
after the seq group's sums (parallel/dp.py's module doc).
"""

from __future__ import annotations

from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.parallel.mesh import Layout, make_seq_mesh

__all__ = ["make_seq_mesh", "init_sp_state", "make_sp_train_step"]


def init_sp_state(model, optimizer, layout: Layout) -> dp.TrainState:
    """The replicated state of the (data, seq) layout."""
    return dp.TrainState(model, optimizer, layout)


def make_sp_train_step(loss_fn, optimizer, layout: Layout,
                       remat: bool = False, hardened: bool = False,
                       return_aux: bool = False, grad_aux_fn=None,
                       grad_accum: int = 1):
    """The train step over the (data, seq) layout (module doc)."""
    return dp.make_train_step(loss_fn, optimizer, hardened=hardened,
                              return_aux=return_aux, grad_aux_fn=grad_aux_fn,
                              remat=remat, grad_accum=grad_accum,
                              layout=layout)
