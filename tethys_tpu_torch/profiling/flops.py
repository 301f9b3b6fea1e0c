"""FLOPs of one train step (tethys_tpu/profiling/flops.py).

``step_flops`` runs one whole step (forward, backward, optimizer) under
``torch.utils.flop_counter.FlopCounterMode``, which counts the products
PyTorch runs (mm, bmm, addmm, convolutions).  The kernels of ``csrc/`` are
launched through ctypes, so the counter does not see them, as XLA's cost
model does not see the Pallas custom calls.  Their products are counted
here from the shapes instead:

  one attention site, forward:  QK^T + PV           = 2 products
  flash backward (csrc/flash_bwd.cu): recompute S,
    dV = P^T dO, dP = dO V^T, dK = dS^T Q, dQ = dS K = 5 products

each 2*B*H*Tq*Tk*D FLOPs over the unpadded lengths (model FLOPs, not the
kernel's padded 1536 keys).  A checkpoint that runs the flash forward again
(the whole-loss remat, ``remat_layers`` with the ``none`` policy) adds its
2 products a site; under ``save_flash`` the forward runs once.  The
counter sees the torch ops that a checkpoint recomputes, since it is
active through the backward: the step's FLOPs, and the bench's MFU, count
what runs, as XLA's cost analysis of the rematerialised JAX step does.
Which sites take the flash kernels is decided by the gate the model uses
(``ops.attention.flash_active``), on the card only: on the CPU the plain
attention runs as ``bmm``, the counter sees it, and its backward makes 4
products where the flash backward makes 5.

With ``TETHYS_FUSED_QKV=1`` on the card the forward projections of Whisper
run in csrc/qkv_proj.cu, which the counter does not see either (their
backward is plain ``matmul``); they are counted here too, so that the
step's total does not depend on the variable.  The JAX package leaves
them out of its count.

The counter's own formula for a convolution's backward bills the weight
gradient of a grouped convolution ``groups`` times (Wav2Vec2's positional
conv has 16 groups: 15 products too many, ~7% of the base step); here each
of the backward's two products costs what the forward costs, as for any
convolution.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from tethys_tpu_torch.configs import WhisperConfig
from tethys_tpu_torch.ops.attention import flash_active
from tethys_tpu_torch.ops.qkv import fused_qkv_enabled

# Products per attention site per pass: see the module doc.
_FWD_MATMULS = 2
_BWD_MATMULS = 5


def _site_flops(batch: int, heads: int, tq: int, tk: int, head_dim: int,
                training: bool, fwd_recomputes: int = 0) -> float:
    """FLOPs of ONE flash attention site; ``fwd_recomputes`` counts extra
    whole-forward replays (a whole-loss checkpoint replays the forward)."""
    per_matmul = 2.0 * batch * heads * tq * tk * head_dim
    matmuls = _FWD_MATMULS * (1 + fwd_recomputes)
    if training:
        matmuls += _BWD_MATMULS
    return per_matmul * matmuls


def flash_forward_recomputes(config, *, training: bool = True,
                             whole_loss_remat: bool = False) -> int:
    """How many times a train step runs each flash forward again: once
    under the whole-loss checkpoint, whose policy saves dots only, and
    once under ``remat_layers`` with the ``none`` policy; ``save_flash``
    saves the forward's outputs and runs it once.  The layers checkpoint
    in training only.  (JAX's ``whisper_custom_call_flops`` counts the
    first case only.)"""
    layer_none = (training and getattr(config, "remat_layers", False)
                  and getattr(config, "remat_policy", "save_flash") == "none")
    return 1 if whole_loss_remat or layer_none else 0


def whisper_custom_call_flops(config, batch: int, label_len: int,
                              feature_frames: int = 3000, *,
                              training: bool = True,
                              whole_loss_remat: bool = False,
                              is_cuda: bool = True) -> float:
    """FLOPs of the flash kernels in one Whisper train or eval step:
    encoder self-attention at the conv stem's output length
    (ceil(frames / 2)), decoder cross-attention (label_len x enc_len) and
    decoder self-attention (label_len), each where the gate takes it, with
    the forward's recomputes (``flash_forward_recomputes``)."""
    enc_len = -(-feature_frames // 2)
    use_flash = getattr(config, "use_flash_attention", True)
    head_dim = config.d_model // config.encoder_attention_heads
    recomp = flash_forward_recomputes(config, training=training,
                                      whole_loss_remat=whole_loss_remat)
    total = 0.0
    if flash_active(use_flash, enc_len, enc_len, is_cuda):
        total += config.encoder_layers * _site_flops(
            batch, config.encoder_attention_heads, enc_len, enc_len,
            head_dim, training, recomp)
    if flash_active(use_flash, label_len, enc_len, is_cuda):
        total += config.decoder_layers * _site_flops(
            batch, config.decoder_attention_heads, label_len, enc_len,
            head_dim, training, recomp)
    if flash_active(use_flash, label_len, label_len, is_cuda):
        total += config.decoder_layers * _site_flops(
            batch, config.decoder_attention_heads, label_len, label_len,
            head_dim, training, recomp)
    return total


def wav2vec2_custom_call_flops(config, batch: int, frames: int, *,
                               training: bool = True,
                               whole_loss_remat: bool = False,
                               is_cuda: bool = True) -> float:
    """Wav2Vec2's encoder self-attention: 0 at pretraining clip lengths
    (T ~ 100 never passes the gate, and the config asks for no flash
    kernel); the flash count where a config asks for it at T >= 512."""
    use_flash = getattr(config, "use_flash_attention", False)
    if not flash_active(use_flash, frames, frames, is_cuda):
        return 0.0
    head_dim = config.hidden_size // config.num_attention_heads
    return config.num_hidden_layers * _site_flops(
        batch, config.num_attention_heads, frames, frames, head_dim,
        training, flash_forward_recomputes(
            config, training=training, whole_loss_remat=whole_loss_remat))


def whisper_fused_projection_flops(config, batch: int, label_len: int,
                                   feature_frames: int = 3000) -> float:
    """Forward products of csrc/qkv_proj.cu in one Whisper step: per
    encoder layer q, k, v and out over enc_len rows; per decoder layer q,
    k, v and out of self-attention and q and out of cross-attention over
    label_len rows, and cross-attention's k and v over enc_len rows."""
    enc_len = -(-feature_frames // 2)
    per_row = 2.0 * batch * config.d_model * config.d_model
    return per_row * (config.encoder_layers * 4 * enc_len
                      + config.decoder_layers * (6 * label_len + 2 * enc_len))


def custom_call_flops(config, batch, whole_loss_remat: bool = False) -> float:
    """The FLOPs of one train step that the counter cannot see, at this
    batch's shapes: Whisper's (features, labels) or Wav2Vec2's (audio,
    labels).  The counter sees every torch op that a checkpoint recomputes
    (it is active through the backward), so only the kernels' recomputes
    are added here; under grad_accum the microbatches' shapes sum to the
    batch's, and so do their FLOPs."""
    is_cuda = batch[0].is_cuda
    if isinstance(config, WhisperConfig):
        features, labels = batch
        b, frames, label_len = features.shape[0], features.shape[-1], \
            labels.shape[1]
        total = whisper_custom_call_flops(config, b, label_len, frames,
                                          whole_loss_remat=whole_loss_remat,
                                          is_cuda=is_cuda)
        if is_cuda and fused_qkv_enabled():
            total += whisper_fused_projection_flops(config, b, label_len,
                                                    frames)
        return total
    audio = batch[0]
    return wav2vec2_custom_call_flops(
        config, audio.shape[0], config.downsampled_length(audio.shape[1]),
        whole_loss_remat=whole_loss_remat, is_cuda=is_cuda)


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **kwargs):
    """aten.convolution_backward: the input gradient and the weight
    gradient, each as many FLOPs as the forward (groups included)."""
    from torch.utils.flop_counter import conv_flop_count

    forward = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return forward * (int(output_mask[0]) + int(output_mask[1]))


class StepFlops(NamedTuple):
    state: Any
    loss: torch.Tensor
    counted: float      # what FlopCounterMode saw
    custom: float       # the kernels' products it cannot see

    @property
    def total(self) -> float:
        return self.counted + self.custom


def step_flops(step, state, batch, generator: torch.Generator) -> StepFlops:
    """Runs ``step(state, batch, generator)`` once under the flop counter
    (the step updates the model in place, so this is one of the caller's
    steps, not an extra one) and returns its result with its FLOPs."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter:
        state, loss = step(state, batch, generator)
    return StepFlops(state, loss, float(counter.get_total_flops()),
                     custom_call_flops(state.model.config, batch,
                                       getattr(step, "remat", False)))
