"""Train steps and their optimizers (tethys_tpu/parallel/dp.py).

* ``KerasAdam``: tf.keras Adam's exact rule, written by hand.  Keras folds
  the bias corrections into the step size and adds eps to the UNCORRECTED
  sqrt(v):

      m += (g - m) (1 - b1);  v += (g^2 - v) (1 - b2)
      alpha_t = lr sqrt(1 - b2^t) / (1 - b1^t)
      p -= alpha_t m / (sqrt(v) + eps)

  ``torch.optim.Adam`` adds eps to the corrected sqrt(v_hat), which drifts
  from Keras over a trajectory, so it is not the port.  Moments live in the
  parameter dtype; the update runs as a few multi-tensor (``_foreach``)
  passes over all parameters.  With ``clipnorm`` each gradient is first
  clipped by its own L2 norm (Keras ``Adam(clipnorm=)``,
  ``per_variable_clipnorm``).
* ``whisper_optimizer``: Keras defaults, eps 1e-7.  ``wav2vec2_optimizer``:
  ``per_variable_clipnorm(1.0)`` then Keras Adam with eps 1e-8 (reference
  wav2vec2_dist.py:1271-1275).
* ``make_train_step(loss_fn, optimizer, hardened=False)``: one replica's
  step -- forward, backward, optimizer -- returning the loss as a detached
  device tensor (no host sync).  The JAX step logs the SUM of the
  replicas' losses, which at one replica is the loss itself.  The hardened
  step (Wav2Vec2, reference wav2vec2_dist.py:1186-1260) scrubs a NaN loss
  to 0, divides it by the number of replicas N, and clips the replica's
  gradients to a global norm of 1.0 before the optimizer, whose
  per-variable clip then clips them again: the reference's double clip
  (quirk #8), kept.  A parameter that took no gradient (the frozen
  codevectors) is left out of both clips and of the update, as the JAX
  step's zero gradient leaves it.  A multi-process world is refused: the
  data-parallel runtime waits (ROADMAP.md, queue 1 item 5).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch


class TrainState(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def _keras_alpha(lr: float, b1: float, b2: float, count: int) -> np.float32:
    """lr sqrt(1 - b2^t) / (1 - b1^t) in f32, as Keras (and the JAX port)
    compute it in the variable dtype; on the host, so no device sync."""
    one, c = np.float32(1.0), np.float32(count)
    return (np.float32(lr) * np.sqrt(one - np.float32(b2) ** c)
            / (one - np.float32(b1) ** c))


def per_variable_clipnorm(grads: List[torch.Tensor],
                          max_norm: float) -> None:
    """Keras ``clipnorm``: each gradient scaled in place by min(1,
    max_norm / max(|g|, 1e-12)), its own L2 norm (not the global one)."""
    if not grads:
        return
    norms = torch.stack(torch._foreach_norm(grads)).float()
    scales = (max_norm / norms.clamp_min(1e-12)).clamp_max(1.0)
    torch._foreach_mul_(grads, list(scales.to(grads[0].dtype).unbind()))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """optax ``clip_by_global_norm``: every gradient scaled in place by
    max_norm / |g| when the global norm |g| is at least max_norm."""
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)).float())
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale.to(grads[0].dtype))


class KerasAdam(torch.optim.Optimizer):
    """tf.keras.optimizers.Adam's update rule (module doc)."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7,
                 clipnorm: Optional[float] = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      clipnorm=clipnorm))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("KerasAdam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["m"] = torch.zeros_like(p)
                    state["v"] = torch.zeros_like(p)
                state["step"] += 1
            count = self.state[params[0]]["step"]
            grads = [p.grad for p in params]
            if group["clipnorm"] is not None:
                per_variable_clipnorm(grads, group["clipnorm"])
            ms = [self.state[p]["m"] for p in params]
            vs = [self.state[p]["v"] for p in params]
            b1, b2 = group["b1"], group["b2"]
            # m + (g - m) * (1 - b1), v + (g^2 - v) * (1 - b2)
            dm = torch._foreach_sub(grads, ms)
            torch._foreach_mul_(dm, 1.0 - b1)
            torch._foreach_add_(ms, dm)
            dv = torch._foreach_mul(grads, grads)
            torch._foreach_sub_(dv, vs)
            torch._foreach_mul_(dv, 1.0 - b2)
            torch._foreach_add_(vs, dv)
            alpha = float(_keras_alpha(group["lr"], b1, b2, count))
            denom = torch._foreach_sqrt(vs)
            torch._foreach_add_(denom, group["eps"])
            update = torch._foreach_mul(ms, -alpha)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(params, update)
        return None


def whisper_optimizer(params, learning_rate: float = 1e-4) -> KerasAdam:
    """Adam with Keras defaults (eps 1e-7) and Keras's eps placement
    (reference whisper_dist.py:894-901)."""
    return KerasAdam(params, lr=learning_rate, b1=0.9, b2=0.999, eps=1e-7)


def wav2vec2_optimizer(params, learning_rate: float = 3e-5) -> KerasAdam:
    """Per-variable clipnorm(1.0), then Keras Adam with eps 1e-8 (reference
    wav2vec2_dist.py:1271-1275)."""
    return KerasAdam(params, lr=learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                     clipnorm=1.0)


LossFn = Callable[[torch.nn.Module, Any, torch.Generator], Any]


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_train_step(loss_fn: LossFn, optimizer: torch.optim.Optimizer,
                    hardened: bool = False):
    """step(state, batch, generator) -> (state, loss) on one replica.

    loss_fn(model, batch, generator) -> (scalar loss, aux).  The model and
    the optimizer are updated in place; ``loss`` is detached and stays on
    the device.  ``hardened``: the NaN scrub, 1/N and the global-norm clip
    (module doc); none of them waits on the device."""
    n_replicas = _world_size()
    if n_replicas > 1:
        raise NotImplementedError(
            "multi-process data parallelism is not ported yet (ROADMAP.md, "
            "queue 1 item 5); run one process on one GPU")

    def step(state: TrainState, batch, generator: torch.Generator):
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(state.model, batch, generator)
        if hardened:
            loss = torch.where(torch.isnan(loss), torch.zeros_like(loss),
                               loss) / n_replicas
        loss.backward()
        if hardened:
            clip_by_global_norm([p.grad for p in state.model.parameters()
                                 if p.grad is not None], 1.0)
        optimizer.step()
        return state, loss.detach()

    return step


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's dropout seeds, a function of (run
    seed, step) as JAX's fold_in(rng, step) is: a splitmix64 mix of both."""
    z = ((seed & 0xFFFFFFFF) << 32 | (step & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return torch.Generator().manual_seed(z ^ (z >> 31))
