"""The Whisper train step and its optimizer (tethys_tpu/parallel/dp.py).

* ``KerasAdam``: tf.keras Adam's exact rule, written by hand.  Keras folds
  the bias corrections into the step size and adds eps to the UNCORRECTED
  sqrt(v):

      m += (g - m) (1 - b1);  v += (g^2 - v) (1 - b2)
      alpha_t = lr sqrt(1 - b2^t) / (1 - b1^t)
      p -= alpha_t m / (sqrt(v) + eps)

  ``torch.optim.Adam`` adds eps to the corrected sqrt(v_hat), which drifts
  from Keras over a trajectory, so it is not the port.  Moments live in the
  parameter dtype; the update runs as a few multi-tensor (``_foreach``)
  passes over all parameters.
* ``make_train_step(loss_fn, optimizer)``: one replica's step -- forward,
  backward, optimizer -- returning the loss as a detached device tensor
  (no host sync).  The JAX step logs the SUM of the replicas' losses, which
  at one replica is the loss itself.  A multi-process world is refused:
  the data-parallel runtime waits (ROADMAP.md, queue 1 item 5), as does
  the hardened Wav2Vec2 chain.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

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


class KerasAdam(torch.optim.Optimizer):
    """tf.keras.optimizers.Adam's update rule (module doc)."""

    def __init__(self, params, lr: float = 1e-3, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))

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
    the device."""
    if hardened:
        raise NotImplementedError(
            "the hardened step (NaN scrub, 1/N scaling, global-norm clip) is "
            "Wav2Vec2's and is not ported yet (ROADMAP.md, queue 1 item 3)")
    if _world_size() > 1:
        raise NotImplementedError(
            "multi-process data parallelism is not ported yet (ROADMAP.md, "
            "queue 1 item 5); run one process on one GPU")

    def step(state: TrainState, batch, generator: torch.Generator):
        optimizer.zero_grad(set_to_none=True)
        loss, _ = loss_fn(state.model, batch, generator)
        loss.backward()
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
