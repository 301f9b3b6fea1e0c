"""The training loop with the reference's contracts (tethys_tpu/train/loop.py).

Per-step stdout line, scraped by the scheduler harness, so its format is a
compatibility contract (reference speech_jobs/whisper_dist.py:951,
wav2vec2_dist.py:1320):

    Step {i}, Loss: {loss:.4f}, Time: HH:MM:SS (경과: {elapsed:.2f}초, 스텝 시간: {dur:.2f}초)

after an ``Epoch {e+1}/{num_epochs}`` header, and a checkpoint at the end of
every epoch.  The loss fetch is pipelined one step deep: step i is
dispatched (the device runs it asynchronously), then step i-1's loss is
fetched with ``.item()`` and printed, so the host waits for the device
only once per step and the printed step times are the device's steady
state.  The pending step is flushed before every checkpoint.  Each step's
dropout seeds come from a CPU generator made from (seed, step) and the
replica (``dp.step_generator``): the rank's data coordinate, so the ranks
of one model or seq group draw the same seeds in the same order.  Every process prints its own
lines, as the JAX loop does; under a process group the loss they print is
the SUM over the replicas, the same on every rank.

Wav2Vec2's parts: ``checkpoint_every_steps`` saves ``{tag}_step_{N}``
every N steps, and ``resilient=True`` swallows a step's exception, prints
``Error at step N: ...``, resets the data iterator and goes on (reference
wav2vec2_dist.py:1367-1371).  A failure that shows only when a step's loss
is fetched is attributed to that step, one behind the dispatch counter.
``steady_state_step_time`` is the mean step time after the warm-up steps.

Hooks are called as ``hook(step, loss, duration, aux)`` once a step's line
is printed, as the JAX loop's are.  A step function that returns (state,
loss, aux) hands its aux, a nested dict of device tensors, to the hooks:
its one-element tensors are stacked with the loss when the step is
dispatched and fetched with it in one transfer, so they reach the hooks as
Python floats (their dicts' keys sorted, as a JAX step's output pytree
has them); larger tensors reach the hooks as they are.  Without aux the
hooks get None.  A step that fails calls no hook.

Spans (``utils/tracing``; nothing is recorded unless recording is on):
``tethys.loop.input`` (the next batch and ``prepare_batch``, timed on the
device too), ``tethys.loop.dispatch`` (the step function's call),
``tethys.loop.fetch`` (the host blocked on a step's loss),
``tethys.loop.hooks`` and ``tethys.loop.checkpoint``; the counter
``loop.steps_failed`` counts the steps whose error a resilient loop
swallowed.  The loop sets the step id: a step's input and dispatch carry
it, and so do its fetch and hooks, one iteration later.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, NamedTuple, Optional

import numpy as np
import torch

from tethys_tpu_torch.checkpoint import CheckpointManager
from tethys_tpu_torch.parallel import mesh
from tethys_tpu_torch.parallel.dp import aux_leaves, aux_tree, step_generator
from tethys_tpu_torch.utils import tracing


class TrainLoopResult(NamedTuple):
    state: Any
    losses: list
    step_times: list
    total_steps: int


def _pack(loss, aux):
    """(what flush fetches, whether it is a stack, the aux's structure):
    the loss alone, or the loss stacked with aux's one-element tensors
    (f32) at the dispatch."""
    if aux is None:
        return loss, False, None
    leaves = sorted(aux_leaves(aux), key=lambda leaf: leaf[0])
    scalars = [t for _, t in leaves if t.numel() == 1]
    if not scalars:
        return loss, False, leaves
    return torch.stack([loss.float().reshape(())]
                       + [t.detach().float().reshape(()) for t in scalars]
                       ), True, leaves


def _unpack(fetched: list, leaves) -> dict:
    values = iter(fetched[1:])
    return aux_tree((path, next(values) if t.numel() == 1 else t)
                    for path, t in leaves)


class _PendingFetchError(Exception):
    """Fetching step ``idx``'s loss (dispatched one iteration earlier)
    raised: carries the step's own index for the resilient handler."""

    def __init__(self, idx: int, cause: BaseException):
        super().__init__(f"step {idx}: {cause}")
        self.idx = idx
        self.cause = cause


def run_training(
    step_fn: Callable,               # (state, batch, generator) -> (state, loss[, aux])
    dataset: Iterable,               # yields numpy batch tuples
    state: Any,
    seed: int,
    num_epochs: int = 1,
    max_iterations: int = 1,
    prepare_batch: Optional[Callable] = None,  # numpy -> device tensors
    checkpoint_manager: Optional[CheckpointManager] = None,
    checkpoint_every_steps: Optional[int] = None,
    checkpoint_tag: str = "model",
    resilient: bool = False,         # Wav2Vec2's per-step exception reset
    step_hooks: tuple = (),          # callables(step, loss, duration, aux)
    replica: Optional[int] = None,   # the data coordinate; default the rank
) -> TrainLoopResult:
    losses, step_times = [], []
    replica = mesh.rank() if replica is None else replica
    step = 0
    iterator = iter(dataset)
    start_time = time.time()
    pending = None                   # (step, *_pack(...), dispatch start)
    last_ready = start_time

    def flush(entry):
        """Fetch and print one step's loss (waits for that step only)."""
        nonlocal last_ready
        if entry is None:
            return
        idx, fetch, stacked, leaves, p_start = entry
        tracing.set_step(idx)
        try:
            # The loss, or the loss and the aux's scalars: one transfer.
            with tracing.span("tethys.loop.fetch"):
                fetched = fetch.tolist() if stacked else [float(fetch.item())]
        except Exception as e:  # noqa: BLE001 - a poisoned device result
            raise _PendingFetchError(idx, e) from e
        loss_value = fetched[0]
        aux = None if leaves is None else _unpack(fetched, leaves)
        now = time.time()
        # Ready-to-ready in the pipelined steady state; anchored at the
        # dispatch start after a gap (checkpoint, epoch turn).
        step_duration = now - max(p_start, last_ready)
        last_ready = now
        elapsed = now - start_time
        print(
            f"Step {idx}, Loss: {loss_value:.4f}, "
            f"Time: {time.strftime('%H:%M:%S')} "
            f"(경과: {elapsed:.2f}초, 스텝 시간: {step_duration:.2f}초)",
            flush=True,
        )
        losses.append(loss_value)
        step_times.append(step_duration)
        if step_hooks:
            with tracing.span("tethys.loop.hooks"):
                for hook in step_hooks:
                    hook(idx, loss_value, step_duration, aux)

    def failed(idx, cause):
        """A step whose error the resilient loop swallows."""
        tracing.count("loop.steps_failed")
        print(f"Error at step {idx}: {cause}", flush=True)

    def flush_pending():
        nonlocal pending
        entry, pending = pending, None
        flush(entry)

    def final_flush():
        """An epoch's last fetch: a resilient loop logs its failure."""
        try:
            flush_pending()
        except _PendingFetchError as e:
            if not resilient:
                raise e.cause
            failed(e.idx, e.cause)

    def save(tag):
        with tracing.span("tethys.loop.checkpoint"):
            checkpoint_manager.save(tag, state)

    for epoch in range(num_epochs):
        print(f"Epoch {epoch+1}/{num_epochs}", flush=True)
        it = 0
        while it < max_iterations:
            try:
                tracing.set_step(step)
                with tracing.span("tethys.loop.input", device=True):
                    try:
                        batch = next(iterator)
                    except StopIteration:
                        iterator = iter(dataset)
                        batch = next(iterator)
                    step_start = time.time()
                    if prepare_batch is not None:
                        batch = prepare_batch(batch)
                with tracing.span("tethys.loop.dispatch"):
                    outputs = step_fn(state, batch,
                                      step_generator(seed, step, replica))
                state, loss = outputs[:2]
                packed = _pack(loss, outputs[2] if len(outputs) == 3 else None)
                # Register step i, then wait for step i-1: if that fetch
                # raises, step i stays in the pipeline.
                prev, pending = pending, (step, *packed, step_start)
                step += 1
                it += 1
                flush(prev)              # step i-1's fetch overlaps step i
                if (checkpoint_manager is not None and checkpoint_every_steps
                        and step % checkpoint_every_steps == 0):
                    flush_pending()      # stdout order before the save
                    save(f"{checkpoint_tag}_step_{step}")
            except _PendingFetchError as e:
                if not resilient:
                    raise e.cause
                failed(e.idx, e.cause)
                iterator = iter(dataset)
            except Exception as e:  # noqa: BLE001
                if not resilient:
                    raise
                failed_step = step
                try:
                    # The step before a dispatch-time error is still good:
                    # its line comes before the error line.
                    flush_pending()
                except _PendingFetchError as pe:
                    failed(pe.idx, pe.cause)
                failed(failed_step, e)
                iterator = iter(dataset)
                it += 1
        final_flush()
        if checkpoint_manager is not None:
            save(f"{checkpoint_tag}_epoch_{epoch+1}")

    return TrainLoopResult(state, losses, step_times, step)


def steady_state_step_time(step_times, warmup: int = 3) -> float:
    """Mean step time after dropping the warm-up steps (all of them when
    there are no more than ``warmup``)."""
    if not step_times:
        return 0.0
    tail = step_times[warmup:] or step_times
    return float(np.mean(tail))
