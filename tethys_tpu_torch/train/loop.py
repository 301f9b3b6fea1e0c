"""The training loop with the reference's contracts (tethys_tpu/train/loop.py).

Per-step stdout line, scraped by the scheduler harness, so its format is a
compatibility contract (reference speech_jobs/whisper_dist.py:951):

    Step {i}, Loss: {loss:.4f}, Time: HH:MM:SS (경과: {elapsed:.2f}초, 스텝 시간: {dur:.2f}초)

after an ``Epoch {e+1}/{num_epochs}`` header, and a checkpoint at the end of
every epoch.  The loss fetch is pipelined one step deep: step i is
dispatched (the device runs it asynchronously), then step i-1's loss is
fetched with ``.item()`` and printed, so the host waits for the device
only once per step and the printed step times are the device's steady
state.  The pending step is flushed before each epoch's checkpoint.  Each
step's dropout seeds come from a CPU generator made from (seed, step).

The wav2vec2 parts (resilient per-step exception handling, the 50-step
checkpoint cadence) are not ported yet (ROADMAP.md, queue 1 item 3).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Iterable, NamedTuple, Optional

from tethys_tpu_torch.checkpoint import CheckpointManager
from tethys_tpu_torch.parallel.dp import step_generator


class TrainLoopResult(NamedTuple):
    state: Any
    losses: list
    step_times: list
    total_steps: int


def run_training(
    step_fn: Callable,               # (state, batch, generator) -> (state, loss)
    dataset: Iterable,               # yields numpy batch tuples
    state: Any,
    seed: int,
    num_epochs: int = 1,
    max_iterations: int = 1,
    prepare_batch: Optional[Callable] = None,  # numpy -> device tensors
    checkpoint_manager: Optional[CheckpointManager] = None,
    checkpoint_tag: str = "model",
    step_hooks: tuple = (),          # callables(step, loss, duration)
) -> TrainLoopResult:
    losses, step_times = [], []
    step = 0
    iterator = iter(dataset)
    start_time = time.time()
    pending = None                   # (step, loss tensor, dispatch start)
    last_ready = start_time

    def flush(entry):
        """Fetch and print one step's loss (waits for that step only)."""
        nonlocal last_ready
        if entry is None:
            return
        idx, loss, p_start = entry
        loss_value = float(loss.item())
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
        for hook in step_hooks:
            hook(idx, loss_value, step_duration)

    for epoch in range(num_epochs):
        print(f"Epoch {epoch+1}/{num_epochs}", flush=True)
        for _ in range(max_iterations):
            try:
                batch = next(iterator)
            except StopIteration:
                iterator = iter(dataset)
                batch = next(iterator)
            step_start = time.time()
            if prepare_batch is not None:
                batch = prepare_batch(batch)
            state, loss = step_fn(state, batch, step_generator(seed, step))
            prev, pending = pending, (step, loss, step_start)
            step += 1
            flush(prev)              # step i-1's fetch overlaps step i
        flush(pending)
        pending = None
        if checkpoint_manager is not None:
            checkpoint_manager.save(f"{checkpoint_tag}_epoch_{epoch+1}", state)

    return TrainLoopResult(state, losses, step_times, step)
