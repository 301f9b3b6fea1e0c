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
dropout seeds come from a CPU generator made from (seed, step).

Wav2Vec2's parts: ``checkpoint_every_steps`` saves ``{tag}_step_{N}``
every N steps, and ``resilient=True`` swallows a step's exception, prints
``Error at step N: ...``, resets the data iterator and goes on (reference
wav2vec2_dist.py:1367-1371).  A failure that shows only when a step's loss
is fetched is attributed to that step, one behind the dispatch counter.
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


class _PendingFetchError(Exception):
    """Fetching step ``idx``'s loss (dispatched one iteration earlier)
    raised: carries the step's own index for the resilient handler."""

    def __init__(self, idx: int, cause: BaseException):
        super().__init__(f"step {idx}: {cause}")
        self.idx = idx
        self.cause = cause


def run_training(
    step_fn: Callable,               # (state, batch, generator) -> (state, loss)
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
        try:
            loss_value = float(loss.item())
        except Exception as e:  # noqa: BLE001 - a poisoned device result
            raise _PendingFetchError(idx, e) from e
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
            print(f"Error at step {e.idx}: {e.cause}", flush=True)

    for epoch in range(num_epochs):
        print(f"Epoch {epoch+1}/{num_epochs}", flush=True)
        it = 0
        while it < max_iterations:
            try:
                try:
                    batch = next(iterator)
                except StopIteration:
                    iterator = iter(dataset)
                    batch = next(iterator)
                step_start = time.time()
                if prepare_batch is not None:
                    batch = prepare_batch(batch)
                state, loss = step_fn(state, batch,
                                      step_generator(seed, step))
                # Register step i, then wait for step i-1: if that fetch
                # raises, step i stays in the pipeline.
                prev, pending = pending, (step, loss, step_start)
                step += 1
                it += 1
                flush(prev)              # step i-1's fetch overlaps step i
                if (checkpoint_manager is not None and checkpoint_every_steps
                        and step % checkpoint_every_steps == 0):
                    flush_pending()      # stdout order before the save
                    checkpoint_manager.save(f"{checkpoint_tag}_step_{step}",
                                            state)
            except _PendingFetchError as e:
                if not resilient:
                    raise e.cause
                print(f"Error at step {e.idx}: {e.cause}", flush=True)
                iterator = iter(dataset)
            except Exception as e:  # noqa: BLE001
                if not resilient:
                    raise
                failed = step
                try:
                    # The step before a dispatch-time error is still good:
                    # its line comes before the error line.
                    flush_pending()
                except _PendingFetchError as pe:
                    print(f"Error at step {pe.idx}: {pe.cause}", flush=True)
                print(f"Error at step {failed}: {e}", flush=True)
                iterator = iter(dataset)
                it += 1
        final_flush()
        if checkpoint_manager is not None:
            checkpoint_manager.save(f"{checkpoint_tag}_epoch_{epoch+1}",
                                    state)

    return TrainLoopResult(state, losses, step_times, step)
