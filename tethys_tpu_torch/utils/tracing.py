"""Spans and counters of the port's layers, and the profiler trace of a job
(tethys_tpu/utils/tracing.py).

``span(name, device=False)`` brackets a stretch of a layer's work and
``count(name, n)`` adds to a counter (``spanned(name)``: a function's
every call inside ``span(name)``).  Both cost one test of a module
global while recording is off, the default: ``span`` then returns one
shared context that does nothing, and neither allocates nor calls torch.
``recording()`` turns recording on for its block and yields the
``Recorder`` that keeps everything in memory.  Recording is turned on by
``maybe_profiler_trace`` (``--jax_profile``), ``profiling/step_profile.py``
and whoever measures the program; nothing else does.

While recording, each span keeps its name, its parent (the innermost span
open when it began), the step id the training loop last set
(``set_step``) and its start and end on ``time.perf_counter_ns``.  Spans
nest on the thread that opens them: the training loop's.  Under a running
``torch.profiler`` a span also enters ``record_function(name)``, so it lies
on the profiler's timeline beside the kernels its work launched.  A span
with ``device=True`` also records a pair of timing CUDA events on the
current stream, once CUDA is initialised: nothing waits on them while the
work runs; they are resolved when recording ends, with one synchronize (or
earlier, without waiting, once many are pending), into device ms from an
event recorded with the first of them.  This times the device at the
layers' boundaries without a profiler.

The recorder's ``summary()``: for each span name its count, host ms, self
ms (the host ms less what its child spans cover) and device ms; the
counters; and the kernel launches made while recording
(``kernel_lib.launch_counts()``'s change).  ``write(path)`` puts the
summary and every span into a JSON file.

``maybe_profiler_trace(DIR)`` (``--jax_profile DIR``, the JAX job's flag
name, kept for its CLI) wraps training in ``torch.profiler`` with every
activity the build supports (the host's and, where there is a card,
CUDA's) and with recording on, and writes the Chrome trace
``trace_<pid>.json`` (the program's spans beside the device's kernels) and
the recorder's ``spans_<pid>.json`` into DIR.  A profiler that cannot
start or write prints why and the job goes on: the trace is
observability, not the device path, whose kernels still launch or raise.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import os
import time
from typing import Dict, List, Optional

# The recorder while recording is on, else None.
_recorder: Optional["Recorder"] = None

# Resolve the finished events early once this many spans wait on theirs,
# so that a long recording holds a bounded number of events.
PENDING_EVENTS = 1024


class _NoSpan:
    """The span of recording off: a context that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


def span(name: str, device: bool = False):
    """A context bracketing one stretch of work named ``name`` (module
    doc); ``device``: also time it on the device."""
    rec = _recorder
    if rec is None:
        return NO_SPAN
    return _Span(rec, name, device)


def spanned(name: str):
    """A decorator: every call of the function inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording."""
    rec = _recorder
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n


def set_step(step: int) -> None:
    """The step id of the spans that begin from now on."""
    rec = _recorder
    if rec is None:
        return
    rec.step = step


class SpanRecord:
    """One recorded span.  ``parent``: the index of the enclosing span in
    the recorder's ``records`` (None at the top); device ms from the
    recorder's first event (None without events, or before they are
    resolved)."""

    __slots__ = ("name", "parent", "step", "start_ns", "end_ns",
                 "device_start_ms", "device_end_ms", "events")

    def __init__(self, name, parent, step, start_ns):
        self.name, self.parent, self.step = name, parent, step
        self.start_ns, self.end_ns = start_ns, start_ns
        self.device_start_ms = self.device_end_ms = None
        self.events = None

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_end_ms is None:
            return None
        return self.device_end_ms - self.device_start_ms

    def as_dict(self) -> dict:
        return {"name": self.name, "parent": self.parent, "step": self.step,
                "start_ns": self.start_ns, "end_ns": self.end_ns,
                "device_start_ms": self.device_start_ms,
                "device_end_ms": self.device_end_ms}


class Recorder:
    """What one ``recording()`` keeps: the spans in the order they began,
    the counters, and at its end the kernel launches it saw."""

    def __init__(self):
        import torch

        from tethys_tpu_torch.utils import kernel_lib

        self._torch = torch
        self._profiling = torch._C._autograd._profiler_enabled
        self._kernel_lib = kernel_lib
        self._launches_before = kernel_lib.launch_counts()
        self.records: List[SpanRecord] = []
        self.counters: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.step: Optional[int] = None
        self._open: List[int] = []
        self._origin = None              # the first timing event
        self._free: list = []            # resolved events, for reuse
        self._pending = collections.deque()   # records with events

    # Device events ---------------------------------------------------

    def _event(self):
        """A recorded timing event on the current stream, or None before
        CUDA is initialised."""
        cuda = self._torch.cuda
        if not cuda.is_initialized():
            return None
        if self._origin is None:
            self._origin = cuda.Event(enable_timing=True)
            self._origin.record()
        ev = self._free.pop() if self._free else cuda.Event(
            enable_timing=True)
        ev.record()
        return ev

    def _resolve(self, record: SpanRecord) -> None:
        start, end = record.events
        record.device_start_ms = self._origin.elapsed_time(start)
        record.device_end_ms = self._origin.elapsed_time(end)
        record.events = None
        self._free += (start, end)

    def _resolve_finished(self) -> None:
        """Resolves, without waiting, the spans whose work has finished."""
        pending = self._pending
        while pending and pending[0].events[1].query():
            self._resolve(pending.popleft())

    def close(self) -> None:
        """Resolves every event (one synchronize) and takes the launch
        counts' change."""
        if self._pending:
            self._torch.cuda.synchronize()
            while self._pending:
                self._resolve(self._pending.popleft())
        after = self._kernel_lib.launch_counts()
        self.launches = {k: n - self._launches_before.get(k, 0)
                         for k, n in after.items()
                         if n != self._launches_before.get(k, 0)}

    # Reading ---------------------------------------------------------

    def summary(self) -> dict:
        """{"spans": {name: {"count", "host_ms", "self_ms", "device_ms"}},
        "counters", "launches"}; ``device_ms`` is None for a span that
        recorded no events."""
        cover = [0] * len(self.records)
        for rec in self.records:
            if rec.parent is not None:
                cover[rec.parent] += rec.end_ns - rec.start_ns
        spans: Dict[str, dict] = {}
        for rec, covered in zip(self.records, cover):
            item = spans.setdefault(rec.name, {
                "count": 0, "host_ms": 0.0, "self_ms": 0.0,
                "device_ms": None})
            item["count"] += 1
            item["host_ms"] += rec.host_ms
            item["self_ms"] += (rec.end_ns - rec.start_ns - covered) * 1e-6
            if rec.device_ms is not None:
                item["device_ms"] = (item["device_ms"] or 0.0) + rec.device_ms
        return {"spans": spans, "counters": dict(self.counters),
                "launches": dict(self.launches)}

    def turns(self, end: str, start: str) -> List[float]:
        """Device ms from the end of step s's last ``end`` span to the
        start of step s + 1's first ``start`` span, for each step s that
        has both (the device's turn from one step to the next)."""
        last_end, first_start = {}, {}
        for rec in self.records:
            if rec.device_end_ms is None or rec.step is None:
                continue
            if rec.name == end:
                last_end[rec.step] = rec.device_end_ms
            if rec.name == start and rec.step not in first_start:
                first_start[rec.step] = rec.device_start_ms
        return [first_start[s + 1] - t for s, t in sorted(last_end.items())
                if s + 1 in first_start]

    def write(self, path: str) -> None:
        """The summary and every span, as JSON."""
        with open(path, "w") as fh:
            json.dump({"summary": self.summary(),
                       "spans": [r.as_dict() for r in self.records]}, fh)


class _Span:
    __slots__ = ("rec", "name", "device", "index", "function")

    def __init__(self, rec: Recorder, name: str, device: bool):
        self.rec, self.name, self.device = rec, name, device
        self.function = None

    def __enter__(self):
        rec = self.rec
        record = SpanRecord(self.name, rec._open[-1] if rec._open else None,
                            rec.step, time.perf_counter_ns())
        self.index = len(rec.records)
        rec.records.append(record)
        rec._open.append(self.index)
        if rec._profiling():
            self.function = rec._torch.profiler.record_function(self.name)
            self.function.__enter__()
        if self.device:
            start = rec._event()
            if start is not None:
                record.events = (start, None)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        record = rec.records[self.index]
        if record.events is not None:
            record.events = (record.events[0], rec._event())
            rec._pending.append(record)
            if len(rec._pending) > PENDING_EVENTS:
                rec._resolve_finished()
        if self.function is not None:
            self.function.__exit__(*exc)
        rec._open.pop()
        record.end_ns = time.perf_counter_ns()
        return False


@contextlib.contextmanager
def recording():
    """Recording on for the block; yields its ``Recorder``, whose events
    are resolved and launches taken once the block ends."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("recording is on already")
    rec = Recorder()
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None
        rec.close()


@contextlib.contextmanager
def maybe_profiler_trace(log_dir):
    if not log_dir:
        yield
        return
    try:
        import torch.profiler

        prof = torch.profiler.profile(
            activities=list(torch.profiler.supported_activities()))
        prof.start()
    except Exception as e:  # noqa: BLE001
        print(f"torch.profiler unavailable: {e}")
        yield
        return
    rec = None
    try:
        with recording() as rec:
            yield
    finally:
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            print(f"torch.profiler trace written to {path}")
            if rec is not None:
                spans = os.path.join(log_dir, f"spans_{os.getpid()}.json")
                rec.write(spans)
                print(f"spans written to {spans}")
        except Exception as e:  # noqa: BLE001
            print(f"torch.profiler trace failed: {e}")
