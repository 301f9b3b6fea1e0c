"""Optional profiler trace of a job (tethys_tpu/utils/tracing.py).

``--jax_profile DIR`` (the JAX job's flag name, kept for its CLI) wraps
training in ``torch.profiler`` with every activity the build supports (the
host's and, where there is a card, CUDA's) and writes a Chrome trace
``trace_<pid>.json`` into DIR.  A profiler that cannot start or write
prints why and the job goes on: the trace is observability, not the
device path, whose kernels still launch or raise.
"""

from __future__ import annotations

import contextlib
import os


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
    try:
        yield
    finally:
        try:
            prof.stop()
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"trace_{os.getpid()}.json")
            prof.export_chrome_trace(path)
            print(f"torch.profiler trace written to {path}")
        except Exception as e:  # noqa: BLE001
            print(f"torch.profiler trace failed: {e}")
