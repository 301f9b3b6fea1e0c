"""Result-directory / JCT / model.txt contracts (tethys_tpu/utils/artifacts.py)
and JCTTimer, which measures the JCT.

The scheduler's TFJob shell writes the run name into
``<workspace>/model.txt`` and creates ``<result>/<name>/``; a job writes
``<task_type>_<task_index>_jct.txt`` (JCT as '%.2f') there (reference
speech_jobs/whisper_dist.py:1008-1021), or ``single_jct.txt`` from the
single-device job (whisper_single.py).
Paths are env-overridable: TETHYS_WORKSPACE (default /workspace) and
TETHYS_RESULT (default /result).
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import Optional


def workspace_dir() -> str:
    return os.environ.get("TETHYS_WORKSPACE", "/workspace")


def result_dir() -> str:
    return os.environ.get("TETHYS_RESULT", "/result")


def read_model_name() -> Optional[str]:
    path = os.path.join(workspace_dir(), "model.txt")
    try:
        with open(path, "r") as f:
            return f.read().strip()
    except OSError:
        return None


def write_jct(jct_seconds: float, task_type: Optional[str],
              task_index: Optional[int], single: bool = False
              ) -> Optional[str]:
    """Write the JCT file, ``single_jct.txt`` for the single-device jobs;
    returns its path or None (errors are printed and swallowed, as the
    reference's try/except, so a missing result volume never kills a
    job)."""
    try:
        name = read_model_name()
        if name is None:
            return None
        filename = ("single_jct.txt" if single
                    else f"{task_type}_{task_index}_jct.txt")
        path = os.path.join(result_dir(), name, filename)
        with open(path, "w") as f:
            f.write("%.2f" % float(jct_seconds))
        return path
    except Exception as e:  # noqa: BLE001 - contract: never fail the job
        print(f"JCT write failed: {e}")
        return None


def start_side_captures() -> None:
    """Launch the workspace's network/chip monitor scripts, as the
    reference's ``os.system('sh /workspace/network.sh &')``
    (speech_jobs/whisper_dist.py:994-995)."""
    ws = workspace_dir()
    for script in ("network.sh", "tpu.sh", "gpu.sh"):
        path = os.path.join(ws, script)
        if os.path.exists(path):
            subprocess.Popen(["sh", path])
    print(
        """
========================
network profile started!
========================"""
    )


class JCTTimer:
    """Context manager measuring job-completion time: ``.jct`` is the wall
    seconds of the block; exceptions pass through."""

    def __enter__(self):
        self.start = time.time()
        return self

    def __exit__(self, *exc):
        self.jct = time.time() - self.start
        return False
