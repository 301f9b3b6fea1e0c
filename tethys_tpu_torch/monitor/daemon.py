"""Build and run the GPU monitor daemon (monitor/gpu_monitor.cpp).

    python -m tethys_tpu_torch.monitor.daemon          # builds, then runs it
    python -m tethys_tpu_torch.monitor.daemon --build  # prints its path

``build()`` compiles gpu_monitor.cpp with ``g++`` into
``tethys_tpu_torch/_build/monitor-<hash>/gpu_monitor`` (git-ignored; keyed
by a hash of the source and the flags) unless that binary exists.  The
daemon needs no CUDA toolkit: it loads ``libnvidia-ml.so.1`` when it
starts, and exits 1 with the reason on stderr when NVML is missing.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import sys
from pathlib import Path

SOURCE = Path(__file__).resolve().with_name("gpu_monitor.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-std=c++17", "-O2", "-Wall")


def build() -> Path:
    """The daemon's binary, compiled first if need be."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + SOURCE.read_bytes())
    binary = BUILD_DIR / f"monitor-{h.hexdigest()[:16]}" / "gpu_monitor"
    if binary.exists():
        return binary
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the GPU monitor is built from "
                           f"{SOURCE} at first use")
    binary.parent.mkdir(parents=True, exist_ok=True)
    tmp = binary.with_name(f".gpu_monitor.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE),
                           "-ldl"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("g++ failed:\n" + proc.stdout + proc.stderr)
    os.replace(tmp, binary)   # atomic: a reader never sees half a binary
    return binary


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    binary = build()
    if argv == ["--build"]:
        print(binary)
        return
    os.execv(str(binary), [str(binary)])


if __name__ == "__main__":
    main()
