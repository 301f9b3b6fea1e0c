"""Build, load and launch the port's CUDA kernels.

The sources in ``tethys_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, bound with
``ctypes``.  The build happens at the first launch (never at import), into
``tethys_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and the
flags, so a checkout builds from its own sources and a changed source
rebuilds.  A failed build, a missing ``nvcc`` or a refused launch raises.

Each kernel is a :class:`Kernel`: its C symbol, the file it lives in, the
TPU kernel it replaces and a plain integer count of its launches, which
goes up by one each time the kernel is launched and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
LIB_NAME = "libtethys_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int

_lock = threading.Lock()
_lib = None
# Seconds the last build in this process took (None: loaded from the
# cache or not built yet), and the compiler's report (-Xptxas=-v).
build_seconds = None
build_log = ""


class Kernel:
    """One exported C function of the library and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes, source: str,
                 replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = tuple(argtypes)
        self.source = source        # path in the repo
        self.replaces = replaces    # file:line of the TPU kernel
        self.launches = 0

    def __call__(self, *args) -> None:
        fn = getattr(library(), self.symbol)
        err = fn(*args)
        if err != 0:
            msg = library().tethys_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1


LOG_MEL = Kernel(
    "log_mel", "tethys_log_mel", (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/logmel.cu",
    "tethys_tpu/audio/pallas_logmel.py:70")
SPLIT_HEADS = Kernel(
    "split_heads", "tethys_split_heads", (_P, _P, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/split_heads.cu",
    "tethys_tpu/ops/pallas_transpose.py:79")
FLASH_FWD = Kernel(
    "flash_fwd", "tethys_flash_fwd",
    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/flash_fwd.cu",
    "tethys_tpu/ops/pallas_attention.py:135")
DECODE_SELF = Kernel(
    "decode_self", "tethys_decode_self",
    (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/decode_self.cu",
    "tethys_tpu/ops/pallas_decode.py:77")

KERNELS = (LOG_MEL, SPLIT_HEADS, FLASH_FWD, DECODE_SELF)


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the "
        "port's CUDA kernels are built from tethys_tpu_torch/csrc at first "
        "use")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless this source hash was built already."""
    global build_seconds, build_log
    out_dir = BUILD_DIR / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
    sources = [str(path) for path in sorted(CSRC_DIR.glob("*.cu"))]
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    build_log = proc.stdout + proc.stderr
    (out_dir / "build.log").write_text(build_log)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc exited with {proc.returncode}:\n{build_log[-6000:]}")
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a library
    build_seconds = time.perf_counter() - t0
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for k in KERNELS:
                fn = getattr(lib, k.symbol)
                fn.argtypes = k.argtypes
                fn.restype = ctypes.c_int
            lib.tethys_error_string.argtypes = (ctypes.c_int,)
            lib.tethys_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def stream_handle(tensor) -> int:
    """The raw cudaStream_t of torch's current stream on tensor's device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
