"""Build, load and launch the port's CUDA kernels.

The sources in ``tethys_tpu_torch/csrc/*.cu`` are compiled by ``nvcc`` for
``sm_90a``, one process per source and all at once, then linked into one
shared library with a plain C interface, bound with ``ctypes``.  The build
happens at the first launch (never at import), into
``tethys_tpu_torch/_build/<hash>/``, keyed by a hash of the sources and the
flags, so a checkout builds from its own sources and a changed source
rebuilds.  A failed build, a missing ``nvcc`` or a refused launch raises.

Each kernel is a :class:`Kernel`: its C symbol, the file it lives in, the
TPU kernel it replaces and a plain integer count of its launches, which
goes up by one each time the kernel is launched and nowhere else.  A kernel
whose source holds several routes (the flash kernels: ``FLASH_ROUTES``)
also counts its launches per route; ``launch_counts`` reports them as
``"<name>.<route>"`` beside the totals.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from tethys_tpu_torch.utils import tracing

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
LIB_NAME = "libtethys_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint32
_F = ctypes.c_float

_lock = threading.Lock()
_lib = None
# The compiler's report (-Xptxas=-v) of the last build in this process.
build_log = ""


# The flash kernels' routes, in the order of their C Route codes
# (csrc/flash_fwd.cu, csrc/flash_bwd.cu): FFMA for f32, mma.sync and
# TMA + wgmma for bf16 (ops/flash_attention.flash_route).
FLASH_ROUTES = ("ffma", "mma", "wgmma")


class Kernel:
    """One exported C function of the library and its launch count (and,
    for a kernel with ``routes``, its launches per route)."""

    def __init__(self, name: str, symbol: str, argtypes, source: str,
                 replaces: str, routes=()):
        self.name = name
        self.symbol = symbol
        self.argtypes = tuple(argtypes)
        self.source = source        # path in the repo
        self.replaces = replaces    # file:line of the TPU kernel
        self.launches = 0
        self.routes = dict.fromkeys(routes, 0)

    def __call__(self, *args, route=None) -> None:
        """Launches the kernel; ``route`` names the route it took, for a
        kernel that has routes."""
        if (route is None) != (not self.routes):
            raise ValueError(f"{self.name}: route {route!r}, routes "
                             f"{tuple(self.routes)}")
        fn = getattr(library(), self.symbol)
        err = fn(*args)
        if err != 0:
            msg = library().tethys_error_string(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err} ({msg})")
        self.launches += 1
        if route is not None:
            self.routes[route] += 1


LOG_MEL = Kernel(
    "log_mel", "tethys_log_mel",
    (_P, _P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/logmel.cu",
    "tethys_tpu/audio/pallas_logmel.py:70")
SPLIT_HEADS = Kernel(
    "split_heads", "tethys_split_heads", (_P, _P, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/split_heads.cu",
    "tethys_tpu/ops/pallas_transpose.py:79")
MERGE_HEADS = Kernel(
    "merge_heads", "tethys_merge_heads", (_P, _P, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/merge_heads.cu",
    "tethys_tpu/ops/pallas_transpose.py:85")
FLASH_FWD = Kernel(
    "flash_fwd", "tethys_flash_fwd",
    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/flash_fwd.cu",
    "tethys_tpu/ops/pallas_attention.py:135", FLASH_ROUTES)
# The same TPU kernel at a nonzero rate (its dropout branch, lines 155-164
# and 192-196): the template with the mask compiled in.
FLASH_FWD_DROPOUT = Kernel(
    "flash_fwd_dropout", "tethys_flash_fwd_dropout",
    (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _U, _U, _F, _I, _P),
    "tethys_tpu_torch/csrc/flash_fwd.cu",
    "tethys_tpu/ops/pallas_attention.py:135", FLASH_ROUTES)
FLASH_BWD = Kernel(
    "flash_bwd", "tethys_flash_bwd",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     _U, _U, _F, _F, _I, _P),
    "tethys_tpu_torch/csrc/flash_bwd.cu",
    # One kernel for every Tk: the TPU's fused kernel (Tk <= 2048) and the
    # pair it takes above that.
    "tethys_tpu/ops/pallas_attention.py:380 _bwd_dkv_dq_kernel, "
    ":259 _bwd_dq_kernel, :308 _bwd_dkv_kernel", FLASH_ROUTES)
DROPOUT = Kernel(
    "dropout", "tethys_dropout",
    (_P, _P, _L, _L, _L, _L, _L, _L, _I, _I, _U, _U, _F, _I, _P),
    "tethys_tpu_torch/csrc/dropout.cu",
    "tethys_tpu/ops/pallas_dropout.py:29")
# The same kernel on a shard (a window other than the whole tensor),
# counted apart so a run shows that its sharded paths took their windows.
DROPOUT_WINDOW = Kernel(
    "dropout_window", "tethys_dropout", DROPOUT.argtypes, DROPOUT.source,
    DROPOUT.replaces)
DECODE_SELF = Kernel(
    "decode_self", "tethys_decode_self",
    (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/decode_self.cu",
    "tethys_tpu/ops/pallas_decode.py:77")

GN_STATS = Kernel(
    "gn_stats", "tethys_gn_stats",
    (_P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    "tethys_tpu_torch/csrc/gn_stats.cu",
    "tethys_tpu/ops/pallas_gn.py:50")
# The same engine's backward mode, and the apply passes around it: XLA on
# the TPU (no Pallas kernel), so "replaces" names the JAX function.
GN_GRAD_SUMS = Kernel(
    "gn_grad_sums", "tethys_gn_grad_sums",
    (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/gn_stats.cu",
    "tethys_tpu/ops/norms.py:108 _gn_core (bwd_rule's joint stats pass)")
GN_APPLY = Kernel(
    "gn_apply", "tethys_gn_apply",
    (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/gn_apply.cu",
    "tethys_tpu/ops/norms.py:68 _gn_core (forward apply)")
GN_APPLY_BWD = Kernel(
    "gn_apply_bwd", "tethys_gn_apply_bwd",
    (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/gn_apply.cu",
    "tethys_tpu/ops/norms.py:116 _gn_core (bwd_rule's dx)")

Q8_CROSS = Kernel(
    "q8_cross", "tethys_q8_cross",
    (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/q8_cross.cu",
    "tethys_tpu/ops/pallas_decode.py:195")
PROJ_SPLIT = Kernel(
    "proj_split", "tethys_proj_split",
    (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _F, _F, _I, _I, _I, _I, _I,
     _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/qkv_proj.cu",
    "tethys_tpu/ops/pallas_qkv.py:117")
MERGE_PROJ = Kernel(
    "merge_proj", "tethys_merge_proj",
    (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "tethys_tpu_torch/csrc/qkv_proj.cu",
    "tethys_tpu/ops/pallas_qkv.py:236")

# Functions of the library that launch nothing: the cluster size the two
# decode-step attention kernels take for given sizes, and the GroupNorm
# and dropout kernels' occupancy (ops/group_norm.py, ops/dropout.py).
_QUERIES = {
    "tethys_q8_cross_cluster": (_I, _I, _I),
    "tethys_decode_self_cluster": (_I, _I, _I, _I),
    "tethys_gn_stats_occupancy": (_I, _I, _I, _I, _P),
    "tethys_gn_apply_occupancy": (_I, _I, _I, _P),
    "tethys_dropout_occupancy": (_I, _P),
}

KERNELS = (LOG_MEL, SPLIT_HEADS, MERGE_HEADS, FLASH_FWD, FLASH_FWD_DROPOUT,
           FLASH_BWD, DROPOUT, DROPOUT_WINDOW, DECODE_SELF, GN_STATS,
           GN_GRAD_SUMS, GN_APPLY, GN_APPLY_BWD, Q8_CROSS, PROJ_SPLIT,
           MERGE_PROJ)


def launch_counts() -> dict:
    """{name: launches} of every kernel, then {"<name>.<route>": launches}
    of every kernel with routes."""
    counts = {k.name: k.launches for k in KERNELS}
    counts.update((f"{k.name}.{r}", n) for k in KERNELS
                  for r, n in k.routes.items())
    return counts


def set_launch_counts(counts: dict) -> None:
    """The counts of ``launch_counts``'s form back into the kernels."""
    for k in KERNELS:
        k.launches = counts[k.name]
        for r in k.routes:
            k.routes[r] = counts[f"{k.name}.{r}"]


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.routes = dict.fromkeys(k.routes, 0)


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
    """Compile the library unless this source hash was built already
    (nvcc and the link inside the span ``tethys.kernels.build``)."""
    out_dir = BUILD_DIR / _source_hash()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    with tracing.span("tethys.kernels.build"):
        return _compile(out_dir, lib_path)


def _compile(out_dir: Path, lib_path: Path) -> Path:
    global build_log
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    objects, procs = [], []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [proc.communicate()[0] for proc in procs]
    build_log = "".join(logs)
    failed = [log for proc, log in zip(procs, logs) if proc.returncode != 0]
    if not failed:
        tmp = out_dir / f".{LIB_NAME}.{os.getpid()}.tmp"
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objects)],
            capture_output=True, text=True, check=False)
        build_log += link.stdout + link.stderr
        if link.returncode != 0:
            failed.append(link.stdout + link.stderr)
    (out_dir / "build.log").write_text(build_log)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed)[-6000:])
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a library
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be (its first load
    inside the span ``tethys.kernels.load``, a build inside it)."""
    global _lib
    with _lock:
        if _lib is None:
            with tracing.span("tethys.kernels.load"):
                lib = ctypes.CDLL(str(build()))
                for k in KERNELS:
                    fn = getattr(lib, k.symbol)
                    fn.argtypes = k.argtypes
                    fn.restype = ctypes.c_int
                lib.tethys_error_string.argtypes = (ctypes.c_int,)
                lib.tethys_error_string.restype = ctypes.c_char_p
                for symbol, argtypes in _QUERIES.items():
                    getattr(lib, symbol).argtypes = argtypes
                    getattr(lib, symbol).restype = ctypes.c_int
            _lib = lib
        return _lib


def stream_handle(tensor) -> int:
    """The raw cudaStream_t of torch's current stream on tensor's device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream
