"""The port's GPU monitor daemon (tethys_tpu_torch/monitor/) on the CPU.

The daemon is built with g++ (monitor/daemon.build) and run against a stub
``libnvidia-ml.so.1`` compiled here and reached through LD_LIBRARY_PATH:
its lines meet the reference line's contract (tests/test_monitor.py:
156-162).  Without the library, or when NVML fails to initialise, it
exits 1 with the reason on stderr and prints nothing on stdout.
``monitor/gpu.sh`` writes ``${RESULT}/${MODEL}/${JOB}_gpu.txt``.
"""

import os
import re
import shutil
import signal
import subprocess
import time

import pytest

from tethys_tpu_torch.monitor import daemon

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = r"""
#include <string.h>
typedef struct { unsigned int gpu, memory; } U;
typedef struct { unsigned long long total, free, used; } M;
int nvmlInit_v2(void) { return INIT_RESULT; }
int nvmlShutdown(void) { return 0; }
const char* nvmlErrorString(int r) { return "stub error"; }
int nvmlDeviceGetCount_v2(unsigned int* n) { *n = 2; return 0; }
int nvmlDeviceGetHandleByIndex_v2(unsigned int i, void** d) {
  *d = (void*)(unsigned long)(i + 1); return 0;
}
int nvmlDeviceGetName(void* d, char* name, unsigned int len) {
  strncpy(name, d == (void*)1 ? "Stub H100" : "Stub H100 b", len); return 0;
}
int nvmlDeviceGetUtilizationRates(void* d, U* u) {
  u->gpu = 87; u->memory = 41; return 0;
}
int nvmlDeviceGetMemoryInfo(void* d, M* m) {
  m->total = 8ULL << 30; m->used = 6871947673ULL; m->free = 0; return 0;
}
"""
LINE = re.compile(r"^\s*\d+:\d+:\d+:\d+  Device (\d+): (.+?)  GPU Util: (\d+)"
                  r"  Mem Util: (\d+) Mem Usage: (\d+)$")

pytestmark = pytest.mark.skipif(shutil.which("g++") is None or
                                shutil.which("gcc") is None,
                                reason="no g++/gcc to build the daemon")


def _stub(tmp_path, init_result=0):
    lib_dir = tmp_path / f"nvml_{init_result}"
    lib_dir.mkdir()
    src = lib_dir / "stub.c"
    src.write_text(STUB.replace("INIT_RESULT", str(init_result)))
    subprocess.run(["gcc", "-shared", "-fPIC", "-o",
                    str(lib_dir / "libnvidia-ml.so.1"), str(src)],
                   check=True, capture_output=True)
    return str(lib_dir)


def _run(env_lib, seconds=0.6):
    env = dict(os.environ, LD_LIBRARY_PATH=env_lib)
    proc = subprocess.Popen([str(daemon.build())], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    time.sleep(seconds)
    proc.terminate()
    out, err = proc.communicate(timeout=10)
    return proc.returncode, out, err


def test_daemon_prints_the_reference_line(tmp_path):
    rc, out, _ = _run(_stub(tmp_path))
    assert rc == 0                       # SIGTERM ends the loop cleanly
    lines = [line for line in out.splitlines() if line.strip()]
    first = lines[0].strip()
    # "H:M:S:ms  Device 0: <name>  GPU Util: u  Mem Util: m Mem Usage: b"
    assert "Device 0: Stub H100" in first
    assert "GPU Util: 87" in first
    assert "Mem Util: 41" in first
    assert "Mem Usage: 6871947673" in first
    matches = [LINE.match(line) for line in lines]
    assert all(matches)
    assert [m[1] for m in matches[:2]] == ["0", "1"]   # every device
    assert matches[1][2] == "Stub H100 b"
    assert 3 <= len(lines) // 2 <= 6     # ~6 Hz over 0.6 s
    # The reference's printf ends each line with "\n " (tpu_monitor.cpp).
    assert out.startswith(tuple("0123456789")) and "\n " in out


def test_daemon_without_nvml_exits_nonzero(tmp_path):
    rc, out, err = _run(str(tmp_path))   # no libnvidia-ml.so.1 there
    assert rc == 1 and out == ""
    assert "cannot load libnvidia-ml.so.1" in err


def test_daemon_exits_when_nvml_fails_to_initialise(tmp_path):
    rc, out, err = _run(_stub(tmp_path, init_result=9))
    assert rc == 1 and out == ""
    assert "nvmlInit failed: stub error (9)" in err


def test_gpu_sh_writes_the_job_file(tmp_path):
    """gpu.sh, as the jobs start it from the workspace: the daemon's lines
    in ${RESULT}/${MODEL}/${JOB}_gpu.txt, JOB from scripts/job_name.py."""
    ws, result = tmp_path / "ws", tmp_path / "result"
    (result / "run1").mkdir(parents=True)
    ws.mkdir()
    (ws / "model.txt").write_text("run1")
    shutil.copy(os.path.join(REPO, "tethys_tpu_torch", "monitor", "gpu.sh"),
                ws / "gpu.sh")
    daemon.build()
    env = {k: v for k, v in os.environ.items()
           if k not in ("TF_CONFIG", "WORLD_SIZE", "RANK")}
    env.update(TETHYS_WORKSPACE=str(ws), TETHYS_RESULT=str(result),
               LD_LIBRARY_PATH=_stub(tmp_path), PYTHONPATH=REPO)
    proc = subprocess.Popen(["sh", str(ws / "gpu.sh")], cwd=REPO, env=env,
                            start_new_session=True)
    path = result / "run1" / "worker_0_gpu.txt"
    try:
        proc.wait(timeout=60)
        deadline = time.time() + 60
        while time.time() < deadline and not (
                path.exists() and "Mem Usage" in path.read_text()):
            time.sleep(0.2)
    finally:
        os.killpg(proc.pid, signal.SIGTERM)   # the daemon gpu.sh left running
    assert LINE.match(path.read_text().splitlines()[0])


def test_build_is_keyed_by_the_source():
    binary = daemon.build()
    assert binary == daemon.build()
    assert binary.parent.parent == daemon.BUILD_DIR
    assert binary.name == "gpu_monitor" and os.access(binary, os.X_OK)
