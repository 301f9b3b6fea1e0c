"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references load nothing of the program (top-level module names compared
whole: the program's name begins with the JAX package's)."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

RUN = """
import sys, torch
torch.set_num_threads(2)
from tethys_bench import harness, run, calibrate
from tethys_bench.tests import tiny
for family in ("whisper", "wav2vec2"):
    harness.run_cell(tiny.cell(family), 5, 0.1, False, "cpu", 0.0,
                     log=lambda *a, **k: None)
print(sorted({m.split(".")[0] for m in sys.modules}))
"""

REFERENCE = """
import sys
from tethys_bench.reference import common, whisper, wav2vec2
from tethys_bench import compare, traffic, weights, work, trace
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def _top_level(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    names = _top_level(RUN)
    assert "tethys_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "tethys_tpu"}


def test_the_yardstick_loads_nothing_of_the_program():
    names = _top_level(REFERENCE)
    assert not names & {"jax", "jaxlib", "flax", "tethys_tpu",
                        "tethys_tpu_torch"}
