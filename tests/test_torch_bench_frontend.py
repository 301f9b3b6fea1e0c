"""The frontend bench's twin (tethys_tpu_torch/scripts/bench_frontend.py)
against scripts/bench_frontend.py: the same flags and defaults, the card by
default (no fallback), and a CPU run of both paths at a tiny size.
"""

import ast
import json
import math
import pathlib

import numpy as np
import pytest
import torch

from tethys_tpu_torch.audio.frontend import extract_fbank_features
from tethys_tpu_torch.audio.logmel import fused_log_mel
from tethys_tpu_torch.scripts import bench_frontend
from tethys_tpu_torch.utils import kernel_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = {"metric", "batch", "seconds", "iters", "n_mels", "unfused_ms",
        "fused_ms",
        "speedup", "max_abs_diff", "device"}


def _jax_script_defaults() -> dict:
    """{flag: default} of every add_argument in scripts/bench_frontend.py,
    read from its source (running it would import jax)."""
    tree = ast.parse((ROOT / "scripts" / "bench_frontend.py").read_text())
    defaults = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            defaults[node.args[0].value.lstrip("-")] = ast.literal_eval(
                kw["default"])
    return defaults


def test_defaults_equal_the_jax_script():
    want = _jax_script_defaults()
    assert want == {"batch": 16, "seconds": 30, "iters": 20}
    got = vars(bench_frontend.parse_args([]))
    assert got.pop("device") == "cuda" and got.pop("n_mels") == 80
    assert got == want


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_frontend.main(["--batch", "1", "--seconds", "1", "--iters", "1"])


def test_cpu_run_prints_one_line(capsys):
    """One JSON line with the twin's keys; the fused and unfused features
    of the bench's waveform agree within test_torch_audio.py's tolerance
    (two f32 computations of the same DFT, 1e-4)."""
    kernel_lib.reset_launch_counts()
    result = bench_frontend.main(["--device", "cpu", "--batch", "1",
                                  "--seconds", "1", "--iters", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == result
    assert set(result) == KEYS
    assert result["metric"] == "frontend_logmel_ms_per_batch"
    assert result["device"] == "cpu" and result["batch"] == 1
    for key in ("unfused_ms", "fused_ms", "speedup"):
        assert math.isfinite(result[key]) and result[key] > 0
    assert result["max_abs_diff"] <= 1e-3
    assert all(n == 0 for n in kernel_lib.launch_counts().values())

    wave = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16000)).astype(np.float32))
    fused, unfused = fused_log_mel(wave), extract_fbank_features(wave)
    assert fused.shape == unfused.shape == (1, 98, 80)
    np.testing.assert_allclose(fused.numpy(), unfused.numpy(), rtol=1e-4,
                               atol=1e-4)
