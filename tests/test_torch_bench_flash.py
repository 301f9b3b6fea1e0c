"""The flash-kernel bench's twin (tethys_tpu_torch/scripts/bench_flash.py)
against scripts/bench_flash.py: the same flags and defaults, the card by
default (no fallback), and a CPU run of the plain versions at a tiny shape.
"""

import ast
import math
import pathlib

import pytest
import torch

from tethys_tpu_torch.scripts import bench_flash
from tethys_tpu_torch.utils import kernel_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_script_defaults() -> dict:
    """{flag: default} of every add_argument in scripts/bench_flash.py,
    read from its source (running it would import jax)."""
    tree = ast.parse((ROOT / "scripts" / "bench_flash.py").read_text())
    defaults = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flag = node.args[0].value.lstrip("-")
            kw = {k.arg: k.value for k in node.keywords}
            defaults[flag] = ast.literal_eval(kw["default"])
    return defaults


def test_defaults_equal_the_jax_script():
    want = _jax_script_defaults()
    assert want == {"bh": 128, "t": 1536, "tq": None, "kv_len": 1500,
                    "rate": 0.1, "iters": 50, "dtype": "bfloat16"}
    got = vars(bench_flash.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_flash.main(["--bh", "2", "--t", "256", "--iters", "1"])


def test_cpu_run_prints_both_lines(capsys):
    kernel_lib.reset_launch_counts()
    result = bench_flash.main(["--device", "cpu", "--bh", "2", "--t", "256",
                               "--kv_len", "200", "--iters", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    for line, name in zip(lines, ("flash_fwd", "flash_bwd")):
        assert line.startswith(name) and "ms/call" in line
        assert line.endswith("(bh=2 tq=256 t=256 rate=0.1)")
        assert math.isfinite(result[f"{name}_ms"])
        assert result[f"{name}_ms"] > 0
    assert result["backend"] == "cpu" and result["device"] == "cpu"
    assert result["tq"] == 256 and result["kv_len"] == 200
    assert all(n == 0 for n in kernel_lib.launch_counts().values())
