"""The decode-floor twin (tethys_tpu_torch/scripts/decode_floor.py)
against scripts/decode_floor.py: the same sizes, the same rows at the same
``--hbm_gbps``, the same printed lines, and the H100's 3.35 TB/s as its
default."""

import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest

from tethys_tpu_torch.scripts import decode_floor

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_decode_floor", ROOT / "scripts" / "decode_floor.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_sizes_equal_the_jax_script():
    assert decode_floor.SIZES == _jax_script().SIZES


@pytest.mark.parametrize("hbm_gbps", [819.0, 3350.0])
@pytest.mark.parametrize("length", [64, 128, 448])
def test_rows_equal_the_jax_script(hbm_gbps, length):
    jax_script = _jax_script()
    for size in decode_floor.SIZES:
        for batch in (1, 8, 16, 32):
            assert decode_floor.floor_row(
                size, batch, hbm_gbps, length=length) == jax_script.floor_row(
                    size, batch, hbm_gbps, length=length), (size, batch)


def test_printed_lines_equal_the_jax_script(capsys):
    argv = ["--hbm_gbps", "819", "--length", "256", "--sizes", "base",
            "large-v3"]
    want = subprocess.run([sys.executable, str(ROOT / "scripts" /
                                               "decode_floor.py"), *argv],
                          capture_output=True, text=True, check=True).stdout
    rows = decode_floor.main(argv)
    assert capsys.readouterr().out == want
    assert [json.dumps(r) for r in rows] == want.splitlines()


def test_default_rate_is_the_h100s(capsys):
    rows = decode_floor.main(["--sizes", "base"])
    capsys.readouterr()
    assert [r["batch"] for r in rows] == [8, 16, 32]
    assert rows[1] == decode_floor.floor_row("base", 16, 3350.0)
    # whisper-base b16: 404.6 MB a token over 3.35 TB/s.
    assert rows[1]["floor_ms_per_token"] == 0.121
