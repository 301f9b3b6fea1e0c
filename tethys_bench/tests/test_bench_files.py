"""BENCHMARK.json and the files it finds by name: every cell's
configuration, traffic and limits, and every per-layer metric's reader."""

import json
import re
from pathlib import Path

from tethys_bench import compare

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "tethys_bench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _benchmark():
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def test_every_cell_finds_its_files():
    bench = _benchmark()
    configs = {c["name"]: c for c in bench["configs"]}
    for cell in bench["workloads"]:
        assert NAME.match(cell["name"]) and cell["chips"] == 1
        assert (ROOT / configs[cell["config"]]["file"]).is_file()
        assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
        with open(BENCH / "limits" / f"{cell['name']}.json") as fh:
            limits = json.load(fh)
        assert limits and set(limits) <= set(compare.NUMBERS)
    used = {cell["config"] for cell in bench["workloads"]}
    assert used == set(configs)


def test_every_metric_has_a_reader():
    bench = _benchmark()
    cells = {cell["name"] for cell in bench["workloads"]}
    for metric in bench["per_layer"]:
        assert NAME.match(metric["name"])
        assert (BENCH / "metrics" / f"{metric['name']}.py").is_file()
        assert set(metric.get("workloads", cells)) <= cells
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names
