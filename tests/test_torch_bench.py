"""The training bench's twin (tethys_tpu_torch/scripts/bench.py) against
bench.py: the same flags and defaults, the rows in bench.py's order with
its keys (``flops_hlo`` and ``mfu_hlo_only`` renamed ``flops_counted`` and
``mfu_counted_only``), ``vs_baseline`` 1.0, the card by default (no
fallback), the capacity flags, ``--scan_layers`` and ``--flat_opt``
passed to the jobs (``--flat_opt`` clearing ``--remat`` with bench.py's
note), and a CPU run of the plain versions at the tiny size.
"""

import ast
import math
import pathlib

import pytest
import torch

from tethys_tpu_torch.scripts import bench
from tethys_tpu_torch.utils import kernel_lib

ROOT = pathlib.Path(__file__).resolve().parents[1]
KEYS = ["metric", "value", "unit", "vs_baseline", "step_time_s",
        "batch_size", "dtype", "loss", "backend", "flops_per_step",
        "flops_counted", "flops_custom_calls", "mfu", "mfu_counted_only",
        "peak_tflops"]


def _jax_bench_defaults() -> dict:
    """{flag: default} of every add_argument in bench.py, read from its
    source (running it would import jax)."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    defaults = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flag = node.args[0].value.lstrip("-")
            kw = {k.arg: k.value for k in node.keywords}
            defaults[flag] = (ast.literal_eval(kw["default"])
                              if "default" in kw else False)
    return defaults


def test_defaults_equal_the_jax_bench():
    want = _jax_bench_defaults()
    got = vars(bench.parse_args([]))
    assert got.pop("device") == "cuda"
    assert got == want


def test_keys_are_the_jax_rows_renamed():
    """The keys of bench.py's row, in its order, with the HLO count
    renamed for the flop counter's."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    rows = [[k.value for k in node.keys] for node in ast.walk(tree)
            if isinstance(node, ast.Dict) and node.keys
            and all(isinstance(k, ast.Constant) for k in node.keys)
            and "flops_hlo" in [k.value for k in node.keys]]
    assert len(rows) == 1
    renamed = {"flops_hlo": "flops_counted",
               "mfu_hlo_only": "mfu_counted_only"}
    assert [renamed.get(k, k) for k in rows[0]] == KEYS


class _Built(Exception):
    pass


@pytest.mark.parametrize("argv", [["--scan_layers"], ["--flat_opt"]])
def test_unported_flags_are_refused(monkeypatch, capsys, argv):
    """The two flags refused until they were ported now reach the jobs the
    bench builds where bench.py's build_family_step applies them:
    --scan_layers to Wav2Vec2's job alone, --flat_opt to both; with
    --remat, --flat_opt prints bench.py's note and clears it."""
    seen = {}

    def recording(family):
        def build(*args, **kwargs):
            seen[family] = kwargs
            raise _Built
        return build

    monkeypatch.setattr(bench.jobs, "make_whisper_job", recording("whisper"))
    monkeypatch.setattr(bench.jobs, "make_wav2vec2_job", recording("wav2vec2"))
    args = bench.parse_args(argv + ["--remat", "--device", "cpu"])
    for family in ("whisper", "wav2vec2"):
        with pytest.raises(_Built):
            bench.build_family_step(args, family, torch.device("cpu"))
    flat_opt = argv == ["--flat_opt"]
    assert seen["wav2vec2"]["scan_layers"] is not flat_opt
    assert "scan_layers" not in seen["whisper"]
    for family in ("whisper", "wav2vec2"):
        assert seen[family]["flat_opt"] is flat_opt
        assert seen[family]["remat"] is not flat_opt
    err = capsys.readouterr().err
    assert ("--flat_opt ignores --remat" in err) is flat_opt


@pytest.mark.parametrize("argv,whisper,both", [
    (["--master_dtype", "bfloat16"], {}, dict(master_dtype="bfloat16")),
    (["--remat"], {}, dict(remat=True)),
    (["--remat_layers"], dict(remat_layers=True), {}),
    (["--remat_policy", "none"], dict(remat_policy="none"), {}),
])
def test_capacity_flags_reach_the_jobs(monkeypatch, argv, whisper, both):
    """The capacity flags (refused until they were ported) reach the jobs
    the bench builds where bench.py's build_family_step applies them:
    --master_dtype and --remat to both families, --remat_layers and
    --remat_policy to Whisper's config."""
    seen = {}

    def recording(family):
        def build(*args, **kwargs):
            seen[family] = kwargs
            raise _Built
        return build

    monkeypatch.setattr(bench.jobs, "make_whisper_job", recording("whisper"))
    monkeypatch.setattr(bench.jobs, "make_wav2vec2_job", recording("wav2vec2"))
    args = bench.parse_args(argv + ["--device", "cpu"])
    for family in ("whisper", "wav2vec2"):
        with pytest.raises(_Built):
            bench.build_family_step(args, family, torch.device("cpu"))
    capacity = {**dict(remat=False, master_dtype="float32"), **both}
    for family in ("whisper", "wav2vec2"):
        assert {k: seen[family][k] for k in capacity} == capacity
    assert "config_overrides" not in seen["wav2vec2"]
    assert seen["whisper"]["config_overrides"] == {
        **dict(remat_layers=False, remat_policy="save_flash"), **whisper}


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--model", "tiny", "--steps", "1", "--warmup", "1"])


@pytest.mark.parametrize("argv,want", [
    ([], [("wav2vec2", None, ""), ("wav2vec2", 64, "_b64_sweet_spot"),
          ("whisper", None, "")]),
    (["--batch_size", "8"], [("wav2vec2", 8, ""), ("whisper", 8, "")]),
    (["--model", "tiny"], [("wav2vec2", None, ""), ("whisper", None, "")]),
    (["--family", "wav2vec2"], [("wav2vec2", None, "")]),
    (["--family", "whisper"], [("whisper", None, "")]),
])
def test_rows_in_the_jax_order(monkeypatch, argv, want):
    """Wav2Vec2 first, bench.py's batch-64 row only at its defaults, the
    Whisper headline last."""
    calls = []

    def run(args, family, device, tag_suffix=""):
        calls.append((family, args.batch_size, tag_suffix))
        return {"metric": family + tag_suffix}

    monkeypatch.setattr(bench, "_run_family", run)
    rows = bench.main(argv + ["--device", "cpu"])
    assert calls == want
    assert [r["metric"] for r in rows] == [f + s for f, _, s in want]


def test_cpu_run_prints_the_rows(monkeypatch, capsys):
    """The twin at the tiny size on the CPU (30 s clips cut to 64 frames
    and 2 s clips to 0.1 s, so the test stays small): one JSON line a row,
    Whisper last, finite values, no MFU on the CPU, no kernel launched."""
    import json

    monkeypatch.setattr(bench, "WHISPER_FRAMES", 64)
    monkeypatch.setattr(bench, "WAV2VEC2_SAMPLES", 1600)
    monkeypatch.setenv("TETHYS_PEAK_TFLOPS", "123")
    kernel_lib.reset_launch_counts()
    rows = bench.main(["--device", "cpu", "--model", "tiny", "--steps", "2",
                       "--warmup", "1"])
    lines = capsys.readouterr().out.splitlines()
    assert [json.loads(line) for line in lines] == rows
    assert [r["metric"] for r in rows] == [
        "wav2vec2_tiny_audio_sec_per_sec_per_chip",
        "whisper_tiny_audio_sec_per_sec_per_chip"]
    for row, batch, seconds in zip(rows, (32, 16), (0.1, 0.64)):
        assert list(row) == KEYS
        assert row["vs_baseline"] == 1.0 and row["backend"] == "cpu"
        assert row["batch_size"] == batch and row["dtype"] == "bfloat16"
        assert row["unit"] == "audio-sec/sec/chip"
        assert row["value"] == pytest.approx(
            batch * seconds / row["step_time_s"], rel=0.01)
        assert math.isfinite(row["loss"]) and row["step_time_s"] > 0
        assert row["flops_custom_calls"] == 0.0
        assert row["flops_per_step"] == row["flops_counted"] > 0
        assert row["mfu"] is None and row["mfu_counted_only"] is None
        assert row["peak_tflops"] == 123.0
    assert all(n == 0 for n in kernel_lib.launch_counts().values())


def test_batch_larger_than_the_jobs_dataset(monkeypatch):
    """bench.py's b64 row: the bench feeds its own batch, so a batch past
    the jobs' 50-sample synthetic dataset runs."""
    monkeypatch.setattr(bench, "WAV2VEC2_SAMPLES", 1600)
    (row,) = bench.main(["--device", "cpu", "--model", "tiny", "--family",
                         "wav2vec2", "--batch_size", "64", "--steps", "1",
                         "--warmup", "1", "--dtype", "float32"])
    assert row["batch_size"] == 64 and math.isfinite(row["loss"])
    assert row["peak_tflops"] == 67.0
