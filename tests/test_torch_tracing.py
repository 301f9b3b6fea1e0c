"""The port's spans and counters (tethys_tpu_torch/utils/tracing.py) on the
CPU: recording off costs nothing and records nothing; spans nest with
parents, step ids and self time; the training loop and the train step
give every step its spans without changing the loop's lines; the
counters; the spans on a CPU ``torch.profiler``'s timeline; no span name
holds a key of the benchmark's frozen trace categories; the exporter's
file; step_profile's reading of a recording."""

import json
import os
import re

import numpy as np
import pytest
import torch

from tethys_bench import trace as bench_trace
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.profiling import step_profile
from tethys_tpu_torch.train import jobs
from tethys_tpu_torch.train.loop import run_training
from tethys_tpu_torch.utils import kernel_lib, tracing

torch.set_num_threads(2)

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "tethys_tpu_torch")
WHISPER_TINY = dict(
    d_model=32, encoder_layers=1, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=64, vocab_size=128, max_target_positions=128,
    decoder_start_token_id=101,
)
W2V_TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=(16, 16, 16), conv_stride=(5, 2, 2),
    conv_kernel=(10, 3, 2), num_conv_pos_embeddings=8,
    num_conv_pos_embedding_groups=4, num_codevectors_per_group=12,
    num_codevector_groups=2, codevector_dim=16, proj_codevector_dim=16,
    num_negatives=5,
)
SEQ_LEN = 64
STEP_SPANS = ("tethys.loop.input", "tethys.loop.dispatch",
              "tethys.step.zero_grad", "tethys.step.forward",
              "tethys.step.backward", "tethys.step.optimizer",
              "tethys.loop.fetch")
LINE_RE = re.compile(r"Step (\d+), Loss: (-?\d+\.\d{4}), Time: "
                     r"\d{2}:\d{2}:\d{2} \(경과: \d+\.\d{2}초, 스텝 시간: "
                     r"\d+\.\d{2}초\)")


def _whisper_job(seed=0):
    return jobs.make_whisper_job(batch_size_per_replica=2,
                                 data_seq_len=SEQ_LEN,
                                 config_overrides=WHISPER_TINY,
                                 device="cpu", seed=seed)


def _run(job, steps, **kw):
    return run_training(job.step_fn, job.dataset, job.state, 0,
                        max_iterations=steps,
                        prepare_batch=job.prepare_batch, **kw)


class _Clock:
    """A fake ``perf_counter_ns``: each read advances 1 ms."""

    def __init__(self):
        self.now = 0

    def __call__(self):
        self.now += 1_000_000
        return self.now


def test_recording_off_gives_the_shared_no_op():
    assert tracing._recorder is None
    first = tracing.span("tethys.a")
    assert first is tracing.NO_SPAN
    assert tracing.span("tethys.b", device=True) is first
    with first as entered:
        assert entered is first
    tracing.count("c", 5)
    tracing.set_step(3)

    @tracing.spanned("tethys.c")
    def add(a, b=1):
        return a + b

    assert add(1, b=2) == 3 and add.__name__ == "add"
    with tracing.recording() as rec:
        pass
    assert rec.records == [] and rec.counters == {} and rec.launches == {}
    assert tracing._recorder is None


def test_nested_spans_get_parents_steps_and_self_time(monkeypatch):
    monkeypatch.setattr(tracing.time, "perf_counter_ns", _Clock())
    with tracing.recording() as rec:
        tracing.set_step(7)
        with tracing.span("tethys.outer"):        # start at 1 ms
            with tracing.span("tethys.inner"):    # 2 .. 3 ms
                pass
            with tracing.span("tethys.inner", device=True):   # 4 .. 5 ms
                pass
        # outer ends at 6 ms
        tracing.set_step(8)
        with tracing.span("tethys.alone"):
            tracing.count("things", 2)
            tracing.count("things")
    names = [(r.name, r.parent, r.step) for r in rec.records]
    assert names == [("tethys.outer", None, 7), ("tethys.inner", 0, 7),
                     ("tethys.inner", 0, 7), ("tethys.alone", None, 8)]
    spans = rec.summary()["spans"]
    assert spans["tethys.outer"] == {"count": 1, "host_ms": 5.0,
                                     "self_ms": 3.0, "device_ms": None}
    assert spans["tethys.inner"] == {"count": 2, "host_ms": 2.0,
                                     "self_ms": 2.0, "device_ms": None}
    assert rec.counters == {"things": 3}
    assert rec.summary()["counters"] == {"things": 3}


def test_recording_does_not_nest_and_ends_on_an_error():
    with pytest.raises(ValueError, match="inside"):
        with tracing.recording() as rec:
            with tracing.span("tethys.x"):
                with pytest.raises(RuntimeError, match="on already"):
                    with tracing.recording():
                        pass
                raise ValueError("inside")
    assert tracing._recorder is None
    assert [r.name for r in rec.records] == ["tethys.x"]
    assert rec._open == []


def test_turns_and_device_ms_from_made_up_events():
    rec = tracing.Recorder()
    for step, (f0, f1, o0, o1) in enumerate([(0, 10, 12, 15),
                                            (19, 30, 31, 33),
                                            (40, 50, 52, 54)]):
        for name, a, b in (("tethys.step.forward", f0, f1),
                           ("tethys.step.optimizer", o0, o1)):
            r = tracing.SpanRecord(name, None, step, 0)
            r.device_start_ms, r.device_end_ms = float(a), float(b)
            rec.records.append(r)
    assert rec.turns("tethys.step.optimizer",
                     "tethys.step.forward") == [4.0, 7.0]
    spans = rec.summary()["spans"]
    assert spans["tethys.step.forward"]["device_ms"] == 31.0
    assert spans["tethys.step.optimizer"]["device_ms"] == 7.0


def test_write_gives_the_summary_and_every_span(tmp_path):
    with tracing.recording() as rec:
        tracing.set_step(0)
        with tracing.span("tethys.a"):
            with tracing.span("tethys.b", device=True):
                tracing.count("n", 4)
    path = tmp_path / "spans.json"
    rec.write(str(path))
    with open(path) as fh:
        got = json.load(fh)
    assert got["summary"]["counters"] == {"n": 4}
    assert set(got["summary"]["spans"]) == {"tethys.a", "tethys.b"}
    assert [(s["name"], s["parent"], s["step"]) for s in got["spans"]] == [
        ("tethys.a", None, 0), ("tethys.b", 0, 0)]
    # No CUDA here: a device span keeps its host times alone.
    assert got["spans"][1]["device_start_ms"] is None


def test_run_training_gives_every_step_its_spans(capsys):
    torch.manual_seed(0)
    plain = _run(_whisper_job(), 3)
    off = capsys.readouterr().out
    with tracing.recording() as rec:
        traced = _run(_whisper_job(), 3, step_hooks=(lambda *a: None,))
    on = capsys.readouterr().out
    # The loop's lines and losses are those of recording off.
    assert [m.groups() for m in LINE_RE.finditer(on)] == \
        [m.groups() for m in LINE_RE.finditer(off)]
    assert on.splitlines()[0] == off.splitlines()[0] == "Epoch 1/1"
    assert len(on.splitlines()) == len(off.splitlines()) == 4
    assert traced.losses == plain.losses
    by_step = {}
    for r in rec.records:
        if r.step is not None:
            by_step.setdefault(r.step, []).append(r)
    assert sorted(by_step) == [0, 1, 2]
    for step, records in by_step.items():
        names = [r.name for r in records]
        for name in STEP_SPANS + ("tethys.loop.hooks",):
            assert names.count(name) == 1, (step, name, names)
        parent = {r.name: (rec.records[r.parent].name if r.parent is not None
                           else None) for r in records}
        assert parent["tethys.loop.input"] is None
        assert parent["tethys.loop.dispatch"] is None
        assert parent["tethys.loop.fetch"] is None
        assert parent["tethys.loop.hooks"] is None
        for name in ("tethys.step.zero_grad", "tethys.step.forward",
                     "tethys.step.backward", "tethys.step.optimizer"):
            assert parent[name] == "tethys.loop.dispatch"
        order = [n for n in names if n in STEP_SPANS]
        assert order == list(STEP_SPANS)
    # Step i's fetch comes after step i + 1's dispatch (one step deep).
    starts = {(r.name, r.step): r.start_ns for r in rec.records}
    assert starts[("tethys.loop.fetch", 0)] > \
        starts[("tethys.loop.dispatch", 1)]
    spans = rec.summary()["spans"]
    assert spans["tethys.loop.dispatch"]["self_ms"] < \
        spans["tethys.loop.dispatch"]["host_ms"]
    assert all(s["device_ms"] is None for s in spans.values())
    assert "tethys.step.clip" not in spans   # Whisper's plain step
    assert "tethys.step.reduce" not in spans  # no process group


def test_the_job_build_is_a_set_up_span():
    with tracing.recording() as rec:
        _whisper_job()
    assert [(r.name, r.parent) for r in rec.records] == [
        ("tethys.setup.build_job", None)]


def test_wav2vec2_step_spans_negatives_and_clip():
    job = jobs.make_wav2vec2_job("pretraining", "small", 2,
                                 audio_length=400, config_overrides=W2V_TINY,
                                 device="cpu", seed=0)
    with tracing.recording() as rec:
        _run(job, 2)
    parent = {r.name: rec.records[r.parent].name for r in rec.records
              if r.parent is not None}
    assert parent["tethys.w2v2.negatives"] == "tethys.step.forward"
    assert parent["tethys.step.clip"] == "tethys.loop.dispatch"
    spans = rec.summary()["spans"]
    assert spans["tethys.w2v2.negatives"]["count"] == 2
    assert spans["tethys.step.clip"]["count"] == 2
    # CPU batches are not uploaded: nothing pinned.
    assert "input.bytes.pinned" not in rec.counters


def test_counters_input_bytes_and_failed_steps(capsys):
    job = _whisper_job()
    features, labels = next(iter(job.dataset))
    real, calls = job.step_fn, []

    def flaky(state, batch, generator):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("a bad step")
        return real(state, batch, generator)

    with tracing.recording() as rec:
        run_training(flaky, job.dataset, job.state, 0, max_iterations=4,
                     prepare_batch=job.prepare_batch, resilient=True)
    assert "Error at step 1: a bad step" in capsys.readouterr().out
    assert rec.counters == {
        "input.bytes.pageable": 4 * (features.nbytes + labels.nbytes),
        "loop.steps_failed": 1}


def test_a_failed_fetch_counts_once():
    class Poisoned:
        def item(self):
            raise RuntimeError("poisoned")

    def step_fn(state, batch, generator):
        return state, Poisoned() if batch == 1 else torch.tensor(1.0)

    with tracing.recording() as rec:
        run_training(step_fn, [0, 1, 2], None, 0, max_iterations=3,
                     resilient=True)
    assert rec.counters == {"loop.steps_failed": 1}
    fetches = [r.step for r in rec.records if r.name == "tethys.loop.fetch"]
    assert fetches == [0, 1, 2]


def test_spans_lie_on_a_cpu_profilers_timeline():
    job = _whisper_job()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracing.recording():
            _run(job, 2)
    events = prof.events()
    forward = [e for e in events if e.name == "tethys.step.forward"]
    assert len(forward) == 2
    names = {e.name for e in events}
    assert set(STEP_SPANS) <= names
    for span in forward:
        r = span.time_range
        inside = [e for e in events if e.name.startswith("aten::")
                  and r.start <= e.time_range.start
                  and e.time_range.end <= r.end]
        assert any(e.name in ("aten::linear", "aten::addmm", "aten::mm",
                              "aten::matmul") for e in inside)
    # Without recording, no span reaches the profiler.
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _run(job, 1)
    assert not any(e.name.startswith("tethys.") for e in prof.events())


def _span_names():
    names = set()
    pattern = re.compile(r"""span(?:ned)?\(\s*["']([^"']+)["']""")
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    names.update(pattern.findall(fh.read()))
    return sorted(names)


SPAN_NAMES = _span_names()
CATEGORY_KEYS = sorted(
    {k for _, keys in bench_trace.KERNEL_CATEGORIES + bench_trace.OP_CATEGORIES
     for k in keys} | set(bench_trace.PRODUCT_KERNELS))


def test_every_span_of_the_tables_is_in_the_source():
    assert set(STEP_SPANS) | {
        "tethys.setup.build_job", "tethys.kernels.build",
        "tethys.kernels.load", "tethys.w2v2.negatives", "tethys.step.reduce",
        "tethys.step.clip", "tethys.loop.hooks",
        "tethys.loop.checkpoint"} == set(SPAN_NAMES)


@pytest.mark.parametrize("name", SPAN_NAMES)
def test_no_span_name_holds_a_trace_category_key(name):
    assert name.startswith("tethys.")
    lowered = name.lower()
    assert not [k for k in CATEGORY_KEYS if k in name or k.lower() in lowered]


def test_kernel_build_and_load_spans_even_when_the_build_fails(
        monkeypatch, tmp_path):
    monkeypatch.setattr(kernel_lib, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(kernel_lib, "_lib", None)
    monkeypatch.setattr(kernel_lib, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with tracing.recording() as rec:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            kernel_lib.library()
    assert [(r.name, r.parent) for r in rec.records] == [
        ("tethys.kernels.load", None), ("tethys.kernels.build", 0)]
    assert not hasattr(kernel_lib, "build_seconds")


def test_launch_counts_change_over_a_recording():
    before = kernel_lib.launch_counts()
    try:
        with tracing.recording() as rec:
            kernel_lib.SPLIT_HEADS.launches += 2
            kernel_lib.FLASH_FWD.routes["wgmma"] += 1
            kernel_lib.FLASH_FWD.launches += 1
        assert rec.launches == {"split_heads": 2, "flash_fwd": 1,
                                "flash_fwd.wgmma": 1}
        assert rec.summary()["launches"] == rec.launches
    finally:
        kernel_lib.set_launch_counts(before)


def test_step_profile_reads_the_loops_spans():
    job = _whisper_job()
    with tracing.recording() as rec:
        _run(job, 3)
    host, spans = step_profile.loop_host_ms(rec, 3)
    fetch = [r.host_ms for r in rec.records if r.name == "tethys.loop.fetch"]
    assert len(fetch) == 3
    assert host["wait_previous_loss"] == pytest.approx(sum(fetch[:2]) / 3)
    assert host["batch"] == pytest.approx(
        spans["tethys.loop.input"]["host"])
    assert host["queue_step"] == pytest.approx(
        spans["tethys.loop.dispatch"]["host"])
    assert spans["tethys.step.forward"]["device"] is None
    assert np.isfinite(spans["tethys.step.backward"]["self"])


def test_dp_step_alone_records_its_spans_without_a_loop():
    job = _whisper_job()
    batch = job.prepare_batch(next(iter(job.dataset)))
    with tracing.recording() as rec:
        job.step_fn(job.state, batch, dp.step_generator(0, 0))
    assert [r.name for r in rec.records] == [
        "tethys.step.zero_grad", "tethys.step.forward",
        "tethys.step.backward", "tethys.step.optimizer"]
    assert all(r.step is None and r.parent is None for r in rec.records)
