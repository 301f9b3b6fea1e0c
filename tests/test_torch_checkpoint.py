"""Checkpoint restore and ``--resume`` in the port (tethys_tpu_torch/
checkpoint.py, train/jobs.py), with the small pieces of the jobs: the
stable Whisper job, ``preprocess_text``, ``scripts/job_name`` and the
profiler trace of ``--jax_profile``, on the CPU.

The counterparts of tests/test_checkpoint.py and tests/test_jobs_e2e.py's
resume test: a round trip is bitwise, a resumed run equals an
uninterrupted one bitwise (tiny Whisper plain step and tiny Wav2Vec2
hardened step, dropout on), ``latest_tag`` is scoped by prefix and orders
tags by the time their save finished.
"""

import contextlib
import io
import json
import os
import runpy

import pytest
import torch

from tethys_tpu.inference import preprocess_text as jax_preprocess_text
from tethys_tpu_torch.checkpoint import CheckpointManager
from tethys_tpu_torch.inference import preprocess_text
from tethys_tpu_torch.jobs import wav2vec2_dist, whisper_dist
from tethys_tpu_torch.jobs.stable import whisper_dist as stable_whisper_dist
from tethys_tpu_torch.models import wav2vec2 as w2v
from tethys_tpu_torch.parallel import dp
from tethys_tpu_torch.scripts import job_name
from tethys_tpu_torch.train import jobs
from _torch_wav2vec2_common import AUDIO
from _torch_wav2vec2_common import TINY as W2V_TINY

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WHISPER_TINY = dict(
    d_model=32, encoder_layers=1, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=64, vocab_size=128, max_target_positions=128,
    decoder_start_token_id=101)
FRAMES = 64


def _whisper_job():
    """Tiny Whisper, the plain step, dropout on (the config's 0.1)."""
    return jobs.make_whisper_job("tiny", 2, 1e-3, "float32", seed=0,
                                 data_seq_len=FRAMES,
                                 config_overrides=WHISPER_TINY, device="cpu")


def _wav2vec2_job():
    """Tiny Wav2Vec2 pretraining, the hardened step, dropout on."""
    return jobs.make_wav2vec2_job("pretraining", "tiny", 2, 1e-3, "float32",
                                  seed=0, audio_length=AUDIO,
                                  config_overrides=W2V_TINY, device="cpu")


def _steps(job, batches, first):
    state = job.state
    for i, batch in enumerate(batches):
        state, loss = job.step_fn(state, job.prepare_batch(batch),
                                  dp.step_generator(0, first + i))
    return state


def _assert_same_state(a, b):
    for (name, x), y in zip(a.model.state_dict().items(),
                            b.model.state_dict().values()):
        assert torch.equal(x, y), name
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys()
    for k, entry in sa["state"].items():
        assert entry["step"] == sb["state"][k]["step"]
        assert torch.equal(entry["m"], sb["state"][k]["m"])
        assert torch.equal(entry["v"], sb["state"][k]["v"])


def test_save_restore_round_trip_is_bitwise(tmp_path):
    job = _whisper_job()
    state = _steps(job, [next(iter(job.dataset))], 0)
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    mgr.save("whisper_tiny_step_1", state)
    model_sd, optimizer_sd = mgr.restore("whisper_tiny_step_1")
    for name, x in state.model.state_dict().items():
        assert model_sd[name].device.type == "cpu"
        assert torch.equal(model_sd[name], x), name
    live = state.optimizer.state_dict()
    assert optimizer_sd["param_groups"] == live["param_groups"]
    for k, entry in live["state"].items():
        assert optimizer_sd["state"][k]["step"] == entry["step"] == 1
        assert torch.equal(optimizer_sd["state"][k]["m"], entry["m"])
        assert torch.equal(optimizer_sd["state"][k]["v"], entry["v"])
    fresh = mgr.restore_like("whisper_tiny_step_1", _whisper_job().state)
    _assert_same_state(fresh, state)
    for entry in fresh.optimizer.state.values():
        assert entry["m"].dtype == entry["v"].dtype == torch.float32
    assert mgr.latest_tag() == "whisper_tiny_step_1"
    assert sorted(os.listdir(mgr.directory)) == ["whisper_tiny_step_1"]


def test_latest_tag_is_scoped_and_a_resaved_tag_is_newest(tmp_path):
    job = _whisper_job()
    mgr = CheckpointManager(str(tmp_path / "ckpts"))
    assert mgr.latest_tag() is None
    for tag in ("whisper_tiny_epoch_1", "model_epoch_1",
                "whisper_tiny_step_2"):
        mgr.save(tag, job.state)
    assert mgr.latest_tag() == "whisper_tiny_step_2"
    assert mgr.latest_tag(prefix="model") == "model_epoch_1"
    assert mgr.latest_tag(prefix="whisper_base") is None
    # A second run's save of an existing tag makes it the newest, and
    # replaces it whole.
    mgr.save("whisper_tiny_epoch_1", job.state)
    assert mgr.latest_tag(prefix="whisper_tiny") == "whisper_tiny_epoch_1"
    assert mgr.latest_tag() == "whisper_tiny_epoch_1"
    # A save cut short leaves only a hidden directory, never a tag.
    os.makedirs(os.path.join(mgr.directory, ".whisper_tiny_epoch_9.cut"))
    assert mgr.latest_tag() == "whisper_tiny_epoch_1"
    assert sorted(t for t in os.listdir(mgr.directory)
                  if not t.startswith(".")) == [
        "model_epoch_1", "whisper_tiny_epoch_1", "whisper_tiny_step_2"]


@pytest.mark.parametrize("make_job", [_whisper_job, _wav2vec2_job],
                         ids=["whisper_plain", "wav2vec2_hardened"])
def test_resume_equals_uninterrupted_bitwise(tmp_path, make_job):
    """save after 2 steps + restore_like into a freshly built job + 2 more
    steps with the generators of steps 2-3 == 4 straight steps."""
    straight = make_job()
    batches = [b for b, _ in zip(straight.dataset, range(4))]
    want = _steps(straight, batches, 0)

    first = make_job()
    mgr = CheckpointManager(str(tmp_path / "c"))
    mgr.save("run_step_2", _steps(first, batches[:2], 0))
    resumed = make_job()
    resumed = resumed._replace(
        state=mgr.restore_like("run_step_2", resumed.state))
    got = _steps(resumed, batches[2:], 2)
    _assert_same_state(got, want)


def test_train_wav2vec2_resumes_its_own_checkpoint(tmp_path, capsys):
    common = dict(model_type="pretraining", model_size="tiny",
                  batch_size_per_replica=2, num_batches=2,
                  checkpoint_dir=str(tmp_path / "ck"), audio_length=AUDIO,
                  config_overrides=W2V_TINY, device="cpu")
    jobs.train_wav2vec2(**common)
    capsys.readouterr()
    jobs.train_wav2vec2(**common, resume=True)
    out = capsys.readouterr().out
    assert "Resumed from checkpoint model_epoch_1" in out.splitlines()


def test_whisper_resume_never_takes_a_model_tag(tmp_path, capsys):
    """The Whisper job's prefix is its own tag: with only Wav2Vec2's
    model_epoch_1 there, it starts fresh; then it resumes its own."""
    common = dict(model_type="tiny", batch_size_per_replica=2,
                  num_batches=1, checkpoint_dir=str(tmp_path / "ck"),
                  data_seq_len=FRAMES, config_overrides=WHISPER_TINY,
                  device="cpu")
    jobs.train_wav2vec2(model_size="tiny", batch_size_per_replica=2,
                        num_batches=1, checkpoint_dir=str(tmp_path / "ck"),
                        audio_length=AUDIO, config_overrides=W2V_TINY,
                        device="cpu")
    capsys.readouterr()
    jobs.train_whisper(**common, resume=True)
    assert "Resumed from checkpoint" not in capsys.readouterr().out
    jobs.train_whisper(**common, resume=True)
    assert "Resumed from checkpoint whisper_tiny_epoch_1" in \
        capsys.readouterr().out.splitlines()


def test_stable_whisper_job_is_whisper_dist():
    assert stable_whisper_dist.main is whisper_dist.main
    assert vars(stable_whisper_dist.build_parser().parse_args([])) == vars(
        whisper_dist.build_parser().parse_args([]))


def test_preprocess_text_equals_jax():
    class Tok:   # tests/test_audio.py's stub tokenizer
        bos_token_id = 1
        eos_token_id = 2

        def encode(self, text):
            return [ord(c) % 50 + 3 for c in text]

    for text in ("ab", "", "tethys"):
        got = preprocess_text(text, Tok())
        assert got == jax_preprocess_text(text, Tok())
        assert got[0] == 1 and got[-1] == 2 and len(got) == len(text) + 2


@pytest.mark.parametrize("tf_config,want", [
    (None, "worker_0"),
    ({"cluster": {"chief": ["h:1"], "worker": ["h:2", "h:3"]},
      "task": {"type": "worker", "index": 1}}, "worker_1"),
    ({"cluster": {"chief": ["h:1"]}, "task": {"type": "chief", "index": 0}},
     "chief_0"),
    ({"cluster": {"worker": ["h:1", "h:2"]}}, "None_None"),
    ({"task": {"type": "worker"}}, "worker_None"),
    ("not json", json.JSONDecodeError),
])
def test_job_name_equals_the_jax_script(monkeypatch, tf_config, want):
    """The twin prints what the JAX script prints: TF_CONFIG's fields as
    they stand (None where one is missing), and malformed JSON raises on
    both sides."""
    if tf_config is None:
        monkeypatch.delenv("TF_CONFIG", raising=False)
    else:
        monkeypatch.setenv("TF_CONFIG", tf_config if isinstance(
            tf_config, str) else json.dumps(tf_config))
    if want is json.JSONDecodeError:
        with pytest.raises(json.JSONDecodeError):
            job_name.main()
        with pytest.raises(json.JSONDecodeError):
            runpy.run_path(os.path.join(ROOT, "scripts", "job_name.py"))
        return
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert job_name.main() == want
        runpy.run_path(os.path.join(ROOT, "scripts", "job_name.py"))
    assert out.getvalue().splitlines() == [want, want]


def test_jax_profile_writes_a_trace(monkeypatch, tmp_path, capsys):
    """--jax_profile DIR on a CPU job: the job runs as without it, and a
    Chrome trace of the run, with the program's spans on its timeline, and
    the spans' own file are in DIR."""
    real = w2v.create_full_model

    def tiny_model(model_type, model_size, **kw):
        return real(model_type, "tiny", **{**kw, **W2V_TINY})

    monkeypatch.setattr(w2v, "create_full_model", tiny_model)
    ws = os.environ["TETHYS_WORKSPACE"]
    with open(os.path.join(ws, "model.txt"), "w") as fh:
        fh.write("run1")
    os.makedirs(os.path.join(os.environ["TETHYS_RESULT"], "run1"))
    trace_dir = tmp_path / "trace"
    wav2vec2_dist.main(["--model_size", "tiny", "--batch_size", "1",
                        "--num_batches", "1", "--device", "cpu",
                        "--jax_profile", str(trace_dir)])
    out = capsys.readouterr().out
    assert "Training completed." in out
    traces = sorted(os.listdir(trace_dir))
    assert traces == [f"spans_{os.getpid()}.json", f"trace_{os.getpid()}.json"]
    assert f"torch.profiler trace written to {trace_dir / traces[1]}" in out
    assert f"spans written to {trace_dir / traces[0]}" in out
    with open(trace_dir / traces[1]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    names = {str(e.get("name", "")) for e in events}
    assert {"tethys.setup.build_job", "tethys.loop.dispatch",
            "tethys.step.forward", "tethys.w2v2.negatives"} <= names
    with open(trace_dir / traces[0]) as fh:
        spans = json.load(fh)
    assert spans["summary"]["spans"]["tethys.step.backward"]["count"] == 1
    assert [s["step"] for s in spans["spans"]
            if s["name"] == "tethys.loop.fetch"] == [0]


def test_a_failing_profiler_does_not_stop_the_job(monkeypatch, capsys):
    from tethys_tpu_torch.utils import tracing

    def broken(**kwargs):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    ran = []
    with tracing.maybe_profiler_trace("/nonexistent/dir"):
        ran.append(True)
    assert ran == [True]
    assert "torch.profiler unavailable: no profiler here" in \
        capsys.readouterr().out
    with tracing.maybe_profiler_trace(None):
        ran.append(True)
    assert ran == [True, True]

