"""The port's tensorsize profiler against the JAX package's, on the CPU.

The tiny configs of tests/test_torch_train.py and
tests/_torch_wav2vec2_common.py; f32 and every dropout rate 0 where values
are compared.
- The activation census (``intermediate_inventory``) equals JAX's
  ``capture_intermediates`` census name for name, shape for shape and
  dtype for dtype (f32 and bf16), and so do the input, output, parameter,
  gradient and intra-op rows; at whisper-small's full width (B 1, Te 1500,
  Td 100, f32) both shape-only censuses give the same byte total, and the
  port's allocates no parameter.
- Two profiled steps of ``train_whisper`` and ``train_wav2vec2`` on both
  packages (the JAX job's initial parameters carried across with
  ``params_from_flax``, one fixed set of negatives on both sides) write
  byte-identical tensor_sizes.txt, summary.txt, tiresias_tensorsize.txt,
  tiresias_result.json, legacy_skewness_result.txt and
  skewness_analysis.txt; skewness_analysis.json and final_summary.json are
  identical but for the memory fields and the value skews, which agree
  within atol 1e-4 (two f32 implementations summing in different orders).
- ``flax_from_state_dict`` inverts ``params_from_flax``.
- Both CLIs run with ``--device cpu`` as a chief and a worker (TF_CONFIG),
  each rank this file run as a script at a tiny size.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tethys_tpu_torch.models import wav2vec2 as w2v  # noqa: E402
from tethys_tpu_torch.train import jobs  # noqa: E402

W2V_TINY = dict(
    hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=64, conv_dim=(16, 16, 16), conv_stride=(5, 2, 2),
    conv_kernel=(10, 3, 2), num_conv_pos_embeddings=8,
    num_conv_pos_embedding_groups=4, num_codevectors_per_group=12,
    num_codevector_groups=2, codevector_dim=16, proj_codevector_dim=16,
    num_negatives=5, classifier_proj_size=8, vocab_size=12, num_labels=3,
)
WHISPER_TINY = dict(
    d_model=32, encoder_layers=1, encoder_attention_heads=2,
    decoder_layers=1, decoder_attention_heads=2, d_ff=64,
    n_mels=8, n_ctx=64, vocab_size=128, max_target_positions=128,
    decoder_start_token_id=101,
)
SEQ_LEN = 64                     # whisper frames
AUDIO = 400                      # wav2vec2 samples -> 20 frames
STEPS = 2
TIMEOUT_S = 300


def _rank_job(family: str, *argv: str) -> None:
    """One rank of the TF_CONFIG world: a tensorsize CLI at the tiny size
    (the job's config overrides and clip length patched in)."""
    from tethys_tpu_torch.jobs import (wav2vec2_dist_tensorsize,
                                       whisper_dist_tensorsize)

    if family == "whisper":
        real = jobs.train_whisper
        jobs.train_whisper = lambda **kw: real(
            **kw, data_seq_len=SEQ_LEN, config_overrides=WHISPER_TINY)
        whisper_dist_tensorsize.main(list(argv))
    else:
        real = jobs.train_wav2vec2
        jobs.train_wav2vec2 = lambda **kw: real(
            **kw, audio_length=AUDIO, config_overrides=W2V_TINY)
        wav2vec2_dist_tensorsize.main(list(argv))


if __name__ == "__main__":
    # A rank of the world the CLI test launches: it needs neither JAX nor
    # pytest.
    torch.set_num_threads(1)
    _rank_job(*sys.argv[1:])
    sys.exit(0)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402

from tethys_tpu import losses as jax_losses  # noqa: E402
from tethys_tpu.configs import WhisperConfig as JaxWhisperConfig  # noqa: E402
from tethys_tpu.models import wav2vec2 as jax_w2v  # noqa: E402
from tethys_tpu.models.whisper import create_whisper_model as jax_whisper  # noqa: E402
from tethys_tpu.parallel.mesh import make_data_mesh  # noqa: E402
from tethys_tpu.profiling import tensorsize as jts  # noqa: E402
from tethys_tpu.train import jobs as jax_jobs  # noqa: E402
from tethys_tpu_torch import convert  # noqa: E402
from tethys_tpu_torch.configs import Wav2Vec2Config, WhisperConfig  # noqa: E402
from tethys_tpu_torch.jobs import (  # noqa: E402
    wav2vec2_dist_tensorsize,
    whisper_dist_tensorsize,
)
from tethys_tpu_torch.models.whisper import (  # noqa: E402
    WhisperForConditionalGeneration,
)
from tethys_tpu_torch.profiling import tensorsize  # noqa: E402
from tethys_tpu_torch.train import loop  # noqa: E402

SKEW_ATOL = 1e-4
MEMORY_FIELDS = ("avg_memory_usage", "peak_memory_usage")
IDENTICAL = ("tensor_sizes.txt", "summary.txt", "tiresias_tensorsize.txt",
             "tiresias_result.json", "legacy_skewness_result.txt",
             "skewness_analysis.txt")
NO_DROPOUT = {"whisper": dict(dropout=0.0, attention_dropout=0.0,
                              activation_dropout=0.0),
              "wav2vec2": dict(hidden_dropout=0.0, activation_dropout=0.0,
                               attention_dropout=0.0)}

torch.set_num_threads(2)


def _jax_whisper(dtype):
    cfg = JaxWhisperConfig(**WHISPER_TINY, compute_dtype=dtype)
    model = jax_whisper("small", **WHISPER_TINY, compute_dtype=dtype)[0]
    params = jax_jobs._init_whisper(model, cfg, jax.random.PRNGKey(0))
    return model, params


def _jax_wav2vec2(dtype):
    model, cfg = jax_w2v.create_full_model(
        "pretraining", "small", compute_dtype=dtype, **W2V_TINY,
        **NO_DROPOUT["wav2vec2"])
    params = jax_jobs._init_wav2vec2(model, cfg, jax.random.PRNGKey(0),
                                     "pretraining")
    return model, params


def _jax_whisper_inventories(model, params, batch, seq_len):
    """The static rows of the JAX whisper job (tethys_tpu/train/jobs.py
    :239-274), computed the JAX way."""
    feats = jax.ShapeDtypeStruct((batch, model.config.n_mels, seq_len),
                                 jnp.float32)
    labs = jax.ShapeDtypeStruct((batch, 100), jnp.int32)
    out = jax.eval_shape(lambda p, f, l: model.apply(
        {"params": p}, f, labels=l, deterministic=True), params, feats, labs)
    return [
        (jts.tensor_inventory_from_tree(
            {"input_features": feats, "labels": labs}, "input"), "input"),
        (jts.intermediate_inventory(model, params, feats, labels=labs,
                                    deterministic=True), "activation"),
        (jts.whisper_intra_op_inventory(model.config, batch,
                                        enc_len=-(-seq_len // 2),
                                        dec_len=100), "activation"),
        (jts.tensor_inventory_from_tree(out, "output"), "output"),
        (jts.tensor_inventory_from_tree(params, "gradient"), "gradient"),
    ]


def _jax_wav2vec2_inventories(model, params, batch, audio_length):
    rng = jax.random.PRNGKey(0)
    audio = jax.ShapeDtypeStruct((batch, audio_length), jnp.float32)
    out = jax.eval_shape(lambda p, a: model.apply(
        {"params": p}, a, training=True, rngs={"dropout": rng}), params, audio)
    return [
        (jts.tensor_inventory_from_tree({"input_values": audio}, "input"),
         "input"),
        (jts.intermediate_inventory(model, params, audio, training=True,
                                    rngs={"dropout": rng}), "activation"),
        (jts.wav2vec2_intra_op_inventory(
            model.config, batch, frames=jts.conv_output_length(
                audio_length, model.config.conv_stride)), "activation"),
        (jts.tensor_inventory_from_tree(out, "output"), "output"),
        (jts.tensor_inventory_from_tree(params, "gradient"), "gradient"),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_inventories_equal_jax(dtype):
    """Every static row of a whisper step: the activation census name for
    name, shape for shape, dtype for dtype (29 rows at this size, 10 of
    them layers the port runs through functions), and the other four."""
    model, params = _jax_whisper(dtype)
    want = _jax_whisper_inventories(model, params, 2, SEQ_LEN)
    got = jobs.whisper_inventories(
        WhisperConfig(**WHISPER_TINY, compute_dtype=dtype), 2, SEQ_LEN)
    assert [t for _, t in got] == [t for _, t in want]
    for (g, kind), (w, _) in zip(got, want):
        assert g == w, kind
    assert len(got[1][0]) == 29


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wav2vec2_inventories_equal_jax(dtype):
    """As above for a wav2vec2 pretraining step (58 activation rows: the
    feature projection's dropout is a record point, the quantizer's
    argmin indices, a port-only output, are left out).  Rates 0: at a
    nonzero rate JAX's census on the CPU also holds the ``Dropout_<k>``
    modules of module_dropout's CPU fallback, which its TPU path (the
    fused kernel) and the port (the kernel on the card) do not have."""
    model, params = _jax_wav2vec2(dtype)
    want = _jax_wav2vec2_inventories(model, params, 2, AUDIO)
    got = jobs.wav2vec2_inventories(
        Wav2Vec2Config(**W2V_TINY, **NO_DROPOUT["wav2vec2"],
                       compute_dtype=dtype), 2, AUDIO)
    for (g, kind), (w, _) in zip(got, want):
        assert g == w, kind
    assert len(got[1][0]) == 58


def test_parameter_rows_equal_jax():
    """log_model_parameters: the param rows of JAX's profiler, in its
    order, from the port's model."""
    jmodel, params = _jax_wav2vec2("float32")
    want = jts.tensor_inventory_from_tree(params, "param")
    model = w2v.Wav2Vec2ForPreTraining(Wav2Vec2Config(**W2V_TINY))
    got = tensorsize.tensor_inventory(tensorsize.parameter_tree(model),
                                      "param")
    assert got == want


def test_whisper_small_full_width_census_bytes_equal_jax():
    """whisper-small at full width, B 1, Te 1500, Td 100, f32: the
    shape-only censuses (activations + intra-op) of both packages give the
    same bytes; the port's model holds fake tensors only."""
    model, cfg = jax_whisper("small")
    b, te, td = 1, 1500, 100
    params = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        jnp.zeros((1, cfg.n_mels, 64)), labels=jnp.zeros((1, td), jnp.int32),
        deterministic=True)["params"])
    feats = jax.ShapeDtypeStruct((b, cfg.n_mels, 2 * te), jnp.float32)
    labs = jax.ShapeDtypeStruct((b, td), jnp.int32)
    want = (jts.intermediate_inventory(model, params, feats, labels=labs,
                                       deterministic=True)
            + jts.whisper_intra_op_inventory(cfg, b, enc_len=te, dec_len=td))

    config = WhisperConfig.from_size("small")
    spec = tensorsize.TensorSpec
    args = (spec((b, config.n_mels, 2 * te), torch.float32),)
    kwargs = dict(labels=spec((b, td), torch.int32))
    got = (tensorsize.intermediate_inventory(
        WhisperForConditionalGeneration, config, *args, **kwargs)
        + tensorsize.whisper_intra_op_inventory(config, b, enc_len=te,
                                                dec_len=td))
    assert sum(r[3] for r in got) == sum(r[3] for r in want)
    assert sorted(got) == sorted(want)
    fake, _, _, _ = tensorsize._fake_forward(
        WhisperForConditionalGeneration, config, args, kwargs, False)
    from torch._subclasses.fake_tensor import FakeTensor

    assert all(isinstance(p, FakeTensor) for p in fake.parameters())
    # The census leaves no fake tensor behind: a real forward still runs.
    real = WhisperForConditionalGeneration(
        WhisperConfig(**WHISPER_TINY)).eval()
    out = real(torch.zeros(1, 8, 16), labels=torch.zeros(1, 4,
                                                          dtype=torch.int32))
    assert torch.isfinite(out["loss"])


@pytest.mark.parametrize("kind", ["pretraining", "asr", "classification"])
def test_flax_from_state_dict_inverts_params_from_flax(kind):
    """params_from_flax(flax_from_state_dict(sd)) == sd, and the inverse of
    a JAX params tree is that tree, leaf for leaf."""
    model, cfg = jax_w2v.create_full_model(kind, "small", **W2V_TINY)
    params = jax.device_get(jax_jobs._init_wav2vec2(
        model, cfg, jax.random.PRNGKey(0), kind))
    sd = convert.params_from_flax(params)
    back = convert.params_from_flax(convert.flax_from_state_dict(sd))
    assert back.keys() == sd.keys()
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    want = jax.tree_util.tree_flatten_with_path(params)[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        convert.flax_from_state_dict(sd))[0])
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], leaf)


def test_flax_from_state_dict_whisper():
    model, params = _jax_whisper("float32")
    params = jax.device_get(params)
    sd = convert.params_from_flax(params)
    tree = convert.flax_from_state_dict(sd)
    assert np.array_equal(tree["lm_head"]["kernel"],
                          params["lm_head"]["kernel"])
    assert np.array_equal(
        tree["model"]["decoder"]["embed_tokens"]["embedding"],
        params["model"]["decoder"]["embed_tokens"]["embedding"])
    back = convert.params_from_flax(tree)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert convert.flax_path("model.encoder.conv2.weight", 3) == (
        "model", "encoder", "conv2", "kernel")
    assert convert.flax_shape("lm_head.weight", (128, 32)) == (32, 128)


@pytest.mark.parametrize("shape,offset", [((3,), 0.0), ((5000,), 0.0),
                                          ((64, 129), 3.0), ((9000,), -40.0)])
def test_value_skewness_matches_jax(shape, offset):
    """value_skewness and the batched tree_value_skewness against JAX's
    value_skewness, one tensor alone and among others (sizes below, at and
    above the 4096-element chunk; a mean far from 0)."""
    rng = np.random.default_rng(7)
    x = (rng.exponential(size=shape) + offset).astype(np.float32)
    want = float(jts.value_skewness(jnp.asarray(x)))
    np.testing.assert_allclose(
        tensorsize.value_skewness(torch.from_numpy(x)).item(), want,
        atol=SKEW_ATOL)
    others = {f"o{i}": torch.from_numpy(
        rng.standard_normal(n).astype(np.float32)) for i, n in
        enumerate((1, 4096, 10, 4097))}
    tree = {"a": others["o0"], "x": torch.from_numpy(x), **others}
    got = tensorsize.tree_value_skewness(tree, "p")
    assert list(got) == ["p/x", "p/o1", "p/o2", "p/o3"]   # o0: one element
    np.testing.assert_allclose(got["p/x"].item(), want, atol=SKEW_ATOL)
    for name in ("o1", "o2", "o3"):
        np.testing.assert_allclose(
            got[f"p/{name}"].item(),
            float(jts.value_skewness(jnp.asarray(others[name].numpy()))),
            atol=SKEW_ATOL)


def test_loop_hands_each_step_its_own_aux(capsys):
    """The hooks get (step, loss, duration, aux): step i's aux, fetched with
    its loss after step i + 1 was dispatched, scalars as floats (keys
    sorted), larger tensors as they are; a failing step calls no hook (the
    resilient loop then restarts the data, and the step counter stays)."""
    seen, calls = [], []

    def step_fn(state, batch, generator):
        calls.append(batch)
        if len(calls) == 3:
            raise RuntimeError("the third dispatch fails")
        aux = {"z": torch.tensor(float(batch)),
               "grad_aux": {"b": torch.tensor(batch + 0.5),
                            "a": torch.tensor([batch, batch],
                                              dtype=torch.float32)}}
        return state, torch.tensor(10.0 * batch), aux

    loop.run_training(step_fn, range(1, 10), None, seed=0, max_iterations=5,
                      resilient=True,
                      step_hooks=(lambda *args: seen.append(args),))
    assert calls == [1, 2, 3, 1, 2]
    assert [s[0] for s in seen] == [0, 1, 2, 3]
    for (step, loss, _, aux), batch in zip(seen, [1, 2, 1, 2]):
        assert loss == 10.0 * batch
        assert list(aux) == ["grad_aux", "z"] and aux["z"] == float(batch)
        assert list(aux["grad_aux"]) == ["a", "b"]
        assert aux["grad_aux"]["b"] == batch + 0.5
        assert torch.equal(aux["grad_aux"]["a"], torch.tensor(
            [batch, batch], dtype=torch.float32))
    assert "Error at step 2: the third dispatch fails" in (
        capsys.readouterr().out)


def _files(log_dir):
    out = {}
    for name in os.listdir(log_dir):
        with open(os.path.join(log_dir, name)) as fh:
            out[name] = fh.read()
    return out


def _compare_logs(got_dir, want_dir):
    got, want = _files(got_dir), _files(want_dir)
    assert sorted(got) == sorted(want)
    for name in IDENTICAL:
        assert got[name] == want[name], name
    skews = {}
    for name in ("skewness_analysis.json", "final_summary.json"):
        g, w = json.loads(got[name]), json.loads(want[name])
        for field in MEMORY_FIELDS:
            g.pop(field, None), w.pop(field, None)
        analysis = (g, w) if name.startswith("skewness") else (
            g["skewness_analysis"], w["skewness_analysis"])
        gv = analysis[0].pop("value_skewness", None)
        wv = analysis[1].pop("value_skewness", None)
        assert g == w, name
        assert (gv is None) == (wv is None), name
        if gv is not None:
            assert list(gv) == list(wv)
            skews = (gv, wv)
    return skews


def _run_both(tmp_path, monkeypatch, family):
    """Two profiled steps of the family's job on both packages; returns
    (port log dir, JAX log dir)."""
    monkeypatch.setenv("TETHYS_MONITOR", "0")
    dirs = {pkg: str(tmp_path / pkg) for pkg in ("jax", "torch")}
    overrides = {**(WHISPER_TINY if family == "whisper" else W2V_TINY),
                 **NO_DROPOUT[family]}
    flavor = "whisper" if family == "whisper" else "wav2vec2"
    init = (jax_jobs, "_init_whisper" if family == "whisper"
            else "_init_wav2vec2")
    captured = {}
    real_init = getattr(*init)

    def keep(*args, **kwargs):
        captured["params"] = jax.device_get(real_init(*args, **kwargs))
        return captured["params"]

    monkeypatch.setattr(*init, keep)
    common = dict(batch_size_per_replica=2, num_batches=STEPS,
                  checkpointing=False, config_overrides=overrides)
    if family == "whisper":
        prof = jts.TensorProfiler(log_dir=dirs["jax"], flavor=flavor)
        jax_jobs.train_whisper(mesh=make_data_mesh(1), data_seq_len=SEQ_LEN,
                               profiler=prof, **common)
    else:
        cfg = Wav2Vec2Config(**overrides)
        frames = cfg.downsampled_length(AUDIO)
        neg = np.random.default_rng(9).integers(
            0, frames, size=(2, cfg.num_negatives)).astype(np.int32)
        monkeypatch.setattr(jax_losses, "sample_negative_indices",
                            lambda rng, b, t, k: jnp.asarray(neg)[:, None, :])
        monkeypatch.setattr(jobs.losses, "sample_negative_indices",
                            lambda *a: torch.from_numpy(neg).long())
        prof = jts.TensorProfiler(log_dir=dirs["jax"], flavor=flavor)
        jax_jobs.train_wav2vec2(model_type="pretraining", mesh=make_data_mesh(1),
                                audio_length=AUDIO, profiler=prof, **common)
    prof.save_final_results()
    prof.close()

    sd = convert.params_from_flax(captured["params"])
    if family == "whisper":
        real = jobs.create_whisper_model

        def create(*args, **kwargs):
            model, config = real(*args, **kwargs)
            model.load_state_dict(sd)
            return model, config

        monkeypatch.setattr(jobs, "create_whisper_model", create)
        prof = tensorsize.TensorProfiler(log_dir=dirs["torch"], flavor=flavor)
        jobs.train_whisper(device="cpu", data_seq_len=SEQ_LEN, profiler=prof,
                           **common)
    else:
        real = w2v.create_full_model

        def create(*args, **kwargs):
            model, config = real(*args, **kwargs)
            model.load_state_dict(sd)
            return model, config

        monkeypatch.setattr(w2v, "create_full_model", create)
        prof = tensorsize.TensorProfiler(log_dir=dirs["torch"], flavor=flavor)
        jobs.train_wav2vec2(model_type="pretraining", device="cpu",
                            audio_length=AUDIO, profiler=prof, **common)
    prof.save_final_results()
    prof.close()
    return dirs["torch"], dirs["jax"]


def test_profiled_whisper_job_writes_the_jax_files(tmp_path, monkeypatch):
    got, want = _run_both(tmp_path, monkeypatch, "whisper")
    assert _compare_logs(got, want) == {}
    with open(os.path.join(got, "tiresias_tensorsize.txt")) as fh:
        assert fh.read().splitlines()[0] == "step,tensorsize_mb"


def test_profiled_wav2vec2_job_writes_the_jax_files_and_skews(
        tmp_path, monkeypatch):
    """Byte-identical files, and every value skew (input, logits, 60
    gradients) within SKEW_ATOL of JAX's."""
    got, want = _run_both(tmp_path, monkeypatch, "wav2vec2")
    gv, wv = _compare_logs(got, want)
    assert len(gv) == 2 + sum(1 for n, p in w2v.Wav2Vec2ForPreTraining(
        Wav2Vec2Config(**W2V_TINY)).named_parameters() if p.numel() > 1)
    for name, value in wv.items():
        np.testing.assert_allclose(gv[name], value, atol=SKEW_ATOL,
                                   err_msg=name)
    assert gv["gradient/wav2vec2/quantizer/codevectors"] == 0.0


@pytest.mark.parametrize("module", [whisper_dist_tensorsize,
                                    wav2vec2_dist_tensorsize])
def test_clis_need_a_card_unless_asked_for_the_cpu(module):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--num_batches", "1"])
    args = module.build_parser().parse_args(["--log_tensor_freq", "5"])
    assert args.log_tensor_freq == 5 and args.device == "cuda"
    with pytest.raises(SystemExit):
        from tethys_tpu_torch.jobs import _common

        _common.parse(module.build_parser(), ["--tp", "2"])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("family", ["whisper", "wav2vec2"])
def test_tensorsize_cli_chief_and_worker(tmp_path, family):
    """python -m tethys_tpu_torch.jobs.<family>_dist_tensorsize --device cpu
    as a chief and a worker from TF_CONFIG, each in its own workspace:
    both in one gloo group with the same losses, every profiler file in
    each workspace, the /result copies, JCT and collective report of
    each."""
    result = tmp_path / "result"
    (result / "run1").mkdir(parents=True)
    cluster = {"chief": [f"127.0.0.1:{_free_port()}"],
               "worker": [f"127.0.0.1:{_free_port()}"]}
    tasks = [("chief", 0), ("worker", 0)]
    procs = []
    flags = ["--batch_size", "2", "--num_batches", str(STEPS), "--device",
             "cpu"] + (["--model_size", "tiny"] if family == "wav2vec2" else [])
    for task, index in tasks:
        ws = tmp_path / f"ws_{task}"
        ws.mkdir()
        (ws / "model.txt").write_text("run1")
        env = {k: v for k, v in os.environ.items()
               if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR",
                            "MASTER_PORT", "LOCAL_RANK")}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   GLOO_SOCKET_IFNAME="lo", TETHYS_WORKSPACE=str(ws),
                   TETHYS_RESULT=str(result), TF_CONFIG=json.dumps(
                       {"cluster": cluster,
                        "task": {"type": task, "index": index}}))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, family, *flags], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n----\n".join(outs)
    log_dir = "tensor_logs" if family == "whisper" else "tensor_logs_tiny"
    for r, ((task, _), out) in enumerate(zip(tasks, outs)):
        assert f"process group: gloo, rank {r} of 2" in out.splitlines()
        assert "global batch size: 4" in out
        assert "Tiresias TensorSize:" in out
        assert ("Weighted average value skewness:" in out) == (
            family == "wav2vec2")
        names = set(os.listdir(tmp_path / f"ws_{task}" / log_dir))
        assert names == {"tensor_sizes.txt", "memory_usage.txt",
                         "summary.txt", "tiresias_tensorsize.txt",
                         "skewness_analysis.txt", "skewness_analysis.json",
                         "final_summary.json", "tiresias_result.json",
                         "legacy_skewness_result.txt"}
    losses = [[line for line in out.splitlines() if line.startswith("Step ")]
              for out in outs]
    assert [l.split(", Time")[0] for l in losses[0]] == [
        l.split(", Time")[0] for l in losses[1]]
    assert sorted(os.listdir(result / "run1")) == sorted(
        f"{task}_{index}_{kind}.txt" for task, index in tasks
        for kind in ("collectives", "jct", "tensor_summary", "tiresias",
                     "skewness", "combined"))
