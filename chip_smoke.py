#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tethys_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero):

1. device: no CUDA device -> exit 1 before anything else; print the card's
   name and power limit as nvidia-smi reports them;
2. build the kernel library from tethys_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving path, f32 and bf16, with CUDA-event times (median of 30);
4. whisper-base in f32 (random weights from seed 0) serves 2 requests of
   30 s seeded audio on the card; the same model and inputs run on the CPU,
   where every kernel's plain version runs; greedy tokens and length must
   be identical and the encoder outputs close;
5. whisper-base in bf16 at the serving bench's shape (batch 16, 128 decode
   steps): encode ms, decode tokens/s, per-token latency;
6. every kernel's launch count must have risen during phases 4-5.

The last three lines of stdout are the card's name and power limit, the
kernel table {"kernels": [...]} and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
MODEL = "base"
SLICE_REQUESTS = 2
SLICE_STEPS = 32
BENCH_BATCH = 16
BENCH_STEPS = 128
TIMING_REPS = 30
SAMPLE_RATE = 16000


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, reps: int = TIMING_REPS) -> float:
    """Median over reps of one call's device time, by CUDA events.  Each
    call is queued behind a ~0.5 ms device spin, so the host has enqueued
    the whole call before the device reaches it and the events time the
    device work, not the host's launch overhead."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Median host time of a call that ends in a device synchronise."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def require(cond, msg: str) -> None:
    """A check that stays under python -O (unlike assert)."""
    if not cond:
        raise AssertionError(msg)


def check(name: str, err: float, tol: float) -> float:
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def check_kernels(results: dict) -> None:
    """Phase 3: every kernel against its plain version, on the card."""
    from tethys_tpu_torch.audio import logmel
    from tethys_tpu_torch.audio.frontend import frame_signal
    from tethys_tpu_torch.ops import decode, flash_attention, transpose
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, errs, ms, plain_ms):
        results[name] = {"max_abs_err": max(errs), "ms": ms,
                         "plain_ms": plain_ms}
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # log-mel: 4 requests of 30 s -> 2998 frames each, 80 mels (f32 only).
    wave = randn(4, SAMPLE_RATE * 30)
    frames = frame_signal(wave, 400, 160).contiguous()
    mats = logmel._device_matrices(400, 80, SAMPLE_RATE, dev)
    got = logmel.log_mel_cuda(frames, *mats)
    want = logmel.plain_log_mel(frames, *mats)
    require(got.shape == (4, 2998, 80), f"log_mel shape {tuple(got.shape)}")
    errs = [check("log_mel f32 [4, 2998, 400] -> 80", max_err(got, want),
                  1e-3)]
    record("log_mel", errs, event_ms(lambda: logmel.log_mel_cuda(frames, *mats)),
           event_ms(lambda: logmel.plain_log_mel(frames, *mats)))

    # split_heads: [4, T, 8*64] for the encoder (T=1500) and a decode step.
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for t in (1500, 1):
            x = randn(4, t, 512, dtype=dtype)
            got = transpose.split_heads_cuda(x, 8)
            errs.append(check(f"split_heads {dtype} T={t}",
                              max_err(got, transpose.plain_split_heads(x, 8)),
                              0.0))
    x = randn(4, 1500, 512, dtype=torch.bfloat16)
    record("split_heads", errs,
           event_ms(lambda: transpose.split_heads_cuda(x, 8)),
           event_ms(lambda: transpose.plain_split_heads(x, 8)))

    # flash forward: B*H = 32 at T = 1500, and keys padded to 1536 with
    # kv_len = 1500.  f32: two f32 summation orders; bf16: the kernel rounds
    # the unnormalised probabilities, the plain version the same, so only
    # the sums' order differs, but the output itself is bf16.
    errs = []
    for dtype, tol_o in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        for tk, kv_len in ((1500, 1500), (1536, 1500)):
            q = randn(32, 1500, 64, dtype=dtype, scale=0.3)
            k = randn(32, tk, 64, dtype=dtype, scale=0.3)
            v = randn(32, tk, 64, dtype=dtype)
            o, lse = flash_attention.flash_fwd_cuda(q, k, v, kv_len)
            o_ref, lse_ref = flash_attention.plain_flash_fwd(q, k, v, kv_len)
            errs.append(check(f"flash o {dtype} Tk={tk} kv_len={kv_len}",
                              max_err(o, o_ref), tol_o))
            errs.append(check(f"flash lse {dtype} Tk={tk} kv_len={kv_len}",
                              max_err(lse, lse_ref), 1e-4))
    q = randn(32, 1500, 64, dtype=torch.bfloat16, scale=0.3)
    k = randn(32, 1500, 64, dtype=torch.bfloat16, scale=0.3)
    v = randn(32, 1500, 64, dtype=torch.bfloat16)
    record("flash_fwd", errs,
           event_ms(lambda: flash_attention.flash_fwd_cuda(q, k, v, 1500)),
           event_ms(lambda: flash_attention.plain_flash_fwd(q, k, v, 1500)))

    # decode self-attention: B=16, H=8, D=64, T_max=128; caches exact.
    errs = []
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2e-2)):
        for idx in (0, 57, 127):
            q = randn(16, 8, 1, 64, dtype=dtype, scale=0.125)
            kn, vn = randn(16, 8, 1, 64, dtype=dtype), randn(16, 8, 1, 64, dtype=dtype)
            filled = torch.arange(128, device=dev) < idx
            kb = torch.where(filled, randn(16, 8, 64, 128), 0.0).to(dtype)
            vb = torch.where(filled, randn(16, 8, 64, 128), 0.0).to(dtype)
            kb2, vb2 = kb.clone(), vb.clone()
            out, _, _ = decode.decode_self_cuda(q, kn, vn, kb, vb, idx)
            ref, _, _ = decode.plain_decode_self_attention(q, kn, vn, kb2, vb2,
                                                           idx)
            errs.append(check(f"decode caches {dtype} idx={idx}",
                              max(max_err(kb, kb2), max_err(vb, vb2)), 0.0))
            errs.append(check(f"decode out {dtype} idx={idx}",
                              max_err(out, ref), tol))
    q = randn(16, 8, 1, 64, dtype=torch.bfloat16, scale=0.125)
    kn, vn = randn(16, 8, 1, 64, dtype=torch.bfloat16), randn(16, 8, 1, 64, dtype=torch.bfloat16)
    kb, vb = randn(16, 8, 64, 128, dtype=torch.bfloat16), randn(16, 8, 64, 128, dtype=torch.bfloat16)
    record("decode_self", errs,
           event_ms(lambda: decode.decode_self_cuda(q, kn, vn, kb, vb, 127)),
           event_ms(lambda: decode.plain_decode_self_attention(
               q, kn, vn, kb, vb, 127)))


def seeded_audio(batch: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, SAMPLE_RATE * 30)).astype(np.float32)


def run_slice_f32() -> None:
    """Phase 4: f32 serving on the card against the same run on the CPU."""
    from tethys_tpu_torch.audio.frontend import prepare_input_features
    from tethys_tpu_torch.inference import transcribe_batch
    from tethys_tpu_torch.models.whisper import create_whisper_model
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    model, cfg = create_whisper_model(MODEL, device=dev, seed=SEED)
    audio = seeded_audio(SLICE_REQUESTS, SEED)
    t0 = time.perf_counter()
    ids_gpu = transcribe_batch(model, audio, max_length=SLICE_STEPS)
    torch.cuda.synchronize()
    log(f"  f32 card: {SLICE_REQUESTS} requests served in "
        f"{time.perf_counter() - t0:.2f} s (first call), ids {ids_gpu.shape}")

    cpu_model = copy.deepcopy(model).cpu()
    t0 = time.perf_counter()
    ids_cpu = transcribe_batch(cpu_model, audio, max_length=SLICE_STEPS)
    log(f"  f32 cpu: served in {time.perf_counter() - t0:.2f} s")
    log(f"  tokens card {ids_gpu.tolist()}")
    require(ids_gpu.shape == ids_cpu.shape and (ids_gpu == ids_cpu).all(),
            f"greedy tokens differ: card {ids_gpu.tolist()} vs cpu "
            f"{ids_cpu.tolist()}")
    require(((0 <= ids_gpu) & (ids_gpu < cfg.vocab_size)).all(),
            "token ids outside the vocabulary")

    with torch.inference_mode():
        wav = torch.from_numpy(audio)
        feats_gpu = prepare_input_features(wav.to(dev), n_frames=3000)
        feats_cpu = prepare_input_features(wav, n_frames=3000)
        check("features card vs cpu", max_err(feats_gpu.cpu(), feats_cpu), 1e-3)
        enc_gpu = model.encode(feats_gpu).cpu()
        enc_cpu = cpu_model.encode(feats_cpu)
    require(enc_gpu.shape == (SLICE_REQUESTS, 1500, cfg.d_model),
            f"encoder output shape {tuple(enc_gpu.shape)}")
    require(bool(torch.isfinite(enc_gpu).all()), "encoder output not finite")
    check("encoder output card vs cpu", max_err(enc_gpu, enc_cpu), 2e-3)
    log(f"  f32 slice: greedy tokens and length identical on card and cpu "
        f"(length {ids_gpu.shape[1]})")


def run_slice_bf16(gpu: str) -> dict:
    """Phase 5: bf16 at the serving bench's shape."""
    from tethys_tpu_torch.audio.frontend import prepare_input_features
    from tethys_tpu_torch.models.whisper import (
        create_whisper_model,
        greedy_generate,
    )
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    model, cfg = create_whisper_model(MODEL, device=dev, seed=SEED,
                                      compute_dtype="bfloat16")
    wav = torch.from_numpy(seeded_audio(BENCH_BATCH, SEED + 1)).to(dev)
    with torch.inference_mode():
        feats = prepare_input_features(wav, n_frames=3000)
        tokens, length = greedy_generate(model, feats, max_length=BENCH_STEPS)
        n = int(length) - 1
        require(tokens.shape == (BENCH_BATCH, BENCH_STEPS + 1),
                f"tokens shape {tuple(tokens.shape)}")
        require(bool(((tokens >= 0) & (tokens < cfg.vocab_size)).all()),
                "token ids outside the vocabulary")
        frontend_ms = wall_ms(
            lambda: prepare_input_features(wav, n_frames=3000), 5)
        encode_ms = wall_ms(lambda: model.encode(feats), 5)
        total_ms = wall_ms(
            lambda: greedy_generate(model, feats, max_length=BENCH_STEPS), 3)
    decode_ms = total_ms - encode_ms
    stats = {
        "batch": BENCH_BATCH, "decode_steps": BENCH_STEPS, "greedy_len": n,
        "frontend_ms": frontend_ms, "encode_ms": encode_ms,
        "generate_ms": total_ms,
        "decode_tokens_per_s": BENCH_STEPS * BENCH_BATCH / (decode_ms / 1e3),
        "per_token_ms": decode_ms / BENCH_STEPS,
        "rtf_e2e": 30.0 * BENCH_BATCH / ((frontend_ms + total_ms) / 1e3),
        "gpu": gpu,
    }
    log(f"  bf16 whisper-{MODEL} b{BENCH_BATCH} on {gpu}: frontend "
        f"{frontend_ms:.2f} ms, encode {encode_ms:.2f} ms, generate "
        f"{total_ms:.2f} ms ({BENCH_STEPS} steps), decode "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s, "
        f"{stats['per_token_ms']:.4f} ms/token")
    log("  serving " + json.dumps(stats))
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    gpu = gpu_name_and_power()
    log(gpu)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tethys_tpu_torch.utils import kernel_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    kernel_lib.library()
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {kernel_lib.build_seconds} s)")
    for line in kernel_lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("    " + line.strip())

    log("[3] kernels against their plain versions on the card")
    results = {}
    check_kernels(results)
    torch.cuda.synchronize()

    kernel_lib.reset_launch_counts()
    log("[4] whisper-base f32 slice, card against cpu")
    run_slice_f32()
    log("[5] whisper-base bf16 serving")
    run_slice_bf16(gpu)
    torch.cuda.synchronize()
    counts = kernel_lib.launch_counts()
    log(f"[6] launches during the slice: {counts}")
    missing = [name for name, n in counts.items() if n == 0]
    require(not missing, f"kernels never launched on the main path: {missing}")

    log(gpu)
    log(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": counts[k.name],
         **results[k.name]} for k in kernel_lib.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
