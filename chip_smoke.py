#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (tethys_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then nonzero):

1. device: no CUDA device -> exit 1 before anything else; print the card's
   name and power limit as nvidia-smi reports them;
2. build the kernel library from tethys_tpu_torch/csrc with nvcc;
3. each kernel against its plain PyTorch version on the card, at the shapes
   of the serving and the two training paths, f32 and bf16, with CUDA-event
   times (median of 30), its bound (the larger of the bytes it must move
   over 3.35 TB/s and its operations over the card's peak for their type)
   and, where one PyTorch call computes the same function, that call's time;
   the fused projections also at a decode step, each with the route of
   csrc/qkv_proj.cu it must take (wgmma at the encoder's shapes, weight
   streaming at a decode step, FFMA in f32); the two decode-step attention
   kernels (decode_self, q8_cross) must give the same bits from two
   launches on the same inputs, log the thread-block cluster size each
   shape takes, and log rows at T_max 448 (idx 447 and 63, hot and cold)
   and at whisper-large-v3's B 4 x H 20, beside the timing floor (one
   one-element add_ under the same method); log_mel, framed in the
   kernel, at 4 and 16 x 30 s with 80 mels and 4 x 30 s with 128, beside
   the same kernel given contiguous frames, the rfft path and the bound of
   its three TF32 passes (the f32 FFMA bound in the note); split_heads at
   [16, 1500, 512] and [4, 1500, 512] and, at a decode step [16, 1, 512],
   the main path's call (a view, no launch) beside split_heads_cuda;
   dropout beside F.dropout; and Wav2Vec2's GroupNorm at its seven inputs
   [32, T, 512] (and a 5 s clip's T = 250), f32 and bf16: the moments
   (gn_stats), apply, grad sums and apply_bwd kernels each against its
   plain version, the forward and the backward beside F.group_norm and
   its autograd backward, the gn_stats launch against the occupancy it
   reports (at most one wave), two launches bitwise equal, and the
   moments' time by cluster size;
4. serving: whisper-base in f32 (random weights from seed 0) serves 2
   requests of 30 s seeded audio on the card; the same model and inputs
   run on the CPU, where every kernel's plain version runs; greedy tokens
   and length must be identical and the encoder outputs close;
5. serving: whisper-base in bf16 at the serving bench's shape (batch 16,
   128 decode steps): encode ms, decode tokens/s, per-token latency; the
   launch counts, set to 0 around 4 decode steps after encode, must show no
   split_heads launch (the head splits at T = 1 are views);
6. training: whisper-base in f32 with every dropout rate 0 takes 2 Keras
   Adam steps on batches of 2 from the synthetic dataset, on the card and
   on the CPU; losses, first-step gradients and the parameters after step
   2 must agree, and every parameter must get a finite, nonzero gradient
   on the card;
7. training: the job's train_whisper at the bench's shape (whisper-base,
   batch 16, bf16 compute on f32 master weights, dropout on), 10 steps:
   ms per step, audio seconds per second, peak memory; every loss finite
   and the last 3 below the first on average;
8. Wav2Vec2 pretraining: wav2vec2-base in f32 with every dropout rate 0
   takes 2 hardened steps on batches of 2 two-second clips, on the card and
   on the CPU, with the same negatives; the quantizer's argmin indices are
   compared (a flip must be a tie), losses, first-step gradients and the
   parameters after step 2 must agree, every trainable parameter gets a
   finite gradient (nonzero but where it is zero up to rounding), and the
   codevectors and the quantizer's input projection none;
9. the job's train_wav2vec2 at the bench's shape (wav2vec2-base, batch 32,
   2 s clips, bf16 compute on f32 master weights, the config's dropout),
   10 steps: ms per step, audio seconds per second, peak memory; 10 finite
   losses, the last 3 below the first on average, no ``Error at step``
   line, the checkpoint and the JCT file written;
10. launch counts: set to 0 before each path (serving: phases 4-5,
   training: phases 6-7, wav2vec2: phases 8-9, long audio: phases 11-13,
   flash bench: phase 14, frontend: phase 15)
   and read after it; every kernel of a path must have launched during it,
   and on the wav2vec2 path gn_apply as often as gn_stats and gn_apply_bwd
   as often as gn_grad_sums;
11. int8 long-audio serving: whisper-base in f32 with kv_quant="int8" and
   TETHYS_FUSED_QKV=1 (this phase only) transcribes 70 s of seeded audio
   (3 windows in a batch of 4) on the card and on the CPU; features,
   encoder outputs, int8 caches and scales, and per-window tokens are
   compared (a token may differ only at a near-tie of the CPU's logits);
   the projections' route counts start at 0 and f32 must take FFMA;
12. whisper-large-v3 in bf16 (random weights, 128 mels) with int8 caches
   and the default projections transcribes 100 s of seeded audio (4
   windows, 64 steps): frontend, encode and generate ms, decode tokens/s,
   rtf_e2e, peak memory;
13. the serving bench's twin (python -m tethys_tpu_torch.scripts.
   bench_generate) at whisper-base b16 bf16, 128 steps: --kv_quant int8,
   none, and int8 with TETHYS_FUSED_QKV=1 (whose encode ms is logged
   beside the unfused int8 run's, and which must launch both the wgmma and
   the weight-streaming route), then --host_chunk 32 --force_eos, which
   must stop after one chunk;
14. the flash-kernel bench's twin (python -m tethys_tpu_torch.scripts.
   bench_flash) at its defaults (B*H 128, keys padded to 1536, kv_len 1500,
   rate 0.1, bf16, 50 launches each way), then at B*H 16 and Tk 2560 (the
   TPU's several-KV-block backward) at rates 0.1 and 0: ms per call of the
   forward and the backward; the backward must launch at Tk 2560;
15. the frontend bench's twin (python -m tethys_tpu_torch.scripts.
   bench_frontend) at its defaults (16 x 30 s, 20 calls): the fused
   log-mel, framing included, must be faster than the rfft path.

The last three lines of stdout are the card's name and power limit, the
kernel table {"kernels": [...]} and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
MODEL = "base"
SLICE_REQUESTS = 2
SLICE_STEPS = 32
BENCH_BATCH = 16
BENCH_STEPS = 128
TIMING_REPS = 30
SAMPLE_RATE = 16000
DROPOUT_RATE = 0.1      # the JAX config's dropout and attention_dropout
TRAIN_F32_BATCH = 2
TRAIN_F32_STEPS = 2
TRAIN_BATCH = 16
TRAIN_STEPS = 10
TRAIN_WARMUP = 2
AUDIO_SECONDS = 30.0    # per sample: 3000 mel frames
W2V_MODEL = "base"
W2V_F32_BATCH = 2
W2V_F32_STEPS = 2
W2V_BATCH = 32          # bench.py's wav2vec2-base pretraining shape
W2V_STEPS = 10
W2V_SAMPLES = 32000     # 2 s clips: T = 6400, 3200, ..., 100 after the convs
W2V_LR = 3e-5
# wav2vec2-base's GroupNorm inputs at 2 s clips: [32, T, 512] after each conv.
GN_T = (6400, 3200, 1600, 800, 400, 200, 100)
# The kernels each path must launch.
PATH_KERNELS = {
    "serving": ("log_mel", "split_heads", "flash_fwd", "decode_self"),
    "training": ("split_heads", "merge_heads", "flash_fwd",
                 "flash_fwd_dropout", "flash_bwd", "dropout"),
    "wav2vec2": ("gn_stats", "gn_grad_sums", "gn_apply", "gn_apply_bwd",
                 "dropout"),
    "long_audio": ("log_mel", "split_heads", "flash_fwd", "decode_self",
                   "q8_cross", "proj_split", "merge_proj"),
    "flash_bench": ("flash_fwd", "flash_fwd_dropout", "flash_bwd"),
    "frontend": ("log_mel",),
}
LONG_F32_SECONDS = 70       # 3 windows, padded to a batch of 4
LONG_F32_STEPS = 32
LONG_V3_SECONDS = 100       # 4 windows
LONG_V3_STEPS = 64
# H100 SXM peaks (NVIDIA's data sheet, dense): HBM3 bytes/s and FLOP/s by
# the type of the operands.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# The bf16 flash outputs' largest difference from the plain version, over
# the plain version's largest magnitude: bf16 rounding on either side is at
# most one step, 2^-7 of the largest value; a 10% scale error reads 0.1 and
# another dropout mask more (phase 3 shows the limit sees both).
BF16_REL_LIMIT = 0.025


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(fn, reps: int = TIMING_REPS, cold: bool = False) -> float:
    """Median over reps of one call's device time, by CUDA events.  Each
    call is queued behind a ~0.5 ms device spin, so the host has enqueued
    the whole call before the device reaches it and the events time the
    device work, not the host's launch overhead.  ``cold``: a 64 MiB write
    before each call evicts the inputs from the 50 MB L2, as the other
    layers' work does on the path."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda") if cold else None
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        if flush is not None:
            flush.zero_()
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


def bound(bytes_moved: float, flops: float, kind: str):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of bytes over HBM bandwidth and operations over the peak."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, err: float, tol: float) -> float:
    log(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")
    return err


def rel_err(got, want) -> float:
    """max|got - want| / max|want|."""
    return max_err(got, want) / want.float().abs().max().item()


def check_rel(name: str, got, want, limit: float = BF16_REL_LIMIT) -> float:
    """A bf16 output against its plain version, relative to the plain
    version's largest magnitude, beside the absolute check."""
    rel = rel_err(got, want)
    log(f"  {name}: max_abs_err / max|ref| {rel:.3e} (limit {limit:g})")
    if not rel <= limit:
        raise AssertionError(f"{name}: relative error {rel} > {limit}")
    return rel


def check_flash(name: str, got, want, tol: float, dtype) -> float:
    """The absolute check, and in bf16 the relative one too."""
    err = check(name, max_err(got, want), tol)
    if dtype == torch.bfloat16:
        check_rel(name, got, want)
    return err


def check_kernels(results: dict) -> None:
    """Phase 3: every kernel against its plain version, on the card."""
    from tethys_tpu_torch.ops import decode, flash_attention
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def record(name, errs, ms, plain_ms, bytes_moved, flops, kind,
               library_ms=None):
        bound_ms, bound_by = bound(bytes_moved, flops, kind)
        results[name] = {"max_abs_err": max(errs), "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": library_ms}
        library = "none" if library_ms is None else f"{library_ms:.4f} ms"
        log(f"  {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), library {library}")

    check_log_mel(record, randn)
    check_split_heads(record, randn)

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
            errs.append(check_flash(f"flash o {dtype} Tk={tk} kv_len={kv_len}",
                                    o, o_ref, tol_o, dtype))
            errs.append(check(f"flash lse {dtype} Tk={tk} kv_len={kv_len}",
                              max_err(lse, lse_ref), 1e-4))
    q = randn(32, 1500, 64, dtype=torch.bfloat16, scale=0.3)
    k = randn(32, 1500, 64, dtype=torch.bfloat16, scale=0.3)
    v = randn(32, 1500, 64, dtype=torch.bfloat16)
    record("flash_fwd", errs,
           event_ms(lambda: flash_attention.flash_fwd_cuda(q, k, v, 1500)),
           event_ms(lambda: flash_attention.plain_flash_fwd(q, k, v, 1500)),
           4 * q.numel() * 2 + 32 * 1500 * 4, 4 * 32 * 1500 * 1500 * 64,
           "bf16", event_ms(lambda: sdpa(q, k, v)))

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
    def self_inputs(t_max, dtype=torch.bfloat16):
        return (randn(16, 8, 1, 64, dtype=dtype, scale=0.125),
                randn(16, 8, 1, 64, dtype=dtype), randn(16, 8, 1, 64, dtype=dtype),
                randn(16, 8, 64, t_max, dtype=dtype),
                randn(16, 8, 64, t_max, dtype=dtype))

    def self_bound(idx):
        # q, the new k and v, the output; idx cached columns of K and V read
        # and one written.
        return (4 * 16 * 8 * 64 * 2 + 2 * (idx + 1) * 16 * 8 * 64 * 2,
                4 * 16 * 8 * (idx + 1) * 64, "bf16")

    for dtype in (torch.float32, torch.bfloat16):
        for t_max, idx in ((128, 127), (448, 447)):
            check_repeatable(f"decode_self {dtype} T_max {t_max} idx {idx}",
                             decode.decode_self_cuda, self_inputs(t_max, dtype),
                             idx)
    q, kn, vn, kb, vb = self_inputs(128)
    log(f"  decode_self [16, 8, 64, 128] idx 127: cluster of "
        f"{decode.decode_self_cluster(128, 64, 127, torch.bfloat16)}")
    record("decode_self", errs,
           event_ms(lambda: decode.decode_self_cuda(q, kn, vn, kb, vb, 127)),
           event_ms(lambda: decode.plain_decode_self_attention(
               q, kn, vn, kb, vb, 127)),
           *self_bound(127))
    log_row("decode_self", "bf16 [16, 8, 64, 128] idx 127, cold",
            event_ms(lambda: decode.decode_self_cuda(q, kn, vn, kb, vb, 127),
                     cold=True), bound(*self_bound(127)))
    # The default max_target_positions, 448: the last step and an early one.
    q, kn, vn, kb, vb = self_inputs(448)
    for idx in (447, 63):
        fn = lambda: decode.decode_self_cuda(q, kn, vn, kb, vb, idx)
        shape = (f"bf16 [16, 8, 64, 448] idx {idx}, cluster of "
                 f"{decode.decode_self_cluster(128, 64, idx, torch.bfloat16)}")
        plain_ms = event_ms(lambda: decode.plain_decode_self_attention(
            q, kn, vn, kb, vb, idx))
        log_row("decode_self", shape + ", hot", event_ms(fn),
                bound(*self_bound(idx)), plain_ms)
        log_row("decode_self", shape + ", cold", event_ms(fn, cold=True),
                bound(*self_bound(idx)))
    # What the method reads for next to no work: the floor under the
    # decode-step rows.
    one = torch.zeros(1, device=dev)
    log(f"  timing floor: one-element add_ {event_ms(lambda: one.add_(1)):.4f} ms "
        f"hot, {event_ms(lambda: one.add_(1), cold=True):.4f} ms cold")
    check_training_kernels(record, randn)
    check_int8_kernels(record, randn)


def log_mel_work(rows: int, n_mels: int, samples: int):
    """(bytes, multiply-adds of the folded products, multiply-adds of the
    400-tap products) of the log-mel over ``rows`` frames, 201 bins, from
    ``samples`` audio samples.  Bytes: the waveform, the kernel's constant
    operands and the output, each once.  Multiply-adds: one per nonzero
    weight of the DFT matrices and of the mel filterbank a frame (the
    filters are bands: about 2 weights a bin, not n_mels); the kernel folds
    the taps by the window's symmetry (201, not 400)."""
    from tethys_tpu_torch.audio import logmel

    consts = logmel._kernel_operands(400, n_mels, SAMPLE_RATE,
                                     torch.device("cuda", 0))
    bytes_moved = 4 * (samples + rows * n_mels) + sum(
        c.numel() * c.element_size() for c in consts)
    mel = np.count_nonzero(logmel._mel_matrix(400, n_mels, SAMPLE_RATE))
    folded = sum(map(np.count_nonzero, logmel.folded_dft_matrices(400)))
    full = sum(map(np.count_nonzero, logmel.dft_matrices(400)))
    return bytes_moved, rows * (folded + mel), rows * (full + mel)


def check_log_mel(record, randn) -> None:
    """Phase 3, the log-mel kernel, framed in the kernel, at 4 and 16
    requests of 30 s (2998 frames each) with 80 mels and at 4 with
    whisper-large-v3's 128 mels, against plain_log_mel (exact f32 products
    on the contiguous frames) at atol 1e-3.  Each row logs the kernel given
    contiguous frames (the same kernel at hop = n_fft, the copy included),
    the rfft path (audio/frontend.extract_fbank_features), the bound of
    three TF32 passes of the folded products, counted by nonzero weights
    (log_mel_work), and, in the note, the bounds of the 400-tap products in
    3xTF32 and in f32 FFMA."""
    from tethys_tpu_torch.audio import frontend, logmel

    for batch, n_mels in ((4, 80), (16, 80), (4, 128)):
        wave = randn(batch, SAMPLE_RATE * 30)
        frames = frontend.frame_signal(wave, 400, 160).contiguous()
        mats = logmel._device_matrices(400, n_mels, SAMPLE_RATE, wave.device)

        def framed():
            return logmel.log_mel_cuda(wave, n_mels)

        def given():
            return logmel.log_mel_cuda(frames.view(-1), n_mels,
                                       hop_length=400)

        got, got_given = framed(), given()
        want = logmel.plain_log_mel(frames, *mats)
        name = f"log_mel f32 [{batch}, 2998, 400] -> {n_mels}"
        require(got.shape == (batch, 2998, n_mels), f"{name}: shape "
                f"{tuple(got.shape)}")
        err = check(name + " framed in the kernel", max_err(got, want), 1e-3)
        check(name + " given frames", max_err(got_given.view_as(want), want),
              1e-3)
        rows = batch * 2998
        bytes_moved, madds, madds_400 = log_mel_work(rows, n_mels,
                                                     wave.numel())
        ms = event_ms(framed)
        plain_ms = event_ms(lambda: logmel.plain_log_mel(frames, *mats))
        given_ms = event_ms(lambda: logmel.log_mel_cuda(
            frontend.frame_signal(wave, 400, 160).contiguous().view(-1),
            n_mels, hop_length=400))
        rfft_ms = event_ms(lambda: frontend.extract_fbank_features(
            wave, n_mels=n_mels))
        tf32 = bound(bytes_moved, 3 * 2 * madds, "tf32")
        tf32_400 = bound(bytes_moved, 3 * 2 * madds_400, "tf32")
        ffma = bound(bytes_moved, 2 * madds_400, "f32")
        log(f"  log_mel [{batch}, 2998] x {n_mels} mels: framed in the kernel "
            f"{ms:.4f} ms, given frames (with the copy) {given_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, rfft path {rfft_ms:.4f} ms; bound "
            f"{tf32[0]:.4f} ms ({tf32[1]}, 3 TF32 passes of the folded "
            f"products) = {100 * tf32[0] / ms:.1f}% reached; note: 3 TF32 "
            f"passes of the 400-tap products {tf32_400[0]:.4f} ms, the "
            f"400-tap products in f32 FFMA {ffma[0]:.4f} ms")
        if (batch, n_mels) == (4, 80):
            record("log_mel", [err], ms, plain_ms, bytes_moved, 3 * 2 * madds,
                   "tf32")
        del wave, frames, got, got_given, want


def check_split_heads(record, randn) -> None:
    """Phase 3, split_heads: the kernel (split_heads_cuda) bit for bit
    against the plain version in f32 and bf16 at the encoders' [4, 1500,
    512] and [16, 1500, 512] and at a decode step [16, 1, 512]; timed at
    [16, 1500, 512] bf16 (the serving and training encoders' shape) and
    [4, 1500, 512]; at the decode step the main path's call
    (transpose.split_heads, a view of x: no launch) beside the kernel."""
    from tethys_tpu_torch.ops import transpose
    from tethys_tpu_torch.utils import kernel_lib

    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for b, t in ((4, 1500), (16, 1500), (16, 1)):
            x = randn(b, t, 512, dtype=dtype)
            got = transpose.split_heads_cuda(x, 8)
            errs.append(check(f"split_heads {dtype} [{b}, {t}, 512]",
                              max_err(got, transpose.plain_split_heads(x, 8)),
                              0.0))

    def times(x):
        b, t, _ = x.shape
        return (event_ms(lambda: transpose.split_heads_cuda(x, 8)),
                bound(2 * x.numel() * 2, 0, "bf16"),
                event_ms(lambda: transpose.plain_split_heads(x, 8)),
                event_ms(lambda: x.view(b, t, 8, 64).permute(0, 2, 1, 3)
                         .contiguous()))

    x = randn(16, 1500, 512, dtype=torch.bfloat16)
    ms, _, plain_ms, library_ms = times(x)
    record("split_heads", errs, ms, plain_ms, 2 * x.numel() * 2, 0, "bf16",
           library_ms)
    log_row("split_heads", "bf16 [4, 1500, 512]",
            *times(randn(4, 1500, 512, dtype=torch.bfloat16)))
    # The shape of nearly all of its calls: a decode step, where the main
    # path's call is a view.
    x1 = randn(16, 1, 512, dtype=torch.bfloat16)
    before = kernel_lib.SPLIT_HEADS.launches
    view = transpose.split_heads(x1, 8)
    require(kernel_lib.SPLIT_HEADS.launches == before
            and view.untyped_storage().data_ptr()
            == x1.untyped_storage().data_ptr(),
            "split_heads at a decode step launched or copied")
    ms, bound_ms, plain_ms, library_ms = times(x1)
    log_row("split_heads", "bf16 decode step [16, 1, 512], split_heads_cuda",
            ms, bound_ms, plain_ms, library_ms)
    log(f"  split_heads bf16 decode step [16, 1, 512], transpose.split_heads "
        f"(the main path's call, a view): "
        f"{event_ms(lambda: transpose.split_heads(x1, 8)):.4f} ms")


def check_training_kernels(record, randn) -> None:
    """Phase 3, the training path's kernels at whisper-base b16's shapes:
    B*H = 128, encoder self-attention 1500 x 1500, cross-attention
    100 x 1500, D = 64."""
    from tethys_tpu_torch.ops import dropout, flash_attention, transpose

    f32, bf16 = torch.float32, torch.bfloat16
    seed, rate = 1234, DROPOUT_RATE

    # merge_heads (split_heads' backward): [16, 8, T, 64] -> [16, T, 512].
    errs = []
    for dtype in (f32, bf16):
        for t in (1500, 100):
            x = randn(16, 8, t, 64, dtype=dtype)
            errs.append(check(f"merge_heads {dtype} T={t}",
                              max_err(transpose.merge_heads_cuda(x),
                                      transpose.plain_merge_heads(x)), 0.0))
    x = randn(16, 8, 1500, 64, dtype=bf16)
    record("merge_heads", errs,
           event_ms(lambda: transpose.merge_heads_cuda(x)),
           event_ms(lambda: transpose.plain_merge_heads(x)),
           2 * x.numel() * 2, 0, "bf16",
           event_ms(lambda: x.permute(0, 2, 1, 3).contiguous()))

    # dropout: hidden states of the encoder and the decoder, and the
    # decoder self-attention's probabilities; bit-exact (the same Philox).
    errs = []
    for dtype in (f32, bf16):
        for shape in ((16, 1500, 512), (16, 100, 512), (16, 8, 100, 100)):
            x = randn(*shape, dtype=dtype)
            errs.append(check(
                f"dropout {dtype} {list(shape)}",
                max_err(dropout.dropout_cuda(x, rate, seed),
                        dropout.plain_dropout(x, rate, seed)), 0.0))
    x = randn(16, 1500, 512, dtype=bf16)
    # The library call: F.dropout at the same rate, the same function with
    # PyTorch's own random bits (the port never calls it).
    record("dropout", errs,
           event_ms(lambda: dropout.dropout_cuda(x, rate, seed)),
           event_ms(lambda: dropout.plain_dropout(x, rate, seed)),
           2 * x.numel() * 2, x.numel(), "f32",
           event_ms(lambda: F.dropout(x, rate, training=True)))

    def qkv(tq, tk, dtype):
        return (randn(128, tq, 64, dtype=dtype, scale=64 ** -0.5),
                randn(128, tk, 64, dtype=dtype), randn(128, tk, 64, dtype=dtype))

    # flash forward with dropout: o and lse against the plain version with
    # the same seed (the same mask); tolerances as at rate 0.
    errs = []
    for dtype, tol_o in ((f32, 1e-4), (bf16, 2e-2)):
        for tq in (1500, 100):
            q, k, v = qkv(tq, 1500, dtype)
            o, lse = flash_attention.flash_fwd_cuda(q, k, v, 1500, rate, seed)
            o_ref, lse_ref = flash_attention.plain_flash_fwd(q, k, v, 1500,
                                                             rate, seed)
            errs.append(check_flash(f"flash_fwd_dropout o {dtype} {tq}x1500",
                                    o, o_ref, tol_o, dtype))
            errs.append(check(f"flash_fwd_dropout lse {dtype} {tq}x1500",
                              max_err(lse, lse_ref), 1e-4))
    q, k, v = qkv(1500, 1500, bf16)
    record("flash_fwd_dropout", errs,
           event_ms(lambda: flash_attention.flash_fwd_cuda(q, k, v, 1500, rate,
                                                           seed)),
           event_ms(lambda: flash_attention.plain_flash_fwd(q, k, v, 1500,
                                                            rate, seed)),
           4 * q.numel() * 2 + 128 * 1500 * 4, 4 * 128 * 1500 * 1500 * 64,
           "bf16", event_ms(lambda: sdpa(q, k, v, rate)))

    # flash backward against plain_flash_bwd (f32: two summation orders,
    # 1e-4; bf16: dq, dk, dv are bf16 and below 2 in magnitude, where one
    # bf16 step is at most 0.016, so 3e-2, and BF16_REL_LIMIT), and in f32
    # against torch autograd through the plain forward with the same seed
    # (1e-4).
    errs = []
    for dtype, tol in ((f32, 1e-4), (bf16, 3e-2)):
        for tq in (1500, 100):
            for r in (0.0, rate):
                q, k, v = qkv(tq, 1500, dtype)
                do = randn(128, tq, 64, dtype=dtype)
                o, lse = flash_attention.plain_flash_fwd(q, k, v, 1500, r, seed)
                got = flash_attention.flash_bwd_cuda(q, k, v, o, lse, do, 1500,
                                                     r, seed)
                want = flash_attention.plain_flash_bwd(q, k, v, o, lse, do,
                                                       1500, r, seed)
                for name, a, b in zip(("dq", "dk", "dv"), got, want):
                    errs.append(check_flash(
                        f"flash_bwd {name} {dtype} {tq}x1500 rate {r}",
                        a, b, tol, dtype))
                if dtype == bf16 and r and tq == 1500:
                    check_rel_sees_faults(flash_attention, q, k, v, o, lse, do,
                                          r, seed, want)
                if dtype != f32:
                    continue
                leaves = [t.clone().requires_grad_() for t in (q, k, v)]
                o_ref, _ = flash_attention.plain_flash_fwd(*leaves, 1500, r,
                                                           seed)
                o_ref.backward(do)
                for name, a, leaf in zip(("dq", "dk", "dv"), got, leaves):
                    errs.append(check(
                        f"flash_bwd {name} f32 {tq}x1500 rate {r} vs autograd",
                        max_err(a, leaf.grad), 1e-4))
                del leaves, o_ref
    check_group_norm(record, randn)
    q, k, v = qkv(1500, 1500, bf16)
    do = randn(128, 1500, 64, dtype=bf16)
    o, lse = flash_attention.flash_fwd_cuda(q, k, v, 1500, rate, seed)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o_lib = sdpa(*leaves, rate)
    record("flash_bwd", errs,
           event_ms(lambda: flash_attention.flash_bwd_cuda(
               q, k, v, o, lse, do, 1500, rate, seed)),
           event_ms(lambda: flash_attention.plain_flash_bwd(
               q, k, v, o, lse, do, 1500, rate, seed)),
           8 * q.numel() * 2 + 128 * 1500 * 4, 10 * 128 * 1500 * 1500 * 64,
           "bf16", event_ms(lambda: torch.autograd.grad(
               o_lib, leaves, do, retain_graph=True)))
    del leaves, o_lib


def check_int8_kernels(record, randn) -> None:
    """Phase 3, the long-audio path's kernels at its shapes: q8_cross at
    whisper-base b16 (B 16, H 8) and whisper-large-v3 with 4 windows (B 4,
    H 20), D 64, Tk 1500, also at kv_len < Tk; proj_split (3 matrices) and
    merge_proj at the base encoder [16, 1500, 512] and a decode step
    [16, 1, 512]; the gradients of ProjectSplit and MergeProject; and the
    flash backward at Tk = 2560, where the TPU's several-KV-block kernels
    would run."""
    from tethys_tpu_torch.ops import decode, flash_attention, qkv

    f32, bf16 = torch.float32, torch.bfloat16

    def q8_inputs(b, h, dtype):
        # Quantized once: the kernel and the plain version read the same
        # int8 caches and scales.
        q = randn(b, h, 1, 64, dtype=dtype, scale=0.125)
        k8, sk = decode.quantize_kv_cols(randn(b, h, 64, 1500))
        v8, sv = decode.quantize_kv_cols(randn(b, h, 64, 1500))
        return q, k8, sk, v8, sv

    # f32: two f32 sums in other orders; bf16: the output is bf16 below 4,
    # where one bf16 step is at most 0.016.
    errs = []
    for dtype, tol in ((f32, 1e-5), (bf16, 2e-2)):
        for b, h in ((16, 8), (4, 20)):
            for kv_len in (None, 1000):
                args = q8_inputs(b, h, dtype)
                errs.append(check(
                    f"q8_cross {dtype} B {b} H {h} kv_len {kv_len}",
                    max_err(decode.q8_cross_cuda(*args, kv_len),
                            decode.plain_q8_cross_attention(*args, kv_len)),
                    tol))
    for dtype in (f32, bf16):
        for b, h in ((16, 8), (4, 20)):
            check_repeatable(f"q8_cross {dtype} B {b} H {h}",
                             decode.q8_cross_cuda, q8_inputs(b, h, dtype))

    def q8_bound(bh, t=1500):
        return (2 * bh * 64 * t + 2 * bh * t * 4 + 2 * bh * 64 * 2,
                4 * bh * t * 64, "bf16")

    for b, h in ((16, 8), (4, 20)):
        log(f"  q8_cross B {b} H {h} Tk 1500: cluster of "
            f"{decode.q8_cross_cluster(b * h, 64, 1500)}")
    args = q8_inputs(16, 8, bf16)
    # No single PyTorch call computes attention over int8 caches.  Timed
    # cold: the 26.1 MB of caches fit in L2, but on the path the other five
    # layers' caches pass through it between two calls for one layer.
    record("q8_cross", errs,
           event_ms(lambda: decode.q8_cross_cuda(*args), cold=True),
           event_ms(lambda: decode.plain_q8_cross_attention(*args), cold=True),
           *q8_bound(16 * 8))
    # whisper-large-v3's decode step over 4 windows.
    args = q8_inputs(4, 20, bf16)
    log_row("q8_cross", "bf16 B 4 H 20 D 64 Tk 1500, cold",
            event_ms(lambda: decode.q8_cross_cuda(*args), cold=True),
            bound(*q8_bound(4 * 20)),
            event_ms(lambda: decode.plain_q8_cross_attention(*args), cold=True))

    def proj_inputs(t, dtype, n=3):
        x = randn(16, t, 512, dtype=dtype)
        ws = [randn(512, 512, dtype=dtype, scale=512 ** -0.5) for _ in range(n)]
        bs = [randn(512, dtype=dtype, scale=0.1) for _ in range(n)]
        return x, ws, bs, (0.125,) + (1.0,) * (n - 1)

    def routed(fn, want: str, name: str):
        """fn()'s result; requires that it launched the route ``want``."""
        before = dict(qkv.ROUTE_LAUNCHES)
        out = fn()
        took = [r for r in qkv.ROUTES if qkv.ROUTE_LAUNCHES[r] > before[r]]
        log(f"  {name}: route {took}")
        require(took == [want], f"{name} took {took}, not {want}")
        return out

    def route_for(dtype, t):
        return ("ffma" if dtype == f32 else "wgmma" if t > 1 else "stream")

    # f32: sums of 512 products in other orders; bf16: outputs below 8 may
    # differ by one bf16 step (0.0625) where the f32 sums round differently.
    # bf16 takes the wgmma route at the encoder's [16, 1500, 512] and the
    # weight-streaming route at a decode step [16, 1, 512]; f32 FFMA.
    errs = []
    for dtype, tol in ((f32, 1e-4), (bf16, 6.25e-2)):
        for t in (1500, 1):
            x, ws, bs, scales = proj_inputs(t, dtype)
            name = f"proj_split {dtype} [16, {t}, 512] x 3"
            got = routed(lambda: qkv.project_split_cuda(x, ws, bs, scales, 8),
                         route_for(dtype, t), name)
            want = qkv.plain_project_split_fused(x, ws, bs, scales, 8)
            errs.append(check(name, max(max_err(a, b) for a, b in zip(got, want)),
                              tol))
    x, ws, bs, scales = proj_inputs(1500, bf16)

    def linear_split():
        return [F.linear(x, w, b).view(16, 1500, 8, 64).permute(0, 2, 1, 3)
                .contiguous() for w, b in zip(ws, bs)]

    m = 16 * 1500
    record("proj_split", errs,
           event_ms(lambda: qkv.project_split_cuda(x, ws, bs, scales, 8)),
           event_ms(lambda: qkv.plain_project_split_fused(x, ws, bs, scales, 8)),
           2 * (m * 512 + 3 * 512 * 512 + 3 * 512 + 3 * m * 512),
           3 * 2 * m * 512 * 512, "bf16", event_ms(linear_split))
    # The decode step: the split of [16, 1, 512] is a view, so the library
    # call is three F.linear.
    x1, ws1, bs1, _ = proj_inputs(1, bf16)
    log_row("proj_split", "bf16 decode step [16, 1, 512] x 3",
            event_ms(lambda: qkv.project_split_cuda(x1, ws1, bs1, scales, 8)),
            bound(2 * (16 * 512 + 3 * 512 * 512 + 3 * 512 + 3 * 16 * 512),
                  3 * 2 * 16 * 512 * 512, "bf16"),
            plain_ms=event_ms(lambda: qkv.plain_project_split_fused(
                x1, ws1, bs1, scales, 8)),
            library_ms=event_ms(lambda: [F.linear(x1, w, b).view(16, 1, 8, 64)
                                         .transpose(1, 2)
                                         for w, b in zip(ws1, bs1)]))

    errs = []
    for dtype, tol in ((f32, 1e-4), (bf16, 6.25e-2)):
        for t in (1500, 1):
            attn = randn(16, 8, t, 64, dtype=dtype)
            w = randn(512, 512, dtype=dtype, scale=512 ** -0.5)
            b = randn(512, dtype=dtype, scale=0.1)
            name = f"merge_proj {dtype} [16, 8, {t}, 64]"
            got = routed(lambda: qkv.merge_project_cuda(attn, w, b),
                         route_for(dtype, t), name)
            errs.append(check(name, max_err(got, qkv.plain_merge_project_fused(
                attn, w, b)), tol))
    attn = randn(16, 8, 1500, 64, dtype=bf16)
    w = randn(512, 512, dtype=bf16, scale=512 ** -0.5)
    b = randn(512, dtype=bf16, scale=0.1)
    record("merge_proj", errs,
           event_ms(lambda: qkv.merge_project_cuda(attn, w, b)),
           event_ms(lambda: qkv.plain_merge_project_fused(attn, w, b)),
           2 * (2 * attn.numel() + w.numel() + b.numel()),
           2 * m * 512 * 512, "bf16",
           event_ms(lambda: F.linear(attn.permute(0, 2, 1, 3).reshape(
               16, 1500, 512), w, b)))
    attn1 = randn(16, 8, 1, 64, dtype=bf16)
    log_row("merge_proj", "bf16 decode step [16, 8, 1, 64] x [512, 512]",
            event_ms(lambda: qkv.merge_project_cuda(attn1, w, b)),
            bound(2 * (2 * attn1.numel() + w.numel() + b.numel()),
                  2 * 16 * 512 * 512, "bf16"),
            plain_ms=event_ms(lambda: qkv.plain_merge_project_fused(
                attn1, w, b)),
            library_ms=event_ms(lambda: F.linear(attn1.permute(0, 2, 1, 3)
                                                 .reshape(16, 1, 512), w, b)))
    check_fused_grads(randn)
    check_flash_bwd_long(randn)


def log_row(name: str, shape: str, ms: float, bound_ms, plain_ms=None,
            library_ms=None) -> None:
    """Phase 3: a kernel's time at another shape than its table entry's,
    beside its bound and, where timed, its plain version and library call
    (logged only)."""
    extra = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
    if library_ms is not None:
        extra += f", library {library_ms:.4f} ms"
    log(f"  {name} {shape}: kernel {ms:.4f} ms, bound {bound_ms[0]:.4f} ms "
        f"({bound_ms[1]}){extra}")


def check_repeatable(name: str, fn, tensors, *args) -> None:
    """Two launches of fn on the same inputs give the same bits: outputs,
    and the tensors fn updates in place (run on two clones of the inputs)."""
    runs = []
    for _ in range(2):
        inputs = [t.clone() for t in tensors]
        out = fn(*inputs, *args)
        outs = out if isinstance(out, tuple) else (out,)
        runs.append([o.clone() for o in outs] + inputs)
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    log(f"  {name}: two launches bitwise equal: {same}")
    require(same, f"{name}: two launches on the same inputs differ")


def check_fused_grads(randn) -> None:
    """Phase 3: the autograd Functions of the fused projections on the card
    (kernel forward; merge/split kernels and matmuls backward) against
    autograd through their plain versions, f32 at [4, 1500, 512], f32
    master weights: every gradient within 1e-4 of its largest magnitude
    (f32 sums of up to 6000 terms in other orders)."""
    from tethys_tpu_torch.ops import qkv

    x = randn(4, 1500, 512)
    ws = [randn(512, 512, scale=512 ** -0.5) for _ in range(3)]
    bs = [randn(512, scale=0.1) for _ in range(3)]
    cots = [randn(4, 8, 1500, 64) for _ in range(3)]
    scales = (0.125, 1.0, 1.0)
    dy = randn(4, 1500, 512)

    def grads(fused: bool):
        leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
        if fused:
            outs = qkv.ProjectSplit.apply(leaves[0], 8, scales, *leaves[1:])
        else:
            outs = qkv.plain_project_split_fused(
                leaves[0], leaves[1:4], leaves[4:], scales, 8)
        sum((o * c).sum() for o, c in zip(outs, cots)).backward()
        attn = outs[0].detach().clone().requires_grad_()
        w, b = ws[0].clone().requires_grad_(), bs[0].clone().requires_grad_()
        if fused:
            y = qkv.MergeProject.apply(attn, w, b)
        else:
            y = qkv.plain_merge_project_fused(attn, w, b)
        (y * dy).sum().backward()
        return [t.grad for t in (*leaves, attn, w, b)]

    names = ["x", "wq", "wk", "wv", "bq", "bk", "bv", "attn", "w_out", "b_out"]
    worst = 0.0
    for name, got, want in zip(names, grads(True), grads(False)):
        rel = max_err(got, want) / want.abs().max().item()
        require(rel <= 1e-4, f"fused gradient of {name}: {rel:.3e} > 1e-4")
        worst = max(worst, rel)
    log(f"  fused projection gradients f32 [4, 1500, 512]: {len(names)} "
        f"tensors, worst {worst:.3e} of their largest magnitude (limit 1e-4)")


def check_rel_sees_faults(flash_attention, q, k, v, o, lse, do, r, seed,
                          want) -> None:
    """Phase 3: the relative limit fails what a broken bf16 backward would
    give: dq, dk, dv without their 1/(1-r) factor, and the gradients of
    another dropout mask (seed + 1), each against the plain gradients."""
    other = flash_attention.plain_flash_bwd(q, k, v, o, lse, do, k.shape[1],
                                            r, seed + 1)
    for name, a, b in zip(("dq", "dk", "dv"), want, other):
        for fault, wrong in (("without 1/(1-r)", a * (1 - r)),
                             ("with another mask", b)):
            rel = rel_err(wrong, a)
            log(f"  flash_bwd {name} {fault}: max_abs_err / max|ref| "
                f"{rel:.3e} (must exceed {BF16_REL_LIMIT:g})")
            require(rel > BF16_REL_LIMIT,
                    f"the relative limit does not see {name} {fault}")


def check_flash_bwd_long(randn) -> None:
    """Phase 3: both flash kernels at Tq = Tk = 2560 (B*H 16, D 64, rates 0
    and 0.1), the length at which the TPU's backward switches to its
    several-KV-block kernels (_bwd_dq_kernel, _bwd_dkv_kernel), which phase
    14 drives; and both at the flash bench's default shape (B*H 128, Tq
    1536, keys padded to 1536 with kv_len 1500, rate 0.1).  Tolerances as
    at 1500."""
    from tethys_tpu_torch.ops import flash_attention

    t, seed = 2560, 4321
    for dtype, tol_o, tol in ((torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, 2e-2, 3e-2)):
        for r in (0.0, DROPOUT_RATE):
            q = randn(16, t, 64, dtype=dtype, scale=64 ** -0.5)
            k, v, do = (randn(16, t, 64, dtype=dtype) for _ in range(3))
            o, lse = flash_attention.plain_flash_fwd(q, k, v, t, r, seed)
            o_card, lse_card = flash_attention.flash_fwd_cuda(q, k, v, t, r,
                                                              seed)
            check_flash(f"flash_fwd o {dtype} {t}x{t} rate {r}", o_card, o,
                        tol_o, dtype)
            check(f"flash_fwd lse {dtype} {t}x{t} rate {r}",
                  max_err(lse_card, lse), 1e-4)
            del o_card, lse_card
            got = flash_attention.flash_bwd_cuda(q, k, v, o, lse, do, t, r, seed)
            want = flash_attention.plain_flash_bwd(q, k, v, o, lse, do, t, r,
                                                   seed)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                check_flash(f"flash_bwd {name} {dtype} {t}x{t} rate {r}", a, b,
                            tol, dtype)
    q = randn(128, 1536, 64, dtype=torch.bfloat16, scale=0.3)
    k = randn(128, 1536, 64, dtype=torch.bfloat16, scale=0.3)
    v, do = (randn(128, 1536, 64, dtype=torch.bfloat16) for _ in range(2))
    o, lse = flash_attention.flash_fwd_cuda(q, k, v, 1500, DROPOUT_RATE, seed)
    o_ref, lse_ref = flash_attention.plain_flash_fwd(q, k, v, 1500,
                                                     DROPOUT_RATE, seed)
    check_flash("flash_fwd_dropout o bf16 1536x1536 kv_len 1500", o, o_ref,
                2e-2, torch.bfloat16)
    check("flash_fwd_dropout lse bf16 1536x1536 kv_len 1500",
          max_err(lse, lse_ref), 1e-4)
    got = flash_attention.flash_bwd_cuda(q, k, v, o_ref, lse_ref, do, 1500,
                                         DROPOUT_RATE, seed)
    want = flash_attention.plain_flash_bwd(q, k, v, o_ref, lse_ref, do, 1500,
                                           DROPOUT_RATE, seed)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        check_flash(f"flash_bwd {name} bf16 1536x1536 kv_len 1500 rate 0.1",
                    a, b, 3e-2, torch.bfloat16)
    del q, k, v, do, o, lse, o_ref, lse_ref, got, want

    q = randn(16, t, 64, dtype=torch.bfloat16, scale=64 ** -0.5)
    k, v, do = (randn(16, t, 64, dtype=torch.bfloat16) for _ in range(3))
    o, lse = flash_attention.flash_fwd_cuda(q, k, v, t)
    ms = event_ms(lambda: flash_attention.flash_bwd_cuda(q, k, v, o, lse, do, t))
    plain_ms = event_ms(lambda: flash_attention.plain_flash_bwd(
        q, k, v, o, lse, do, t))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    o_lib = sdpa(*leaves)
    library_ms = event_ms(lambda: torch.autograd.grad(o_lib, leaves, do,
                                                      retain_graph=True))
    del leaves, o_lib
    # dq recomputes S and dP and forms dS K (3 products); dk, dv recompute
    # S and dP and form P^T dO and dS^T Q (4 products).
    io = 2 * 16 * t * 64
    dq_bound = bound(4 * io + 16 * t * 4 + io, 6 * 16 * t * t * 64, "bf16")
    dkv_bound = bound(4 * io + 16 * t * 4 + 2 * io, 8 * 16 * t * t * 64, "bf16")
    log(f"  flash_bwd bf16 B*H 16, {t}x{t}, rate 0: kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, library {library_ms:.4f} ms (SDPA backward); "
        f"bound of the TPU's dq kernel {dq_bound[0]:.4f} ms ({dq_bound[1]}), "
        f"of its dk/dv kernel {dkv_bound[0]:.4f} ms ({dkv_bound[1]})")


def sdpa(q, k, v, rate: float = 0.0):
    """The library yardstick of the flash kernels: scaled_dot_product_attention
    on [1, B*H, T, D] with the queries pre-scaled (scale 1), at ``rate``.
    Timed only; the port never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], dropout_p=rate, scale=1.0)[0]


def check_pass(name: str, got, want, rel: float) -> float:
    """An elementwise GroupNorm pass against its plain version from the same
    vectors: f32 within rel of max|want|, bf16 within one unit in the last
    place (8 bits) of the plain value rounded once.  Returns max_abs_err."""
    err = max_err(got, want)
    if got.dtype != torch.bfloat16:
        return check(name, err, rel * want.float().abs().max().item())
    _, e = torch.frexp(want.float())
    ulps = ((got.float() - want.float()).abs()
            / torch.ldexp(torch.ones_like(want.float()), e - 8)).max().item()
    log(f"  {name}: {ulps:.3f} bf16 units in the last place (limit 1), "
        f"max_abs_err {err:.3e}")
    require(ulps <= 1.0, f"{name}: {ulps} units in the last place")
    return err


def check_group_norm(record, randn) -> None:
    """Phase 3, Wav2Vec2's GroupNorm at every GroupNorm input of
    wav2vec2-base at b32 on 2 s clips, [32, T, 512] for T = 6400 ... 100
    (GN_T), and a 5 s clip's ragged T = 250, in bf16 and f32, around a mean
    of 3 and of 50, 16 groups.  Each of the four kernels against its plain
    version: the moments (gn_stats; both read the same x and sum in f32 in
    other orders: mean to 1e-5 of (1 + |mean|), var and rstd to 1e-4
    relative); apply and apply_bwd from the same vectors as their plain
    versions (f32 1e-5 and 1e-4 of the largest magnitude, bf16 one unit in
    the last place); the grad sums A, B, s1, s2 and dgamma, dbeta (1e-4 of
    each largest magnitude); the whole f32 forward and backward against
    the plain ones (1e-5 and 1e-4 relative).  Times at mean 3: each kernel,
    its plain version, the forward and the backward beside F.group_norm
    and its autograd backward (the library's GroupNorm on [B, C, T], with
    gamma and beta in x's dtype), and their bounds."""
    from tethys_tpu_torch.ops import group_norm as gn

    groups, b, c = 16, 32, 512
    errs = {k: [] for k in ("gn_stats", "gn_grad_sums", "gn_apply",
                            "gn_apply_bwd")}
    totals = {}
    for dtype in (torch.bfloat16, torch.float32):
        for t in GN_T + (250,):
            for mean in (3.0, 50.0):
                tag = f"{dtype} T={t} mean {mean}"
                x = (randn(b, t, c) + mean).to(dtype)
                dy = randn(b, t, c, dtype=dtype)
                gamma, beta = randn(c), randn(c)
                got = gn.group_moments_cuda(x, groups)
                want = gn.plain_group_moments(x, groups)
                errs["gn_stats"].append(check(
                    f"gn_stats mean {tag}", max_err(got[0], want[0]),
                    1e-5 * (1 + mean)))
                for name, i in (("var", 1), ("rstd", 2)):
                    check(f"gn_stats {name} (relative) {tag}",
                          ((got[i] - want[i]).abs() / want[i]).max().item(),
                          1e-4)
                mu, rstd = got[0], got[2]
                y = gn.apply_cuda(x, gamma, beta, mu, rstd, groups)
                errs["gn_apply"].append(check_pass(
                    f"gn_apply {tag}", y,
                    gn.plain_apply(x, gamma, beta, mu, rstd, groups), 1e-5))
                sums, s = gn.grad_sums_cuda(x, dy, mu, rstd, gamma, groups)
                want_sums, want_s = gn.plain_grad_sums(x, dy, mu, rstd, gamma,
                                                       groups)
                for name, g, w in (
                        ("A", sums[0], want_sums[0]),
                        ("B", sums[1], want_sums[1]), ("s1", s[0], want_s[0]),
                        ("s2", s[1], want_s[1]),
                        ("dgamma", sums[0].sum(0), want_sums[0].sum(0)),
                        ("dbeta", sums[1].sum(0), want_sums[1].sum(0))):
                    errs["gn_grad_sums"].append(max_err(g, w))
                    check(f"gn_grad_sums {name} (of max) {tag}",
                          rel_err(g, w), 1e-4)
                dx = gn.apply_bwd_cuda(x, dy, gamma, mu, rstd, s, groups)
                errs["gn_apply_bwd"].append(check_pass(
                    f"gn_apply_bwd {tag}", dx,
                    gn.plain_apply_bwd(x, dy, gamma, mu, rstd, s, groups),
                    1e-4))
                if dtype == torch.float32:
                    plain_s = gn.plain_grad_sums(x, dy, want[0], want[2],
                                                 gamma, groups)[1]
                    check(f"GroupNorm forward (of max) {tag}", rel_err(
                        y, gn.plain_apply(x, gamma, beta, want[0], want[2],
                                          groups)), 1e-5)
                    check(f"GroupNorm backward dx (of max) {tag}", rel_err(
                        dx, gn.plain_apply_bwd(x, dy, gamma, want[0], want[2],
                                               plain_s, groups)), 1e-4)
                if mean != 3.0 or t == 250:
                    continue
                totals[(dtype, t)] = gn_times(gn, x, dy, gamma, beta, groups)
                for bwd in (False, True):
                    plan, blocks, sms, fit = gn.stats_launch(
                        x, groups, gn.pack_elems(x), bwd)
                    grid_all, grid = blocks * sms, plan[1] * plan[2]
                    fits = fit.get(plan[1], grid_all)
                    log(f"  {'gn_grad_sums' if bwd else 'gn_stats'} {dtype} "
                        f"[32, {t}, 512] launch: {plan[0]} channel tiles, "
                        f"clusters of {plan[1]}, {plan[2]} clusters = {grid} "
                        f"blocks; occupancy {blocks} blocks/SM x {sms} SMs = "
                        f"{grid_all}, so {grid / grid_all:.3f} of one wave; "
                        f"{fits} clusters of {plan[1]} fit at once")
                    require(grid <= grid_all and plan[2] <= fits,
                            f"gn_stats {tag}: {grid} blocks exceed one wave")
    x = (randn(b, 6400, c) + 3.0).to(torch.bfloat16)
    dy = randn(b, 6400, c, dtype=torch.bfloat16)
    gamma = randn(c)
    mu, _, rstd = gn.group_moments_cuda(x, groups)
    check_repeatable("gn_stats bf16 [32, 6400, 512]",
                     lambda x: gn.group_moments_cuda(x, groups), (x,))
    check_repeatable("gn_grad_sums bf16 [32, 6400, 512]",
                     lambda x, dy: gn.grad_sums_cuda(x, dy, mu, rstd, gamma,
                                                     groups), (x, dy))
    # The cluster size against the plan's, for _SYNC_ROWS (logged only).
    for t in (6400, 800, 100):
        xt = x[:, :t].contiguous()
        plan, blocks, sms, fit = gn.stats_launch(xt, groups, 8, False)
        sweep = ", ".join(
            f"{s} {event_ms(lambda: gn.group_moments_cuda(xt, groups, plan=(4, s, min(b * 4, fit.get(s, blocks * sms))))):.4f}"
            for s in (1, 2, 4, 8))
        log(f"  gn_stats bf16 [32, {t}, 512] by cluster size (4 tiles): "
            f"{sweep} ms; the plan takes {plan}")
    for dtype in (torch.bfloat16, torch.float32):
        rows = [totals[(dtype, t)] for t in GN_T]
        summed = {k: sum(r[k] for r in rows) for k in rows[0]}
        log(f"  GroupNorm {dtype} over the {len(GN_T)} shapes: gn_stats "
            f"{summed['stats']:.4f} ms (bound {summed['stats_bound']:.4f}, "
            f"{summed['stats_bound'] / summed['stats']:.1%}); forward "
            f"{summed['fwd']:.4f} ms (bound {summed['fwd_bound']:.4f}, "
            f"{summed['fwd_bound'] / summed['fwd']:.1%}; plain "
            f"{summed['fwd_plain']:.4f}, F.group_norm {summed['fwd_lib']:.4f});"
            f" backward {summed['bwd']:.4f} ms (bound "
            f"{summed['bwd_bound']:.4f}, "
            f"{summed['bwd_bound'] / summed['bwd']:.1%}; plain "
            f"{summed['bwd_plain']:.4f}, F.group_norm backward "
            f"{summed['bwd_lib']:.4f})")
    top = totals[(torch.bfloat16, 6400)]
    n = x.numel()
    record("gn_stats", errs["gn_stats"], top["stats"], top["stats_plain"],
           *gn_work(n, 2, b, c, groups)["stats"], top["stats_lib"])
    record("gn_grad_sums", errs["gn_grad_sums"], top["sums"],
           top["sums_plain"], *gn_work(n, 2, b, c, groups)["sums"])
    record("gn_apply", errs["gn_apply"], top["apply"], top["apply_plain"],
           *gn_work(n, 2, b, c, groups)["apply"], top["fwd_lib"])
    record("gn_apply_bwd", errs["gn_apply_bwd"], top["apply_bwd"],
           top["apply_bwd_plain"], *gn_work(n, 2, b, c, groups)["apply_bwd"],
           top["bwd_lib"])


def gn_work(n: int, elem: int, b: int, c: int, groups: int) -> dict:
    """(bytes, flops, "f32") of each GroupNorm kernel on n elements of
    elem bytes: each input read once, each output written once (x, dy, y,
    dx; the f32 [B, G], [B, C] and [C] vectors), and its f32 operations."""
    bg, f = b * groups * 4, 4
    return {
        "stats": (n * elem + 3 * bg, 3 * n, "f32"),
        "sums": (2 * n * elem + 4 * bg + 2 * b * c * f + c * f + 2 * bg,
                 5 * n, "f32"),
        "apply": (2 * n * elem + 2 * c * f + 2 * bg, 4 * n, "f32"),
        "apply_bwd": (3 * n * elem + c * f + 4 * bg, 8 * n, "f32"),
    }


def gn_times(gn, x, dy, gamma, beta, groups: int) -> dict:
    """Phase 3: one GroupNorm shape's times (module doc of check_group_norm)
    and bounds, logged; the forward and backward bounds are the sums of
    their two kernels' (the function alone, one read of its inputs and one
    write, is logged beside them)."""
    b, t, c = x.shape
    mu, _, rstd = gn.group_moments_cuda(x, groups)
    s = gn.grad_sums_cuda(x, dy, mu, rstd, gamma, groups)[1]
    pm, _, pr = gn.plain_group_moments(x, groups)
    ps = gn.plain_grad_sums(x, dy, pm, pr, gamma, groups)[1]
    xv = x.view(b, t, groups, c // groups)
    leaves = [x.transpose(1, 2).detach().requires_grad_(),
              gamma.to(x.dtype).requires_grad_(),
              beta.to(x.dtype).requires_grad_()]
    y_lib = F.group_norm(*leaves[:1], groups, *leaves[1:], 1e-5)
    dy_lib = dy.transpose(1, 2)

    def fwd():
        m, _, r = gn.group_moments_cuda(x, groups)
        return gn.apply_cuda(x, gamma, beta, m, r, groups)

    def fwd_plain():
        m, _, r = gn.plain_group_moments(x, groups)
        return gn.plain_apply(x, gamma, beta, m, r, groups)

    def bwd():
        sums, s = gn.grad_sums_cuda(x, dy, mu, rstd, gamma, groups)
        return gn.apply_bwd_cuda(x, dy, gamma, mu, rstd, s, groups), sums.sum(1)

    def bwd_plain():
        sums, s = gn.plain_grad_sums(x, dy, pm, pr, gamma, groups)
        return gn.plain_apply_bwd(x, dy, gamma, pm, pr, s, groups), sums.sum(1)

    ms = {
        "stats": event_ms(lambda: gn.group_moments_cuda(x, groups)),
        "stats_plain": event_ms(lambda: gn.plain_group_moments(x, groups)),
        "stats_lib": event_ms(lambda: torch.var_mean(xv, dim=(1, 3),
                                                     correction=0)),
        "apply": event_ms(lambda: gn.apply_cuda(x, gamma, beta, mu, rstd,
                                                groups)),
        "apply_plain": event_ms(lambda: gn.plain_apply(x, gamma, beta, mu,
                                                       rstd, groups)),
        "fwd": event_ms(fwd), "fwd_plain": event_ms(fwd_plain),
        "fwd_lib": event_ms(lambda: F.group_norm(leaves[0], groups,
                                                 leaves[1], leaves[2], 1e-5)),
        "sums": event_ms(lambda: gn.grad_sums_cuda(x, dy, mu, rstd, gamma,
                                                   groups)),
        "sums_plain": event_ms(lambda: gn.plain_grad_sums(x, dy, pm, pr,
                                                          gamma, groups)),
        "apply_bwd": event_ms(lambda: gn.apply_bwd_cuda(x, dy, gamma, mu,
                                                        rstd, s, groups)),
        "apply_bwd_plain": event_ms(lambda: gn.plain_apply_bwd(
            x, dy, gamma, pm, pr, ps, groups)),
        "bwd": event_ms(bwd), "bwd_plain": event_ms(bwd_plain),
        "bwd_lib": event_ms(lambda: torch.autograd.grad(
            y_lib, leaves, dy_lib, retain_graph=True)),
    }
    work = gn_work(x.numel(), x.element_size(), b, c, groups)
    bounds = {k: bound(*w) for k, w in work.items()}
    ms["stats_bound"] = bounds["stats"][0]
    ms["fwd_bound"] = bounds["stats"][0] + bounds["apply"][0]
    ms["bwd_bound"] = bounds["sums"][0] + bounds["apply_bwd"][0]
    one = x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    shape = f"{x.dtype} [{b}, {t}, {c}]"
    log_row("gn_stats", shape, ms["stats"], bounds["stats"],
            ms["stats_plain"], ms["stats_lib"])
    log_row("gn_apply", shape, ms["apply"], bounds["apply"],
            ms["apply_plain"])
    log_row("gn_grad_sums", shape, ms["sums"], bounds["sums"],
            ms["sums_plain"])
    log_row("gn_apply_bwd", shape, ms["apply_bwd"], bounds["apply_bwd"],
            ms["apply_bwd_plain"])
    log_row("GroupNorm forward (gn_stats + gn_apply)", shape, ms["fwd"],
            (ms["fwd_bound"], "bytes"), ms["fwd_plain"], ms["fwd_lib"])
    log_row("GroupNorm backward (gn_grad_sums + gn_apply_bwd)", shape,
            ms["bwd"], (ms["bwd_bound"], "bytes"), ms["bwd_plain"],
            ms["bwd_lib"])
    log(f"  GroupNorm {shape}: the function's own bounds (inputs read once, "
        f"outputs written once) forward {2 * one:.4f} ms, backward "
        f"{3 * one:.4f} ms")
    del y_lib, leaves
    return ms


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
        # A few decode steps alone: their head splits are views.
        steps = decode_step_counts(model, feats, tokens, 4)
        log(f"  launches during 4 decode steps: {steps}")
        require(steps["split_heads"] == 0,
                f"split_heads launched {steps['split_heads']} times in 4 "
                "decode steps")
        require(steps["decode_self"] == 4 * cfg.decoder_layers,
                f"decode_self launched {steps['decode_self']} times in 4 "
                "decode steps")
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


def counts_around(fn) -> dict:
    """The launch counts of fn() alone: set to 0 just before it and read
    just after; then added back to the counts of the path it ran in."""
    from tethys_tpu_torch.utils import kernel_lib

    torch.cuda.synchronize()
    saved = kernel_lib.launch_counts()
    kernel_lib.reset_launch_counts()
    fn()
    torch.cuda.synchronize()
    counts = kernel_lib.launch_counts()
    for k in kernel_lib.KERNELS:
        k.launches = saved[k.name] + counts[k.name]
    return counts


def decode_step_counts(model, features, tokens, steps: int) -> dict:
    """Launch counts of ``steps`` decode steps after encode and the
    cross-KV precompute, fed the tokens of a greedy run."""
    from tethys_tpu_torch.models.whisper import init_kv_caches

    kvs = model.precompute_cross_kv(model.encode(features))
    caches = init_kv_caches(model.config, features.shape[0],
                            tokens.shape[1] - 1, features.device)
    return counts_around(lambda: [
        model.decode_step(tokens[:, i:i + 1], caches, i, kvs)
        for i in range(steps)])


def run_train_f32() -> None:
    """Phase 6: f32 training steps on the card against the CPU."""
    from tethys_tpu_torch import data
    from tethys_tpu_torch.models.whisper import create_whisper_model
    from tethys_tpu_torch.parallel import dp
    from tethys_tpu_torch.utils.device import require_cuda

    dev, cpu = require_cuda(), torch.device("cpu")
    lr = 1e-4
    model, _ = create_whisper_model(
        MODEL, device=dev, seed=SEED, param_dtype=torch.float32,
        dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
    cpu_model = copy.deepcopy(model).cpu()
    batches = iter(data.create_whisper_dummy_dataset(TRAIN_F32_BATCH))
    batches = [next(batches) for _ in range(TRAIN_F32_STEPS)]

    def loss_fn(m, batch, generator):
        features, labels = batch
        return m(features, labels=labels, generator=generator)["loss"], {}

    runs = {}
    for name, m, device in (("card", model, dev), ("cpu", cpu_model, cpu)):
        m.train()
        opt = dp.whisper_optimizer(m.parameters(), lr)
        step = dp.make_train_step(loss_fn, opt)
        state = dp.TrainState(m, opt)
        losses, grads = [], None
        t0 = time.perf_counter()
        for i, (features, labels) in enumerate(batches):
            batch = (torch.from_numpy(features).to(device),
                     torch.from_numpy(labels).to(device))
            state, loss = step(state, batch, dp.step_generator(SEED, i))
            losses.append(loss.item())
            if grads is None:
                grads = {n: p.grad.detach().to(cpu, copy=True)
                         for n, p in m.named_parameters()}
        log(f"  f32 {name}: {TRAIN_F32_STEPS} steps in "
            f"{time.perf_counter() - t0:.2f} s, losses {losses}")
        runs[name] = (losses, grads, {n: p.detach().to(cpu)
                                      for n, p in m.named_parameters()})

    (card_losses, card_grads, card_params) = runs["card"]
    (cpu_losses, cpu_grads, cpu_params) = runs["cpu"]
    require(all(np.isfinite(card_losses)), f"card losses {card_losses}")
    # Losses: two f32 implementations summing in other orders, 1e-4 relative.
    check("f32 train losses card vs cpu (relative)",
          max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses)),
          1e-4)
    # Every parameter gets a finite, nonzero gradient on the card (the
    # kernels are on the autograd tape), within 1e-3 of the CPU's in norm,
    # + 1e-6 for k_proj.bias, whose gradient is zero but for rounding
    # (softmax does not see a key bias).
    worst = 0.0
    for n, g in card_grads.items():
        require(bool(torch.isfinite(g).all()) and bool(g.norm() > 0),
                f"gradient of {n} on the card is not finite or is zero")
        gap = (g - cpu_grads[n]).norm().item()
        bound = 1e-3 * cpu_grads[n].norm().item() + 1e-6
        require(gap <= bound, f"gradient of {n}: card vs cpu {gap:.3e} > "
                              f"{bound:.3e}")
        worst = max(worst, gap / bound)
    log(f"  f32 step-1 gradients: {len(card_grads)} tensors finite and "
        f"nonzero on the card; worst gap to cpu {worst:.3f} of its bound "
        f"(1e-3 * norm + 1e-6)")
    # Parameters after the last step: Keras Adam moves a weight by about
    # lr * sign(g) a step, and a gradient near zero may take either sign on
    # the two devices, so the bound is 2 * lr * steps.
    check("f32 params after the last step card vs cpu",
          max(max_err(card_params[n], cpu_params[n]) for n in card_params),
          2 * lr * TRAIN_F32_STEPS)


def run_train_bf16(gpu: str) -> dict:
    """Phase 7: the training job's loop at the bench's shape."""
    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    step_times = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        os.environ["TETHYS_WORKSPACE"] = ws
        os.environ["TETHYS_RESULT"] = ws
        with open(os.path.join(ws, "model.txt"), "w") as fh:
            fh.write("chip_smoke")
        os.makedirs(os.path.join(ws, "chip_smoke"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        result, _, cfg = jobs.train_whisper(
            model_type=MODEL, batch_size_per_replica=TRAIN_BATCH,
            num_batches=TRAIN_STEPS, compute_dtype="bfloat16", device=dev,
            seed=SEED, step_hooks=(lambda i, loss, dur: step_times.append(dur),))
        jct = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        jobs.finalize_job(result, f"whisper_{MODEL}_model", jct)
        for path in (("chip_smoke", "worker_0_jct.txt"),
                     ("checkpoints", f"whisper_{MODEL}_epoch_1", "model.pt"),
                     ("model_cache", f"whisper_{MODEL}_model", "model.pt")):
            require(os.path.exists(os.path.join(ws, *path)),
                    f"the job wrote no {'/'.join(path)}")
    losses = result.losses
    require(cfg.dropout == cfg.attention_dropout == DROPOUT_RATE,
            f"dropout rates {cfg.dropout}, {cfg.attention_dropout}")
    require(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
            f"losses {losses}")
    require(statistics.mean(losses[-3:]) < losses[0],
            f"loss did not fall: {losses}")
    ms = statistics.median(step_times[TRAIN_WARMUP:]) * 1e3
    stats = {
        "batch": TRAIN_BATCH, "steps": TRAIN_STEPS, "losses": losses,
        "ms_per_step": ms, "step_ms": [t * 1e3 for t in step_times],
        "audio_s_per_s": TRAIN_BATCH * AUDIO_SECONDS / (ms / 1e3),
        "peak_mem_gib": peak / 2 ** 30, "jct_s": jct, "gpu": gpu,
    }
    log(f"  bf16 whisper-{MODEL} b{TRAIN_BATCH} train on {gpu}: "
        f"{ms:.2f} ms/step (median of steps {TRAIN_WARMUP}-{TRAIN_STEPS - 1}),"
        f" {stats['audio_s_per_s']:.1f} audio-s/s, peak memory "
        f"{stats['peak_mem_gib']:.2f} GiB")
    log("  training " + json.dumps(stats))
    return stats


# Gradients that are zero but for rounding: softmax does not see a key
# bias, and the contrastive loss does not see a shift of project_q's output.
ROUNDING_ONLY = ("k_proj.bias", "project_q.layer_norm.bias")


def run_w2v_f32() -> None:
    """Phase 8: f32 Wav2Vec2 pretraining steps on the card against the CPU."""
    from tethys_tpu_torch import data, losses
    from tethys_tpu_torch.models import wav2vec2
    from tethys_tpu_torch.parallel import dp
    from tethys_tpu_torch.utils.device import require_cuda

    dev, cpu = require_cuda(), torch.device("cpu")
    model, config = wav2vec2.create_full_model(
        "pretraining", W2V_MODEL, device=dev, seed=SEED, hidden_dropout=0.0,
        activation_dropout=0.0, attention_dropout=0.0)
    cpu_model = copy.deepcopy(model).cpu()
    batches = iter(data.create_wav2vec2_dummy_dataset(W2V_F32_BATCH,
                                                      W2V_SAMPLES))
    batches = [torch.from_numpy(next(batches)[0])
               for _ in range(W2V_F32_STEPS)]
    frames = config.downsampled_length(W2V_SAMPLES)
    negatives = [losses.sample_negative_indices(
        torch.Generator().manual_seed(i), W2V_F32_BATCH, frames,
        config.num_negatives) for i in range(W2V_F32_STEPS)]

    runs = {}
    for name, m, device in (("card", model, dev), ("cpu", cpu_model, cpu)):
        m.train()
        opt = dp.wav2vec2_optimizer(m.parameters(), W2V_LR)
        codes = []

        def loss_fn(mod, batch, generator):
            audio, neg = batch
            out = mod(audio, generator=generator)
            codes.append((out["codevector_indices"].cpu(),
                          out["codevector_distances"].cpu()))
            return wav2vec2.pretraining_loss(config, out,
                                             negative_indices=neg)

        step = dp.make_train_step(loss_fn, opt, hardened=True)
        state = dp.TrainState(m, opt)
        losses_seen, grads = [], None
        t0 = time.perf_counter()
        for i, audio in enumerate(batches):
            state, loss = step(state, (audio.to(device), negatives[i]),
                               dp.step_generator(SEED, i))
            losses_seen.append(loss.item())
            if grads is None:
                grads = {n: None if p.grad is None
                         else p.grad.detach().to(cpu, copy=True)
                         for n, p in m.named_parameters()}
        log(f"  f32 {name}: {W2V_F32_STEPS} hardened steps in "
            f"{time.perf_counter() - t0:.2f} s, losses {losses_seen}")
        runs[name] = (losses_seen, grads, codes,
                      {n: p.detach().to(cpu) for n, p in m.named_parameters()})

    (card_losses, card_grads, card_codes, card_params) = runs["card"]
    (cpu_losses, cpu_grads, cpu_codes, cpu_params) = runs["cpu"]
    require(all(np.isfinite(card_losses)), f"card losses {card_losses}")
    # The quantizer's argmin on the two devices' f32 distances: a flip is
    # allowed only at a tie (the two distances within 1e-5 relative).
    flips = 0
    for (idx_a, _), (idx_b, dist_b) in zip(card_codes, cpu_codes):
        diff = idx_a != idx_b
        flips += int(diff.sum())
        if diff.any():
            d = dist_b.gather(-1, idx_a[..., None])[..., 0][diff]
            d_min = dist_b.gather(-1, idx_b[..., None])[..., 0][diff]
            gap = ((d - d_min).abs() / d_min.abs().clamp_min(1e-6)).max()
            require(gap.item() <= 1e-5, f"argmin differs off a tie: {gap}")
    log(f"  quantizer argmin: {flips} of "
        f"{sum(c[0].numel() for c in card_codes)} indices differ between "
        "the card and the cpu")
    if flips:
        log("  every flip is a tie (within 1e-5 relative), so the targets, "
            "losses and gradients differ by design: not held")
    else:
        check("f32 w2v losses card vs cpu (relative)",
              max(abs(a - b) / abs(b) for a, b in zip(card_losses,
                                                       cpu_losses)), 1e-4)
    # Every trainable parameter gets a finite gradient on the card, nonzero
    # unless it is zero up to rounding (ROUNDING_ONLY); the codevectors
    # (frozen, quirk #13) and the quantizer's input projection (behind
    # argmin) get none, as their JAX gradients are exactly 0.
    worst = 0.0
    for n, g in card_grads.items():
        if "quantizer." in n:
            require(g is None, f"{n} got a gradient on the card")
            continue
        require(g is not None and bool(torch.isfinite(g).all()),
                f"gradient of {n} on the card is missing or not finite")
        if n.endswith(ROUNDING_ONLY):
            continue
        require(bool(g.norm() > 0), f"gradient of {n} on the card is zero")
        if flips:
            continue
        gap = (g - cpu_grads[n]).norm().item()
        limit = 1e-3 * cpu_grads[n].norm().item() + 1e-6
        require(gap <= limit, f"gradient of {n}: card vs cpu {gap:.3e} > "
                              f"{limit:.3e}")
        worst = max(worst, gap / limit)
    log(f"  f32 w2v step-1 gradients (after both clips): {len(card_grads)} "
        f"tensors checked; worst gap to cpu {worst:.3f} of its bound "
        "(1e-3 * norm + 1e-6)")
    if not flips:
        # Keras Adam moves a weight by about lr * sign(g) a step, and a
        # gradient near zero may take either sign on the two devices.
        check("f32 w2v params after the last step card vs cpu",
              max(max_err(card_params[n], cpu_params[n])
                  for n in card_params), 2 * W2V_LR * W2V_F32_STEPS)


class Tee:
    """stdout that is also kept, to scan the loop's lines."""

    def __init__(self, out):
        self.out, self.text = out, []

    def write(self, data):
        self.text.append(data)
        return self.out.write(data)

    def flush(self):
        self.out.flush()


def run_w2v_bf16(gpu: str) -> dict:
    """Phase 9: the Wav2Vec2 job's loop at bench.py's shape."""
    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    step_times = []
    tee = Tee(sys.stdout)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        os.environ["TETHYS_WORKSPACE"] = ws
        os.environ["TETHYS_RESULT"] = ws
        with open(os.path.join(ws, "model.txt"), "w") as fh:
            fh.write("chip_smoke")
        os.makedirs(os.path.join(ws, "chip_smoke"))
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sys.stdout = tee
        try:
            result, _, cfg = jobs.train_wav2vec2(
                model_type="pretraining", model_size=W2V_MODEL,
                batch_size_per_replica=W2V_BATCH, num_batches=W2V_STEPS,
                compute_dtype="bfloat16", audio_length=W2V_SAMPLES,
                device=dev, seed=SEED,
                step_hooks=(lambda i, loss, dur: step_times.append(dur),))
        finally:
            sys.stdout = tee.out
        jct = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        jobs.finalize_job(result, f"wav2vec2_{W2V_MODEL}_model", jct)
        for path in (("chip_smoke", "worker_0_jct.txt"),
                     ("checkpoints", "model_epoch_1", "model.pt"),
                     ("model_cache", f"wav2vec2_{W2V_MODEL}_model",
                      "model.pt")):
            require(os.path.exists(os.path.join(ws, *path)),
                    f"the job wrote no {'/'.join(path)}")
    losses = result.losses
    require("Error at step" not in "".join(tee.text),
            "the resilient loop caught a failing step")
    require(cfg.hidden_dropout == cfg.attention_dropout == DROPOUT_RATE,
            f"dropout rates {cfg.hidden_dropout}, {cfg.attention_dropout}")
    require(len(losses) == W2V_STEPS and all(np.isfinite(losses)),
            f"losses {losses}")
    require(statistics.mean(losses[-3:]) < losses[0],
            f"loss did not fall: {losses}")
    ms = statistics.median(step_times[TRAIN_WARMUP:]) * 1e3
    seconds = W2V_SAMPLES / SAMPLE_RATE
    stats = {
        "batch": W2V_BATCH, "steps": W2V_STEPS, "losses": losses,
        "ms_per_step": ms, "step_ms": [t * 1e3 for t in step_times],
        "audio_s_per_s": W2V_BATCH * seconds / (ms / 1e3),
        "peak_mem_gib": peak / 2 ** 30, "jct_s": jct, "gpu": gpu,
    }
    log(f"  bf16 wav2vec2-{W2V_MODEL} b{W2V_BATCH} pretrain on {gpu}: "
        f"{ms:.2f} ms/step (median of steps {TRAIN_WARMUP}-{W2V_STEPS - 1}),"
        f" {stats['audio_s_per_s']:.1f} audio-s/s, peak memory "
        f"{stats['peak_mem_gib']:.2f} GiB")
    log("  wav2vec2 " + json.dumps(stats))
    return stats


@contextlib.contextmanager
def fused_qkv(on: bool):
    """TETHYS_FUSED_QKV=1 inside the block when ``on``; restored after."""
    before = os.environ.get("TETHYS_FUSED_QKV")
    if on:
        os.environ["TETHYS_FUSED_QKV"] = "1"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("TETHYS_FUSED_QKV", None)
        else:
            os.environ["TETHYS_FUSED_QKV"] = before


def long_wave(seconds: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(SAMPLE_RATE * seconds).astype(np.float32)


def step_logits(model, features, tokens, step: int) -> torch.Tensor:
    """The logits [B, vocab] of decode step ``step`` (0-based), fed the
    tokens of a greedy run."""
    from tethys_tpu_torch.models.whisper import init_kv_caches

    with torch.inference_mode():
        kvs = model.precompute_cross_kv(model.encode(features))
        caches = init_kv_caches(model.config, features.shape[0],
                                tokens.shape[1] - 1, features.device)
        for i in range(step + 1):
            logits = model.decode_step(tokens[:, i:i + 1], caches, i, kvs)
    return logits[:, -1].float()


def run_long_audio_f32() -> None:
    """Phase 11: int8 long-audio serving with the fused projections, f32,
    card against CPU.  The projections' route counts start at 0 here; f32
    must take the FFMA kernel."""
    from tethys_tpu_torch.ops import qkv

    qkv.ROUTE_LAUNCHES.update(dict.fromkeys(qkv.ROUTES, 0))
    with fused_qkv(True):
        long_audio_f32()
    log(f"  projection routes after phase 11: {qkv.ROUTE_LAUNCHES}")
    require(qkv.ROUTE_LAUNCHES["ffma"] > 0, "f32 never took the FFMA route")


def long_audio_f32() -> None:
    from tethys_tpu_torch.audio.frontend import prepare_streaming_features
    from tethys_tpu_torch.inference import transcribe_long_audio
    from tethys_tpu_torch.models.whisper import (
        create_whisper_model,
        greedy_generate,
    )
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    model, cfg = create_whisper_model(MODEL, device=dev, seed=SEED,
                                      kv_quant="int8")
    cpu_model = copy.deepcopy(model).cpu()
    wave = long_wave(LONG_F32_SECONDS, SEED + 2)
    t0 = time.perf_counter()
    ids_gpu = transcribe_long_audio(model, wave, max_length=LONG_F32_STEPS)
    torch.cuda.synchronize()
    log(f"  f32 card: {LONG_F32_SECONDS} s in {len(ids_gpu)} windows served "
        f"in {time.perf_counter() - t0:.2f} s (first call)")
    t0 = time.perf_counter()
    ids_cpu = transcribe_long_audio(cpu_model, wave, max_length=LONG_F32_STEPS)
    log(f"  f32 cpu: served in {time.perf_counter() - t0:.2f} s")
    require(len(ids_gpu) == len(ids_cpu) == 3,
            f"windows: card {len(ids_gpu)}, cpu {len(ids_cpu)}")

    with torch.inference_mode():
        wav = torch.from_numpy(wave)
        feats_gpu = prepare_streaming_features(wav.to(dev))
        feats_cpu = prepare_streaming_features(wav)
        require(feats_gpu.shape == (3, 80, 3000),
                f"features shape {tuple(feats_gpu.shape)}")
        check("long-audio features card vs cpu",
              max_err(feats_gpu.cpu(), feats_cpu), 1e-3)
        enc_gpu = model.encode(feats_gpu)
        enc_cpu = cpu_model.encode(feats_cpu)
        check("long-audio encoder output card vs cpu",
              max_err(enc_gpu.cpu(), enc_cpu), 2e-3)
        kv_gpu = model.precompute_cross_kv(enc_gpu)
        kv_cpu = cpu_model.precompute_cross_kv(enc_cpu)
    # The int8 caches may differ by 1 where a value lies at a rounding
    # boundary after the encoder's small card/CPU gap; scales within 1e-5.
    differ, total, worst_scale = 0, 0, 0.0
    for layer_gpu, layer_cpu in zip(kv_gpu, kv_cpu):
        require(len(layer_gpu) == 4, "the cross caches are not int8")
        for i in (0, 2):
            a, b = layer_gpu[i].cpu().int(), layer_cpu[i].int()
            require(layer_gpu[i].dtype == torch.int8,
                    f"cache dtype {layer_gpu[i].dtype}")
            gap = (a - b).abs()
            require(int(gap.max()) <= 1, f"int8 caches differ by {int(gap.max())}")
            differ += int((gap > 0).sum())
            total += gap.numel()
        for i in (1, 3):
            a, b = layer_gpu[i].cpu(), layer_cpu[i]
            worst_scale = max(worst_scale, ((a - b).abs() / b).max().item())
    log(f"  int8 caches: {differ} of {total} values ({differ / total:.3e}) "
        f"differ by 1 between card and cpu")
    check("int8 scales card vs cpu (relative)", worst_scale, 1e-5)

    for w, (a, b) in enumerate(zip(ids_gpu, ids_cpu)):
        require(((0 <= a) & (a < cfg.vocab_size)).all(),
                "token ids outside the vocabulary")
        if len(a) == len(b) and (a == b).all():
            continue
        # Tokens may part only at a near-tie of the CPU's logits.
        j = next(i for i in range(min(len(a), len(b)) + 1)
                 if i == len(a) or i == len(b) or a[i] != b[i])
        feats = torch.cat([feats_cpu, feats_cpu.new_zeros((1, 80, 3000))])
        tokens, _ = greedy_generate(cpu_model, feats, max_length=LONG_F32_STEPS)
        top = step_logits(cpu_model, feats, tokens, j - 1)[w].topk(2)
        gap = ((top.values[0] - top.values[1]) / top.values[0].abs()).item()
        log(f"  window {w}: tokens part at index {j}; the cpu's top-2 logit "
            f"gap there is {gap:.3e} of its largest logit")
        require(gap < 1e-3, f"window {w}: tokens differ off a near-tie")
    log(f"  f32 int8 long audio (fused projections): per-window tokens "
        f"{[len(ids) for ids in ids_gpu]} long, card and cpu agree")


def run_long_audio_large_v3(gpu: str) -> dict:
    """Phase 12: whisper-large-v3 bf16, int8 caches, default projections."""
    from tethys_tpu_torch.audio.frontend import prepare_streaming_features
    from tethys_tpu_torch.inference import transcribe_long_audio
    from tethys_tpu_torch.models.whisper import (
        create_whisper_model,
        greedy_generate,
    )
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    model, cfg = create_whisper_model("large-v3", device=dev, seed=SEED,
                                      compute_dtype="bfloat16", kv_quant="int8")
    wave = long_wave(LONG_V3_SECONDS, SEED + 3)
    wav = torch.from_numpy(wave).to(dev)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ids = transcribe_long_audio(model, wave, max_length=LONG_V3_STEPS)
        require(len(ids) == 4, f"{len(ids)} windows")
        for w, row in enumerate(ids):
            require(((0 <= row) & (row < cfg.vocab_size)).all(),
                    f"window {w}: token ids outside the vocabulary")
        feats = prepare_streaming_features(wav, n_mels=cfg.n_mels)
        require(feats.shape == (4, 128, 3000), f"features {tuple(feats.shape)}")
        frontend_ms = wall_ms(
            lambda: prepare_streaming_features(wav, n_mels=cfg.n_mels), 3)
        encode_ms = wall_ms(lambda: model.encode(feats), 3)
        generate_ms = wall_ms(
            lambda: greedy_generate(model, feats, max_length=LONG_V3_STEPS), 3)
        e2e_ms = wall_ms(lambda: transcribe_long_audio(
            model, wave, max_length=LONG_V3_STEPS), 3)
    peak = torch.cuda.max_memory_allocated()
    decode_ms = generate_ms - encode_ms
    stats = {
        "model": "large-v3", "windows": len(ids),
        "window_tokens": [len(row) for row in ids],
        "decode_steps": LONG_V3_STEPS, "frontend_ms": frontend_ms,
        "encode_ms": encode_ms, "generate_ms": generate_ms, "e2e_ms": e2e_ms,
        "decode_tokens_per_s": LONG_V3_STEPS * 4 / (decode_ms / 1e3),
        "rtf_e2e": LONG_V3_SECONDS / (e2e_ms / 1e3),
        "peak_mem_gib": peak / 2 ** 30, "gpu": gpu,
    }
    log(f"  bf16 whisper-large-v3 int8, {LONG_V3_SECONDS} s in 4 windows on "
        f"{gpu}: frontend {frontend_ms:.2f} ms, encode {encode_ms:.2f} ms, "
        f"generate {generate_ms:.2f} ms ({LONG_V3_STEPS} steps), decode "
        f"{stats['decode_tokens_per_s']:.1f} tokens/s, rtf_e2e "
        f"{stats['rtf_e2e']:.2f}, peak {stats['peak_mem_gib']:.2f} GiB")
    log("  large-v3 " + json.dumps(stats))
    return stats


def run_bench_twin() -> None:
    """Phase 13: the serving bench's twin at whisper-base b16 bf16."""
    from tethys_tpu_torch.ops import qkv
    from tethys_tpu_torch.scripts import bench_generate

    base = ["--batch_size", str(BENCH_BATCH), "--length", str(BENCH_STEPS),
            "--model", MODEL, "--dtype", "bfloat16", "--iters", "5",
            "--seed", str(SEED)]
    encode_ms = {}
    for kv_quant, fused in (("int8", False), ("none", False), ("int8", True)):
        log(f"  bench_generate --kv_quant {kv_quant}"
            + (" with TETHYS_FUSED_QKV=1" if fused else ""))
        with fused_qkv(fused):
            result = bench_generate.main(base + ["--kv_quant", kv_quant])
        encode_ms[(kv_quant, fused)] = result["encode_ms"]
    log(f"  int8 encode: fused projections {encode_ms[('int8', True)]:.3f} "
        f"ms, F.linear + split_heads {encode_ms[('int8', False)]:.3f} ms")
    # The bf16 fused run takes both Hopper routes: wgmma in the encoder and
    # the cross-KV precompute, weight streaming at every decode step.
    log(f"  projection routes after phases 11-13: {qkv.ROUTE_LAUNCHES}")
    require(qkv.ROUTE_LAUNCHES["wgmma"] > 0 and qkv.ROUTE_LAUNCHES["stream"] > 0,
            f"a bf16 route never launched: {qkv.ROUTE_LAUNCHES}")
    log("  bench_generate --host_chunk 32 --force_eos")
    result = bench_generate.main(base + ["--host_chunk", "32", "--force_eos"])
    require(result["chunks_run"] == 1,
            f"--force_eos ran {result['chunks_run']} chunks, not 1")


def run_flash_bench() -> None:
    """Phase 14: the flash bench's twin at its defaults, then at Tk 2560."""
    from tethys_tpu_torch.scripts import bench_flash
    from tethys_tpu_torch.utils import kernel_lib

    runs = [[]] + [["--bh", "16", "--t", "2560", "--kv_len", "2560",
                    "--rate", str(rate)] for rate in (DROPOUT_RATE, 0.0)]
    kernels = ("flash_fwd", "flash_fwd_dropout", "flash_bwd")
    for argv in runs:
        log("  bench_flash " + (" ".join(argv) or "(defaults)"))
        before = kernel_lib.launch_counts()
        result = bench_flash.main(argv)
        after = kernel_lib.launch_counts()
        launches = {k: after[k] - before[k] for k in kernels}
        require(all(np.isfinite(result[k]) and result[k] > 0
                    for k in ("flash_fwd_ms", "flash_bwd_ms")),
                f"bench_flash times {result}")
        require(launches["flash_bwd"] > 0,
                f"flash_bwd did not launch at Tk {result['t']}")
        log("  flash_bench " + json.dumps(result) + " launches "
            + json.dumps(launches))


def run_frontend_bench() -> None:
    """Phase 15: the frontend bench's twin at its defaults (16 x 30 s, 20
    calls): the fused log-mel, framing included, must beat the rfft path.
    Its max_abs_diff (fused against rfft) is logged, not held: the kernel
    is held to the exact f32 plain version in phase 3, and the rfft path
    rounds in another order again."""
    from tethys_tpu_torch.scripts import bench_frontend

    result = bench_frontend.main([])
    require(result["fused_ms"] < result["unfused_ms"],
            f"fused log-mel {result['fused_ms']:.4f} ms is not faster than "
            f"the rfft path {result['unfused_ms']:.4f} ms")


def drive_path(name: str, phases) -> dict:
    """Runs a path's phases, (title, fn, *args) each, with the launch counts
    set to 0 just before and read just after; raises unless each of the
    path's kernels launched."""
    from tethys_tpu_torch.utils import kernel_lib

    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    for title, fn, *args in phases:
        log(title)
        fn(*args)
    torch.cuda.synchronize()
    counts = kernel_lib.launch_counts()
    log(f"  launches during the {name} path: {counts}")
    missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
    require(not missing, f"{name}: kernels never launched: {missing}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tethys_tpu_torch.utils import kernel_lib
    from tethys_tpu_torch.utils.device import card_name_and_power

    gpu = card_name_and_power()
    log(gpu)

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

    serving = drive_path("serving", (
        ("[4] whisper-base f32 serving, card against cpu", run_slice_f32),
        ("[5] whisper-base bf16 serving", run_slice_bf16, gpu)))
    training = drive_path("training", (
        ("[6] whisper-base f32 training, card against cpu", run_train_f32),
        ("[7] whisper-base bf16 training job", run_train_bf16, gpu)))
    w2v = drive_path("wav2vec2", (
        ("[8] wav2vec2-base f32 pretraining, card against cpu", run_w2v_f32),
        ("[9] wav2vec2-base bf16 pretraining job", run_w2v_bf16, gpu)))
    # Every GroupNorm forward took the moments and apply kernels, every
    # backward the grad sums and apply_bwd kernels: CUDA tensors have no
    # plain path, and the counts pair up.
    log(f"  GroupNorm launches on the wav2vec2 path: forward "
        f"{w2v['gn_stats']} gn_stats, {w2v['gn_apply']} gn_apply; backward "
        f"{w2v['gn_grad_sums']} gn_grad_sums, {w2v['gn_apply_bwd']} "
        "gn_apply_bwd")
    require(w2v["gn_stats"] == w2v["gn_apply"]
            and w2v["gn_grad_sums"] == w2v["gn_apply_bwd"] > 0,
            "a GroupNorm pass of the wav2vec2 path missed its kernel")
    long_audio = drive_path("long_audio", (
        ("[11] whisper-base f32 int8 long-audio serving, card against cpu",
         run_long_audio_f32),
        ("[12] whisper-large-v3 bf16 int8 long-audio serving",
         run_long_audio_large_v3, gpu),
        ("[13] the serving bench's twin, whisper-base b16 bf16",
         run_bench_twin)))
    flash_bench = drive_path("flash_bench", (
        ("[14] the flash-kernel bench's twin, bf16, Tk 1536 and 2560",
         run_flash_bench),))
    frontend = drive_path("frontend", (
        ("[15] the frontend bench's twin, 16 x 30 s", run_frontend_bench),))
    counts = {k: serving[k] + training[k] + w2v[k] + long_audio[k]
              + flash_bench[k] + frontend[k] for k in serving}
    log(f"[10] launches on the paths: {counts}")
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
