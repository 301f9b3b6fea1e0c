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
   one-element add_ under the same method) and SDPA over the first idx + 1
   cached keys; log_mel, framed in the
   kernel, at 4 and 16 x 30 s with 80 mels and 4 x 30 s with 128, beside
   the same kernel given contiguous frames, the rfft path and the bound of
   its three TF32 passes (the f32 FFMA bound in the note); split_heads at
   [16, 1500, 512] and [4, 1500, 512] and, at a decode step [16, 1, 512],
   the main path's call (a view, no launch) beside split_heads_cuda;
   dropout at the whole tensors of the two bench steps (whisper-base
   b16, wav2vec2-base b32), f32 and bf16, forward and backward, beside
   F.dropout; and Wav2Vec2's GroupNorm at its seven inputs
   [32, T, 512] (and a 5 s clip's T = 250), f32 and bf16: the moments
   (gn_stats), apply, grad sums and apply_bwd kernels each against its
   plain version, the forward and the backward beside F.group_norm and
   its autograd backward, the gn_stats launch against the occupancy it
   reports (at most one wave), two launches bitwise equal, and the
   moments' time by cluster size; each route of the flash kernels (FFMA
   in f32, mma.sync and TMA + wgmma in bf16, the route forced) forward
   and backward against the plain versions at 1500 x 1500, 100 x 1500,
   keys padded to 1536 (kv_len 1500), 2560 x 2560, 77 x 1499 and
   large-v3's B*H 20, rates 0 and 0.1, each call raising its route's
   count by one, the relative limit failing the wgmma route's gradients
   without 1/(1-r) and under another mask; and the two bf16 routes timed
   side by side with SDPA at the forward's and the backward's rows of
   PERF.md, the dropout rows beside the keep bits' Philox issue (SASS
   instructions a call from scripts/flash_probe.py);
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
   flash bench: phase 14, frontend: phase 15, training bench: phase 16,
   resume: phase 17, data parallel: phase 18, tensorsize: phase 19,
   capacity: phase 20, parallel: phase 21 (a, b, c, e), Wav2Vec2
   parallel: phase 22 (a, b, c, e), pipeline: phase 23, scan and flat:
   phase 24, with the launches of the processes they start)
   and read after it; every kernel of a path must have launched during it,
   on the wav2vec2 path gn_apply as often as gn_stats and gn_apply_bwd
   as often as gn_grad_sums, and on the serving, training, flash bench,
   capacity, parallel and pipeline paths the flash kernels' wgmma route
   (launches by route in the kernels line);
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
   log-mel, framing included, must be faster than the rfft path;
16. the training bench's twin (python -m tethys_tpu_torch.scripts.bench)
   at its defaults: wav2vec2-base b32, b64, whisper-base b16 last, bf16,
   3 warm-up and 20 timed steps: ms/step, audio-s/s, FLOPs per step (the
   flop counter plus the kernels' analytic products) and mfu, which must
   lie in (0, 1];
17. (a) phase 6's step under the flop counter on the card and on the CPU:
   the card's total less the CPU's count is one recompute product of the
   flash backward per flash site (0.1%), and TETHYS_FUSED_QKV=1 leaves the
   card's total unchanged; (b) 2 steps, save, restore_like into a fresh
   job and 2 more equal 4 straight steps within phase 6's tolerances
   (dropout on); (c) the wav2vec2_dist CLI run twice, the second time with
   --resume and --jax_profile, prints ``Resumed from checkpoint
   model_epoch_1`` and writes a trace that holds the card's kernels;
18. data parallelism: (a) the wav2vec2_dist CLI at wav2vec2-base b32
   bf16, 10 steps, twice, each in a process of its own: alone, then with
   torchrun's env for a world of one (WORLD_SIZE=1, RANK=0, a free port on
   127.0.0.1) and --resume in the same workspace; in the world of one the
   group must be nccl, its GroupNorm and dropout kernels must launch, and
   it must resume the first run's checkpoint (rank 0 reads it and
   broadcasts it over NCCL); the two ms/step (steps 3-8 from the loop's
   elapsed column) are logged beside phase 9's, with the bytes a step
   hands to all_reduce from the collective report; (a') f32 b2, 2 hardened steps,
   rates 0, cuDNN deterministic: the step under an NCCL group of one
   (buckets and a SUM over one rank) equals the step without a group bit
   for bit; (b) two ranks on the one card over gloo (which takes CUDA
   tensors), wav2vec2-base f32 b2 a rank, 2 hardened steps, rates 0: the
   two ranks' parameters are identical, and they, their losses and the
   summed gradient's norm agree, within phase 8's tolerances, with one
   process that sums both replicas' clipped 1/N-scaled gradients;
19. the tensorsize jobs: (a) the NVML monitor daemon (tethys_tpu_torch/
   monitor, built with g++) runs while python -m tethys_tpu_torch.jobs.
   whisper_dist_tensorsize --batch_size 4 --num_batches 8 --dtype bfloat16
   and wav2vec2_dist_tensorsize --model_size base --batch_size 32
   --num_batches 8 --dtype bfloat16 run, each in a process of its own with
   a workspace and a result dir of its own; each exits 0 and every file of
   the JAX job's list exists and parses (the profiler's nine and the four
   /result copies), gpu_memory_mb > 0, every Wav2Vec2 value skew is
   finite; ms/step over steps 3-7 is logged beside phases 7, 9 and 18(a),
   the value skews of wav2vec2-base's gradients are timed batched and one
   tensor at a time, and each job's train call runs 10 steps in this
   process without and then with the profiler; (b) each step logged as many rows and as many MB
   as the census computed here on the CPU at the same shapes; (c) every
   line of the daemon is the reference's, names torch's card, Mem Usage is
   nonzero and GPU Util nonzero on some line while a job ran;
20. the single-card capacity modes: (a) whisper-base b16 bf16, dropout on,
   one step each from the same weights and generator: plain,
   remat_layers under save_flash and none, the whole-loss remat; the
   flash forward (flash_fwd + flash_fwd_dropout) launches once a site
   under plain and save_flash, twice under none and the whole-loss remat,
   flash_bwd once a site throughout; loss and every gradient within the
   bf16 limit of plain's; peak memory and ms per step of each; (b)
   grad_accum 2 at b16 (f32, rates 0) against the unaccumulated step,
   loss and gradients within the bf16 limit; (c) the whisper_dist CLI at
   whisper-large-v3 b8 (its full width, cut to 8 + 8 of its 32 + 32
   layers), --dtype bfloat16 --remat_layers --master_dtype bfloat16
   --grad_accum 2, 6 steps: every loss finite, ms/step, peak memory, and
   the peak of the same batch without --remat_layers, which must be
   higher; (d) the training bench's twin at whisper-large-v3 b4
   --remat_layers --master_dtype bfloat16: ms/step, FLOPs, 0 < mfu <= 1;
   (e) the wav2vec2_dist CLI at base b32 bf16 with --remat --grad_accum
   2, then the bench's wav2vec2-base with --master_dtype bfloat16, whose
   GroupNorm kernels launch with bf16 gamma and beta; (f) the convergence
   twin, whisper-base b16, 20 steps under each master dtype: both curves
   finite and falling;
21. Whisper's tensor and sequence parallelism, each world 2 ranks sharing
   the card over gloo (NCCL refuses two ranks on one card; the collectives
   take CUDA tensors, and the process's are logged by (backend, device,
   op)): (a) python -m tethys_tpu_torch.jobs.whisper_dist --model_size
   large-v3 --tp 2 --remat_layers --batch_size 1 --num_batches 4 --dtype
   bfloat16 --backend gloo from torchrun's env, large-v3 cut to 2 + 2
   of its 32 + 32 layers at its full width (PAR_V3_DEPTH): both ranks exit 0 with one
   finite loss a step, launch flash_fwd_dropout, flash_bwd, split_heads,
   merge_heads and dropout, and hold at most 0.55 of the unsharded f32
   parameters and Adam moments (peak memory logged); rank 0's whole
   checkpoint restores with --resume into the same CLI run alone (tp 1)
   in this process; (b) whisper-base
   f32, rates 0, b2, 2 Keras-Adam steps over (data 1, model 2) against one
   process: losses, gradients, their norm and the parameters within phase
   6's tolerances; then the same with dropout and activation_dropout 0.1
   (attention's 0), fc1's columns launching dropout_window; (c)
   whisper_dist --model_size small --sp 2 --batch_size 2 --num_batches 4
   --dtype bfloat16 exits 0 on both ranks, then whisper-small f32 steps
   over (data 1, seq 2) with the config's dropout (attention's 0), run in
   (b)'s world after its cases, against one process, as (b), the flash
   forward launched at Tq 750 against Tk 1500 and dropout_window launched
   by rank 0; (d) dropout.cu on a
   shard of [16, 1500, 512] (750 rows; 256 columns), f32 and bf16,
   forward and backward, equals its plain version and the slice of the
   whole tensor's launch bit for bit, its bf16 time beside the whole's
   (outside the path's counts); (e) greedy decoding of whisper-base f32
   over (data 1, model 2), kv_quant none and int8, emits one process's
   tokens and length, decode_self and q8_cross launched on 4 of 8 heads;
22. Wav2Vec2's tensor and sequence parallelism, each world 2 gloo ranks
   sharing the card, as in 21: (a) python -m tethys_tpu_torch.jobs.
   wav2vec2_dist --model_size base --tp 2 --batch_size 8 --num_batches 4
   --dtype bfloat16 --backend gloo from torchrun's env: both ranks exit 0
   with the same finite losses, launch gn_stats, gn_grad_sums, gn_apply,
   gn_apply_bwd (on their channel shards) and dropout_window, hold at most
   0.55 of the unsharded f32 parameters and Adam moments, and end with
   every replicated parameter bitwise equal (a digest of its bytes);
   ms/step and peak memory are logged (gloo over one card says nothing of
   NVLink); rank 0's whole checkpoint restores with --resume into the same
   CLI run alone (tp 1) in this process; (b) the same CLI with --sp 2 (every parameter replicated and
   bitwise equal, the encoder's rows windows launching dropout_window);
   (c) wav2vec2-base f32 b2, 2 hardened steps over (data 1, model 2),
   then over (data 1, seq 2) in the same 2-rank world, at rate 0 and at
   the config's dropout, against one process within phase 8's tolerances
   (a quantizer flip only at a tie);
   (d) outside the path's counts: gn_stats, gn_apply, gn_grad_sums and
   gn_apply_bwd on the channel shard [32, 6400, 256], 8 groups, bf16,
   against their plain versions, timed beside F.group_norm; dropout.cu on
   the [8, 12, 99, 99] probabilities' head window (6 of 12) and query-row
   window (49 of 99), f32 and bf16, forward and backward, each equal to
   its plain version and to the slice of the whole launch, timed in bf16
   beside F.dropout; (e) Wav2Vec2's stacked ``scan_layers`` layout in
   (c)'s world, under each layout: (i) the hardened f32 steps of (c) on the stacked
   layout, at rate 0 and at the config's dropout, against one stacked
   process within phase 8's tolerances, and their first gradients as the
   global clip takes them, unstacked, against the same world's unrolled
   run (each within phase 6's bound; the bitwise ones counted); the
   stacked runs must launch dropout_window and, under TP, GroupNorm's four
   kernels on the channel shard; (ii) make_wav2vec2_job(scan_layers=True)
   at (a, b)'s shape (base b8 bf16) under tensor_parallel 2 and
   seq_parallel 2, 4 steps, the last profiled: ms/step, params + Adam a
   rank (TP, at most 0.55 of the unsharded), the step's launches and
   Adam's and the clips' beside (a, b)'s unrolled CLI, whose last step is
   profiled alike, and the collectives by op;
23. Whisper's pipeline parallelism, 2 gloo ranks sharing the card, as in
   21: (a) python -m tethys_tpu_torch.jobs.whisper_dist --pp 2
   --microbatches 2 --batch_size 4 --num_batches 4 --dtype bfloat16
   --backend gloo from torchrun's env (whisper-small, f32 masters, dropout
   on): both ranks exit 0 with the same finite losses, launch split_heads,
   merge_heads, flash_fwd_dropout, flash_bwd and dropout, hold 0.90-0.91
   of the whole f32 parameters and Adam moments, report exactly
   18,432,000 bytes of collective-permute a step (2 directions x 2
   microbatches x [2, 1500, 768] bf16) and end with their replicated
   parameters bitwise equal; ms/step and peak memory are logged; rank 0's
   whole checkpoint restores with --resume into the same CLI run alone
   (pp 1) in this process; (b)
   whisper-base f32, rates 0, b4, one Keras-Adam step over (data 1, stage
   2) with 4 microbatches and remat against the plain step in one
   process: the loss within 1e-5 relative, gradients and parameters
   within phase 6's bounds, the replicated parameters bitwise equal on
   both ranks, the encoder's flash forward launched at the microbatch
   shape once a layer and microbatch and once more in remat's replay;
24. the last modules of the port on the bench's steps: (a, b) through
   profiling/step_profile.py (3 warm-up, 3 timed and 3 traced steps; wall
   and device ms a step, the idle share, launches a step and Adam's),
   wav2vec2-base b32 bf16 unrolled, --scan_layers, --flat_opt,
   whisper-base b16 per tensor and --flat_opt; then 5 steps of each, and
   of Wav2Vec2's with both flags, under cuDNN's and torch's deterministic
   algorithms: Wav2Vec2's scanned and flat steps take unrolled per
   tensor's first gradients bit for bit, their first loss equal and every
   loss within 1e-2 (the clip's norm in another f32 order, which the
   quantizer's argmin turns into other codes at near-ties), Whisper's
   flat step within 10 times the gap of two per-tensor runs or 1e-4 (the
   flash backward's dq atomics); (b') the bench twin with --scan_layers
   --flat_opt, and with --flat_opt --remat, which prints bench.py's note;
   (c) phase 18(a')'s f32 b2 steps in an NCCL world of one on the flat
   buffer: exactly one gradient all_reduce a step, of the flat gradient
   in place (4 x total bytes), then the loss's 4; the first loss equal to
   the per-tensor step's, the losses within 1e-5 and the parameters
   within 1e-6; both reducers timed alone; (d) the decode-floor twin's
   whisper-base b16 row beside phase 13's ms a decode step;
25. the utilities no path calls, on the card against the CPU, launching
   none of the kernels: SpecAugment run masks from fixed seeded starts
   (runs longer than the axis, runs of one, no starts) bit for bit;
   apply_time_mask and apply_feature_mask with a CUDA generator on
   wav2vec2-base's [32, 100, 768] features, f32 and bf16: whole time steps
   and whole channels zeroed, the rest untouched, dtype and device kept,
   one generator state one mask, and over a [512, 2000] draw the
   interior's masked share within 4 sigma of 1 - (1 - p)^run_length;
   SinusoidalPositionalEncoding on
   whisper-base's [16, 1500, 512] in f32 and bf16 and
   RelativePositionalEncoding (768 x 5000, and its gradient) bit for bit;
   JCTTimer times the phase's checks.

The last three lines of stdout are the card's name and power limit, the
kernel table {"kernels": [...]} and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import re
import socket
import statistics
import subprocess
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
    "train_bench": ("split_heads", "merge_heads", "flash_fwd_dropout",
                    "flash_bwd", "dropout", "gn_stats", "gn_grad_sums",
                    "gn_apply", "gn_apply_bwd"),
    "resume": ("split_heads", "merge_heads", "flash_fwd", "flash_fwd_dropout",
               "flash_bwd", "dropout", "proj_split", "merge_proj",
               "gn_stats", "gn_grad_sums", "gn_apply", "gn_apply_bwd"),
    "data_parallel": ("gn_stats", "gn_grad_sums", "gn_apply", "gn_apply_bwd",
                      "dropout"),
    # The training path's kernels but flash_fwd, which runs at rate 0 only
    # (phase 6), and the Wav2Vec2 path's.
    "tensorsize": ("split_heads", "merge_heads", "flash_fwd_dropout",
                   "flash_bwd", "dropout", "gn_stats", "gn_grad_sums",
                   "gn_apply", "gn_apply_bwd"),
    "capacity": ("split_heads", "merge_heads", "flash_fwd",
                 "flash_fwd_dropout", "flash_bwd", "dropout", "gn_stats",
                 "gn_grad_sums", "gn_apply", "gn_apply_bwd"),
    "parallel": ("split_heads", "merge_heads", "flash_fwd",
                 "flash_fwd_dropout", "flash_bwd", "dropout",
                 "dropout_window", "decode_self", "q8_cross"),
    "w2v_parallel": ("gn_stats", "gn_grad_sums", "gn_apply", "gn_apply_bwd",
                     "dropout", "dropout_window"),
    # Each rank of 23(a) launches every one of them.
    "pipeline": ("split_heads", "merge_heads", "flash_fwd_dropout",
                 "flash_bwd", "dropout"),
    # Phase 24: the bench's two steps, scanned and on the flat buffer.
    "scan_flat": ("split_heads", "merge_heads", "flash_fwd_dropout",
                  "flash_bwd", "dropout", "gn_stats", "gn_grad_sums",
                  "gn_apply", "gn_apply_bwd"),
}
# The paths that must have launched the flash kernels' wgmma route (bf16,
# every shape of the main path), and the three flash kernels.
WGMMA_PATHS = ("serving", "training", "flash_bench", "capacity", "parallel",
               "pipeline")
FLASH_KERNELS = ("flash_fwd", "flash_fwd_dropout", "flash_bwd")
# Phase 3's shapes for each flash route, (label, B*H, Tq, Tk, kv_len), D 64:
# Whisper's 1500 frames, its cross-attention, keys padded to 1536, 2560
# past the TPU's one-block backward, tiles that neither T fills, and
# large-v3's 20 heads a batch row.
FLASH_ROUTE_SHAPES = (
    ("1500x1500", 16, 1500, 1500, 1500),
    ("100x1500", 16, 100, 1500, 1500),
    ("1536x1536 kv_len 1500", 16, 1536, 1536, 1500),
    ("2560x2560", 4, 2560, 2560, 2560),
    ("77x1499", 16, 77, 1499, 1499),
    ("large-v3 B*H 20, 1500x1500", 20, 1500, 1500, 1500),
)
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
           *self_bound(127),
           library_ms=event_ms(lambda: decode_sdpa(q, kb, vb, 127)))
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
                bound(*self_bound(idx)), plain_ms,
                event_ms(lambda: decode_sdpa(q, kb, vb, idx)))
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


# dropout.cu's whole tensors on the main path: the dropout sites of the
# bench's two steps (bf16 there), forward and backward, all but
# wav2vec2's 6 smallest launches a step (python -m
# tethys_tpu_torch.scripts.dropout_probe counts them); wav2vec2 at T 99,
# where the bench's 2 s clips give T 100.
DROPOUT_SHAPES = (
    ("whisper-base b16 encoder hidden", (16, 1500, 512)),
    ("whisper-base b16 decoder hidden", (16, 100, 512)),
    ("whisper-base b16 decoder self-attention probabilities",
     (16, 8, 100, 100)),
    ("wav2vec2-base b32 hidden", (32, 99, 768)),
    ("wav2vec2-base b32 FFN activation", (32, 99, 3072)),
    ("wav2vec2-base b32 attention probabilities", (32, 12, 99, 99)),
)


def check_dropout_launch(name: str, x, seed: int, window=None, want=None):
    """dropout.cu forward on x and FusedDropout's backward (the same launch
    on dy) at ``window``, each bit for bit against plain_dropout, and the
    forward against ``want`` (the slice of the whole launch) where given;
    returns the forward's output and its largest error (0)."""
    from tethys_tpu_torch.ops import dropout

    window = window or dropout.Window()
    xg = x.detach().clone().requires_grad_()
    y = dropout.fused_dropout(xg, DROPOUT_RATE, seed, window)
    dy = torch.randn(x.shape, device=x.device).to(x.dtype)
    y.backward(dy)
    plain = dropout.plain_dropout(x, DROPOUT_RATE, seed, window)
    plain_dx = dropout.plain_dropout(dy, DROPOUT_RATE, seed, window)
    err = check(f"{name} forward", max_err(y, plain), 0.0)
    check(f"{name} backward", max_err(xg.grad, plain_dx), 0.0)
    require(torch.equal(y, plain) and torch.equal(xg.grad, plain_dx),
            f"{name}: not bit for bit its plain version")
    if want is not None:
        require(torch.equal(y, want), f"{name}: not the slice of the whole "
                "tensor's launch")
    return y.detach(), err


def dropout_times(x, window=None, shard=None):
    """(kernel ms, bound, plain ms, F.dropout ms) of dropout.cu on x at
    ``window``; F.dropout takes the shard itself (``shard``, default x)."""
    from tethys_tpu_torch.ops import dropout

    window = window or dropout.Window()
    # 2 or 4 bytes in and out, one f32 product each
    return (event_ms(lambda: dropout.dropout_cuda(x, DROPOUT_RATE, 4321,
                                                  window)),
            bound(2 * x.numel() * x.element_size(), x.numel(), "f32"),
            event_ms(lambda: dropout.plain_dropout(x, DROPOUT_RATE, 4321,
                                                   window), reps=3),
            event_ms(lambda: F.dropout(x if shard is None else shard,
                                       DROPOUT_RATE, training=True)))


def log_dropout_plan(name: str, x, window=None) -> None:
    """The launch ops/dropout.py plans for x (blocks, slots, vectors)."""
    from tethys_tpu_torch.ops import dropout

    log(f"  {name}: plan {dropout.launch_plan(x, window or dropout.Window())}")


def check_dropout(record, randn) -> None:
    """Phase 3, csrc/dropout.cu on the main path's whole tensors
    (DROPOUT_SHAPES) in f32 and bf16: forward and backward bit for bit
    against plain_dropout, each timed beside its byte bound, its plain
    version and F.dropout (PyTorch's own bits; the port never calls it),
    beside the timing floor and, at [16, 1500, 512], a torch multiply of the
    same bytes; the kernel table's entry is [16, 1500, 512] bf16."""
    errs, entry = [], None
    one = torch.zeros(1, device="cuda")
    log(f"  dropout: timing floor (one-element add_) "
        f"{event_ms(lambda: one.add_(1)):.4f} ms")
    for name, shape in DROPOUT_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x = randn(*shape, dtype=dtype)
            tag = f"dropout {str(dtype)[6:]} {list(shape)} ({name})"
            errs.append(check_dropout_launch(tag, x, 1234)[1])
            log_dropout_plan(tag, x)
            ms, bound_ms, plain_ms, library_ms = dropout_times(x)
            log_row("dropout", tag[8:], ms, bound_ms, plain_ms, library_ms)
            if shape == (16, 1500, 512) and dtype == torch.bfloat16:
                entry = (ms, plain_ms, library_ms)
                log(f"  dropout {tag[8:]}: torch.mul of the same bytes "
                    f"{event_ms(lambda: torch.mul(x, 1.1)):.4f} ms")
    ms, plain_ms, library_ms = entry
    numel = 16 * 1500 * 512
    record("dropout", errs, ms, plain_ms, 2 * numel * 2, numel, "f32",
           library_ms)


def check_training_kernels(record, randn) -> None:
    """Phase 3, the training path's kernels at whisper-base b16's shapes:
    B*H = 128, encoder self-attention 1500 x 1500, cross-attention
    100 x 1500, D = 64."""
    from tethys_tpu_torch.ops import flash_attention, transpose

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

    check_dropout(record, randn)

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
    check_flash_routes(randn)
    flash_route_times(randn)


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


def check_flash_routes(randn) -> None:
    """Phase 3: each route of the flash kernels (FFMA in f32; mma.sync and
    TMA + wgmma in bf16) forward and backward against the plain versions
    at FLASH_ROUTE_SHAPES, rates 0 and 0.1, with the tolerances of the
    checks above (f32 1e-4; bf16 o 2e-2, grads 3e-2, and BF16_REL_LIMIT;
    lse 1e-4); each call raises its route's count by one.  On the wgmma
    route the relative limit must still fail the gradients without their
    1/(1-r) and those of another mask."""
    from tethys_tpu_torch.ops import flash_attention as fa
    from tethys_tpu_torch.utils import kernel_lib

    seed, bf16 = 2468, torch.bfloat16
    for label, bh, tq, tk, kv_len in FLASH_ROUTE_SHAPES:
        for route, dtype, tol_o, tol in (("ffma", torch.float32, 1e-4, 1e-4),
                                         ("mma", bf16, 2e-2, 3e-2),
                                         ("wgmma", bf16, 2e-2, 3e-2)):
            for rate in (0.0, DROPOUT_RATE):
                q = randn(bh, tq, 64, dtype=dtype, scale=64 ** -0.5)
                k, v = (randn(bh, tk, 64, dtype=dtype) for _ in range(2))
                do = randn(bh, tq, 64, dtype=dtype)
                fwd = (kernel_lib.FLASH_FWD_DROPOUT if rate
                       else kernel_lib.FLASH_FWD)
                before = (fwd.routes[route], kernel_lib.FLASH_BWD.routes[route])
                o, lse = fa.flash_fwd_cuda(q, k, v, kv_len, rate, seed,
                                           route=route)
                o_ref, lse_ref = fa.plain_flash_fwd(q, k, v, kv_len, rate,
                                                    seed)
                got = fa.flash_bwd_cuda(q, k, v, o_ref, lse_ref, do, kv_len,
                                        rate, seed, route=route)
                want = fa.plain_flash_bwd(q, k, v, o_ref, lse_ref, do, kv_len,
                                          rate, seed)
                errs = {"o": max_err(o, o_ref), "lse": max_err(lse, lse_ref)}
                errs.update((n, max_err(a, b)) for n, a, b in
                            zip(("dq", "dk", "dv"), got, want))
                rels = ({n: rel_err(a, b) for n, a, b in
                         zip(("o", "dq", "dk", "dv"), (o, *got),
                             (o_ref, *want))} if dtype == bf16 else {})
                name = f"flash {route} {label} rate {rate}"
                log(f"  {name}: max_abs_err " + ", ".join(
                    f"{n} {e:.2e}" for n, e in errs.items())
                    + ("; / max|ref| " + ", ".join(
                        f"{n} {r:.2e}" for n, r in rels.items())
                       if rels else ""))
                require(errs["o"] <= tol_o and errs["lse"] <= 1e-4
                        and max(errs[n] for n in ("dq", "dk", "dv")) <= tol
                        and all(r <= BF16_REL_LIMIT for r in rels.values()),
                        f"{name}: beyond tolerance {errs} {rels}")
                require((fwd.routes[route], kernel_lib.FLASH_BWD.routes[route])
                        == (before[0] + 1, before[1] + 1),
                        f"{name}: the route's counts did not rise by one")
                if route == "wgmma" and rate and label == "1500x1500":
                    other = fa.flash_bwd_cuda(q, k, v, o_ref, lse_ref, do,
                                              kv_len, rate, seed + 1,
                                              route=route)
                    for n, a, b, w in zip(("dq", "dk", "dv"), got, other,
                                          want):
                        for fault, wrong in (("without 1/(1-r)",
                                              a.float() * (1 - rate)),
                                             ("with another mask", b)):
                            r = rel_err(wrong, w)
                            log(f"  flash_bwd wgmma {n} {fault}: max_abs_err "
                                f"/ max|ref| {r:.3e} (must exceed "
                                f"{BF16_REL_LIMIT:g})")
                            require(r > BF16_REL_LIMIT, "the relative limit "
                                    f"does not see wgmma's {n} {fault}")


def flash_route_times(randn) -> None:
    """Phase 3: the flash kernels' two bf16 routes side by side, with SDPA
    (forward, and backward through autograd) beside them, at the rows of
    PERF.md: whisper-base b16's encoder self-attention (B*H 32 at rate 0
    for the forward, B*H 128 at the training rate), its cross-attention
    (B*H 128, 100 x 1500) and B*H 16 at 2560 x 2560.  Bounds: bytes and
    operations, and for the dropout rows the keep bits' Philox
    instructions over the card's issue rate (instructions per call from
    the built kernels' SASS, scripts/flash_probe.py)."""
    from tethys_tpu_torch.ops import flash_attention as fa
    from tethys_tpu_torch.scripts import flash_probe
    from tethys_tpu_torch.utils import kernel_lib

    card = flash_probe.card()
    per_call = {}
    for row in flash_probe.sass_rows(str(kernel_lib.build())):
        for kind in ("fwd", "bwd"):
            if f"flash_{kind}_wgmma_kernelILi64ELb1E" in row["function"]:
                per_call[kind] = row.get("per_philox_call")
    log(f"  Philox4x32-10 calls of the wgmma kernels' keep bits: "
        f"{per_call} SASS instructions a call; {card['sms']} SMs, top clock "
        f"{card['max_sm_clock_mhz']:.0f} MHz")
    issue_rate = 4 * card["sms"] * card["max_sm_clock_mhz"] * 1e3  # /ms
    seed = 1357
    for kind, bh, tq, tk, rate in (("fwd", 32, 1500, 1500, 0.0),
                                   ("fwd", 128, 1500, 1500, DROPOUT_RATE),
                                   ("bwd", 128, 1500, 1500, DROPOUT_RATE),
                                   ("fwd", 16, 2560, 2560, 0.0),
                                   ("bwd", 16, 2560, 2560, 0.0),
                                   ("fwd", 128, 100, 1500, DROPOUT_RATE),
                                   ("bwd", 128, 100, 1500, DROPOUT_RATE)):
        q = randn(bh, tq, 64, dtype=torch.bfloat16, scale=64 ** -0.5)
        k, v = (randn(bh, tk, 64, dtype=torch.bfloat16) for _ in range(2))
        do = randn(bh, tq, 64, dtype=torch.bfloat16)
        o, lse = fa.flash_fwd_cuda(q, k, v, tk, rate, seed)
        io = 2 * bh * tq * 64
        if kind == "fwd":
            ms = {r: event_ms(lambda: fa.flash_fwd_cuda(q, k, v, tk, rate,
                                                        seed, route=r))
                  for r in ("wgmma", "mma")}
            lib = event_ms(lambda: sdpa(q, k, v, rate))
            work = (2 * io + 4 * bh * tk * 64 + bh * tq * 4,
                    4 * bh * tq * tk * 64)
        else:
            ms = {r: event_ms(lambda: fa.flash_bwd_cuda(
                q, k, v, o, lse, do, tk, rate, seed, route=r))
                  for r in ("wgmma", "mma")}
            leaves = [x.clone().requires_grad_() for x in (q, k, v)]
            o_lib = sdpa(*leaves, rate)
            lib = event_ms(lambda: torch.autograd.grad(o_lib, leaves, do,
                                                       retain_graph=True))
            del leaves, o_lib
            work = (4 * io + 4 * bh * tk * 64 + bh * tq * 4,
                    10 * bh * tq * tk * 64)
        bound_ms = bound(*work, "bf16")
        extra = ""
        if rate and per_call.get(kind):
            calls = bh * tq * tk / 4
            issue_ms = calls * per_call[kind] / 32 / issue_rate
            extra = (f"; keep bits' issue {issue_ms:.4f} ms ({calls:.0f} "
                     f"Philox calls)")
        log(f"  flash_{kind} B*H {bh}, {tq}x{tk}, rate {rate}: wgmma "
            f"{ms['wgmma']:.4f} ms, mma {ms['mma']:.4f} ms, SDPA {lib:.4f} "
            f"ms; bound {bound_ms[0]:.4f} ms ({bound_ms[1]}){extra}")
        del q, k, v, do, o, lse


def sdpa(q, k, v, rate: float = 0.0):
    """The library yardstick of the flash kernels: scaled_dot_product_attention
    on [1, B*H, T, D] with the queries pre-scaled (scale 1), at ``rate``.
    Timed only; the port never calls it."""
    return torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], dropout_p=rate, scale=1.0)[0]


def decode_sdpa(q, kb, vb, idx: int):
    """The library yardstick of decode_self: scaled_dot_product_attention
    of the pre-scaled query [B, H, 1, D] over the first idx + 1 columns of
    the [B, H, D, T_max] caches (views, no copy).  Timed only."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, kb[..., :idx + 1].transpose(-1, -2),
        vb[..., :idx + 1].transpose(-1, -2), scale=1.0)


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
    kernel_lib.set_launch_counts({k: saved[k] + n for k, n in counts.items()})
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


def run_train_bf16(gpu: str, measured: dict) -> dict:
    """Phase 7: the training job's loop at the bench's shape; its step
    times go into ``measured`` for phase 19."""
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
            seed=SEED,
            step_hooks=(lambda i, loss, dur, aux: step_times.append(dur),))
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
    measured["whisper_step_ms"] = stats["step_ms"]
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


def run_w2v_bf16(gpu: str, measured: dict) -> dict:
    """Phase 9: the Wav2Vec2 job's loop at bench.py's shape; its step times
    go into ``measured`` for phase 18(a)."""
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
                step_hooks=(lambda i, loss, dur, aux: step_times.append(dur),))
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
    measured["w2v_step_ms"] = stats["step_ms"]
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


# Phase 13's ms a decode step by (kv_quant, fused), for phase 24(d).
DECODE_MS = {}


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
        DECODE_MS[(kv_quant, fused)] = result["per_token_latency_ms"]
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


def run_train_bench(gpu: str) -> list:
    """Phase 16: the training bench's twin at its defaults: wav2vec2-base
    b32, the b64 row, whisper-base b16 last, bf16, 3 warm-up and 20 timed
    steps each; every row's audio-s/s finite and positive, 0 < mfu <= 1."""
    from tethys_tpu_torch.scripts import bench

    rows = bench.main([])
    require([r["metric"] for r in rows] == [
        "wav2vec2_base_audio_sec_per_sec_per_chip",
        "wav2vec2_base_audio_sec_per_sec_per_chip_b64_sweet_spot",
        "whisper_base_audio_sec_per_sec_per_chip"],
        f"bench rows {[r['metric'] for r in rows]}")
    for row in rows:
        require(np.isfinite(row["value"]) and row["value"] > 0
                and row["mfu"] is not None and 0 < row["mfu"] <= 1,
                f"bench row {row}")
        log(f"  train_bench {row['metric']}: "
            f"{row['step_time_s'] * 1e3:.2f} ms/step, {row['value']} "
            f"audio-s/s, {row['flops_per_step']:.6e} FLOPs/step, mfu "
            f"{row['mfu']} (counted only {row['mfu_counted_only']}) on {gpu}")
        log("  train_bench " + json.dumps(row))
    return rows


NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0)
RESUME_STEPS = 4


def whisper_f32_job(device, **overrides):
    """Phase 6's whisper-base f32 b2 training job on ``device``."""
    from tethys_tpu_torch.train import jobs

    return jobs.make_whisper_job(MODEL, TRAIN_F32_BATCH, 1e-4, "float32",
                                 seed=SEED, config_overrides=overrides,
                                 device=device)


def run_flops_card_vs_cpu() -> None:
    """Phase 17(a): phase 6's step (rates 0) under the flop counter on the
    card and on the CPU.  The card's total (what the counter sees plus the
    flash kernels' analytic products) less the CPU's count (where the plain
    attention runs as bmm) is one [Tq, D] x [D, Tk] product per flash site,
    the flash backward's recompute of S; with TETHYS_FUSED_QKV=1 the card's
    total is the same."""
    from tethys_tpu_torch.parallel import dp
    from tethys_tpu_torch.profiling import flops
    from tethys_tpu_torch.utils.device import require_cuda

    def count(device, fused=False):
        with fused_qkv(fused):
            job = whisper_f32_job(device, **NO_DROPOUT)
            batch = job.prepare_batch(next(iter(job.dataset)))
            result = flops.step_flops(job.step_fn, job.state, batch,
                                      dp.step_generator(SEED, 0))
        log(f"  {device} fused={fused}: counted {result.counted:.6e}, "
            f"custom {result.custom:.6e}, total {result.total:.6e}, loss "
            f"{result.loss.item():.6f}")
        return result, job.config, batch[1].shape[1]

    card, cfg, labels = count(require_cuda())
    fused, _, _ = count(require_cuda(), fused=True)
    cpu, _, _ = count(torch.device("cpu"))
    require(cpu.custom == 0.0, f"the CPU counted {cpu.custom} analytically")
    b, h = TRAIN_F32_BATCH, cfg.encoder_attention_heads
    d, t = cfg.d_model // h, 1500
    recompute = 2.0 * b * h * d * t * (cfg.encoder_layers * t
                                       + cfg.decoder_layers * labels)
    diff = card.total - cpu.counted
    log(f"  card total - cpu counted = {diff:.6e}; one recompute product "
        f"per flash site {recompute:.6e} ({cfg.encoder_layers} encoder "
        f"sites 1500 x 1500, {cfg.decoder_layers} cross sites {labels} x "
        f"1500, D {d}, B*H {b * h})")
    check("FLOPs: card - cpu against one recompute product per flash site "
          "(relative)", abs(diff - recompute) / recompute, 1e-3)
    log(f"  fused projections: counted {card.counted - fused.counted:.6e} "
        f"fewer, custom {fused.custom - card.custom:.6e} more")
    require(fused.total == card.total,
            f"TETHYS_FUSED_QKV=1 changed the card's total: {fused.total} "
            f"against {card.total}")


def run_resume_equals_straight() -> None:
    """Phase 17(b): phase 6's step with the config's dropout on the card: 4
    straight steps against 2 steps, save, restore_like into a freshly built
    job and 2 more steps with the generators of steps 2-3; phase 6's
    tolerances (losses 1e-4 relative; parameters 2 * lr * steps: flash_bwd
    adds dq by atomics, so the two runs are not bitwise)."""
    from tethys_tpu_torch.checkpoint import CheckpointManager
    from tethys_tpu_torch.parallel import dp
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()

    def steps(job, batches, first):
        state, losses = job.state, []
        for i, batch in enumerate(batches):
            state, loss = job.step_fn(state, job.prepare_batch(batch),
                                      dp.step_generator(SEED, first + i))
            losses.append(loss.item())
        return state, losses

    straight = whisper_f32_job(dev)
    batches = [b for b, _ in zip(straight.dataset, range(RESUME_STEPS))]
    want, want_losses = steps(straight, batches, 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        mgr = CheckpointManager(ws)
        half = RESUME_STEPS // 2
        first, _ = steps(whisper_f32_job(dev), batches[:half], 0)
        mgr.save(f"whisper_{MODEL}_step_{half}", first)
        require(mgr.latest_tag(prefix=f"whisper_{MODEL}_")
                == f"whisper_{MODEL}_step_{half}", "latest_tag")
        fresh = whisper_f32_job(dev)
        resumed = mgr.restore_like(f"whisper_{MODEL}_step_{half}",
                                   fresh.state)
        got, got_losses = steps(fresh._replace(state=resumed),
                                batches[half:], half)
    log(f"  losses straight {want_losses}, resumed {got_losses}")
    check("resume: losses of steps 2-3 against straight (relative)",
          max(abs(a - b) / abs(b)
              for a, b in zip(got_losses, want_losses[half:])), 1e-4)
    got_params = dict(got.model.named_parameters())
    check("resume: parameters after step 4 against straight",
          max(max_err(p, got_params[n])
              for n, p in want.model.named_parameters()),
          2 * 1e-4 * RESUME_STEPS)
    counts = {s["step"] for s in got.optimizer.state.values()}
    require(counts == {RESUME_STEPS}, f"Adam's counts after resume {counts}")
    for s in got.optimizer.state.values():
        require(s["m"].is_cuda and s["m"].dtype == s["v"].dtype
                == torch.float32, "restored Adam moments not f32 on the card")


def run_resume_cli() -> None:
    """Phase 17(c): the wav2vec2_dist CLI twice at --num_batches 2
    --batch_size 2 in a fresh workspace, the second time with --resume (and
    --jax_profile, whose trace must hold the card's kernels): it prints
    ``Resumed from checkpoint model_epoch_1``."""
    from tethys_tpu_torch.jobs import wav2vec2_dist

    tee = Tee(sys.stdout)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        os.environ["TETHYS_WORKSPACE"] = ws
        os.environ["TETHYS_RESULT"] = ws
        with open(os.path.join(ws, "model.txt"), "w") as fh:
            fh.write("chip_smoke")
        os.makedirs(os.path.join(ws, "chip_smoke"))
        trace_dir = os.path.join(ws, "trace")
        argv = ["--num_batches", "2", "--batch_size", "2"]
        wav2vec2_dist.main(argv)
        sys.stdout = tee
        try:
            wav2vec2_dist.main(argv + ["--resume", "--jax_profile",
                                       trace_dir])
        finally:
            sys.stdout = tee.out
        out = "".join(tee.text).splitlines()
        require("Resumed from checkpoint model_epoch_1" in out,
                "the resumed CLI did not print 'Resumed from checkpoint "
                "model_epoch_1'")
        require("Error at step" not in "".join(tee.text),
                "the resumed run caught a failing step")
        traces = os.listdir(trace_dir)
        require(len(traces) == 1, f"trace files {traces}")
        with open(os.path.join(trace_dir, traces[0])) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        log(f"  --jax_profile trace: {len(events)} events, {len(kernels)} "
            "CUDA kernels")
        require(kernels, "the profiler trace holds no CUDA kernel")


ROOT = os.path.dirname(os.path.abspath(__file__))
DP_RANKS = 2
DP_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")
# Runs the wav2vec2_dist CLI as ``python -m`` does, then prints the
# process's launch counts on a line of their own.
DIST_CLI = (
    "import json, runpy, sys\n"
    "sys.argv[0] = 'tethys_tpu_torch.jobs.wav2vec2_dist'\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
    "from tethys_tpu_torch.utils import kernel_lib\n"
    "print('LAUNCHES ' + json.dumps(kernel_lib.launch_counts()))\n")
ELAPSED_RE = re.compile(r"^Step (\d+), Loss: ([^,]+), Time: \S+ \(경과: ([\d.]+)초")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def add_counts(into: dict, counts: dict) -> None:
    for k, n in counts.items():
        into[k] = into.get(k, 0) + n


def dist_cli(ws: str, group: bool, *flags: str) -> dict:
    """python -m tethys_tpu_torch.jobs.wav2vec2_dist --model_size base
    --batch_size 32 --dtype bfloat16 --num_batches 10 (and ``flags``) in a
    process of its own, in the workspace ``ws``, with torchrun's env for a
    world of one when ``group``: its lines, launch counts, collective
    report and ms/step.

    The ms/step is the loop's elapsed column (10 ms steps) from step 2's
    line to step 8's over 6: step i's line is printed once step i + 1 is
    queued, so that span holds 6 whole steps; the last step's line comes
    after no further step and measures the device's tail alone."""
    with open(os.path.join(ws, "model.txt"), "w") as fh:
        fh.write("chip_smoke")
    os.makedirs(os.path.join(ws, "chip_smoke"), exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    env.update(TETHYS_WORKSPACE=ws, TETHYS_RESULT=ws, PYTHONPATH=ROOT)
    if group:
        env.update(WORLD_SIZE="1", RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(free_port()))
    proc = subprocess.run(
        [sys.executable, "-c", DIST_CLI, "--model_size", W2V_MODEL,
         "--batch_size", str(W2V_BATCH), "--dtype", "bfloat16",
         "--num_batches", str(W2V_STEPS), *flags],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0, f"the CLI exited {proc.returncode}:\n"
            + proc.stdout[-3000:] + proc.stderr[-3000:])
    report_path = os.path.join(ws, "chip_smoke", "worker_0_collectives.txt")
    report = None
    if os.path.exists(report_path):
        with open(report_path) as fh:
            report = fh.read().splitlines()
        os.remove(report_path)
    out = proc.stdout.splitlines()
    require("Error at step" not in proc.stdout, "a step failed in the CLI")
    counts = json.loads(next(line for line in out
                             if line.startswith("LAUNCHES "))[9:])
    steps = [ELAPSED_RE.match(line) for line in out]
    steps = [(int(m[1]), float(m[2]), float(m[3])) for m in steps if m]
    require([i for i, _, _ in steps] == list(range(W2V_STEPS))
            and all(np.isfinite(loss) for _, loss, _ in steps),
            f"the CLI's step lines {steps}")
    first, last = TRAIN_WARMUP, W2V_STEPS - 2
    ms = (steps[last][2] - steps[first][2]) / (last - first) * 1e3
    return {"out": out, "counts": counts, "report": report, "ms": ms}


def run_dist_cli(measured: dict, child: dict) -> None:
    """Phase 18(a): the wav2vec2_dist CLI at wav2vec2-base b32 bf16 alone,
    then in an NCCL world of one (torchrun's env) with ``--resume`` in the
    same workspace, each in a process of its own (``dist_cli``): the
    world resumes the first run's checkpoint (rank 0 reads it and
    broadcasts it over NCCL)."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        alone = dist_cli(ws, False)
        grouped = dist_cli(ws, True, "--resume")
    for run in (alone, grouped):
        add_counts(child, run["counts"])
    log("  a world of one, its lines: " + " | ".join(
        line for line in grouped["out"] if not line.startswith(
            ("LAUNCHES", "=", "network")) and line))
    require("process group: nccl, rank 0 of 1" in grouped["out"],
            "the CLI did not join an nccl group of one")
    require(grouped["report"][0] == "kind,bytes_per_step"
            and grouped["report"][-1].startswith("total,"),
            f"collective report {grouped['report']}")
    require("Resumed from checkpoint model_epoch_1" in grouped["out"],
            "the world of one did not resume the first run's checkpoint")
    require(not any(line.startswith("process group")
                    for line in alone["out"]) and alone["report"] is None,
            "the CLI without torchrun's env joined a group")
    log(f"  the CLI's launches in a world of one: {grouped['counts']}")
    rose = ("gn_stats", "gn_grad_sums", "gn_apply", "gn_apply_bwd", "dropout")
    require(all(grouped["counts"][k] > 0 for k in rose),
            f"the CLI launched no "
            f"{[k for k in rose if not grouped['counts'][k]]}")
    first, last = TRAIN_WARMUP, W2V_STEPS - 2
    phase9 = measured["w2v_step_ms"][first + 1:last + 1]
    measured["w2v_cli_ms"] = round(alone["ms"], 2)
    log(f"  18(a) wav2vec2-base b{W2V_BATCH} bf16, ms/step over steps "
        f"{first + 1}-{last} (each run a process of its own): alone "
        f"{alone['ms']:.2f}, nccl world of one {grouped['ms']:.2f} "
        f"(resumed); phase 9 (in this process, no group) "
        f"{statistics.mean(phase9):.2f} over the same steps")
    log(f"  collective report: {grouped['report']}; all_reduce bytes a "
        f"step {int(grouped['report'][-1].split(',')[1])}")


def w2v_dp_setup(device, global_batch: int):
    """Wav2Vec2-base f32, rates 0, from SEED on ``device``; the global
    batches of phase 18 (2 s clips) with their negatives, drawn on the
    host; the hardened step's loss on a (clips, negatives) batch."""
    from tethys_tpu_torch import data, losses
    from tethys_tpu_torch.models import wav2vec2

    model, config = wav2vec2.create_full_model(
        "pretraining", W2V_MODEL, device=device, seed=SEED,
        hidden_dropout=0.0, activation_dropout=0.0, attention_dropout=0.0)
    model.train()
    clips = iter(data.create_wav2vec2_dummy_dataset(global_batch,
                                                    W2V_SAMPLES))
    frames = config.downsampled_length(W2V_SAMPLES)
    batches = [(torch.from_numpy(next(clips)[0]),
                losses.sample_negative_indices(
                    torch.Generator().manual_seed(100 + i), global_batch,
                    frames, config.num_negatives))
               for i in range(W2V_F32_STEPS)]

    def loss_fn(mod, batch, generator):
        audio, negatives = batch
        return wav2vec2.pretraining_loss(
            config, mod(audio.to(device), generator=generator),
            negative_indices=negatives)

    return model, batches, loss_fn


def w2v_dp_steps(device, rank: int = 0, ranks: int = 1,
                 flat_opt: bool = False):
    """Phase 18's hardened steps on this process's rows of the global
    batch: the step, the logged losses, the global norm of the gradient the
    optimizer takes (the sum over the replicas), the final parameters (on
    the host) and the last gradients (``flat_opt``: the flat optimizer of
    parallel/flat.py, and its one flat gradient)."""
    from tethys_tpu_torch.parallel import dp, flat

    model, batches, loss_fn = w2v_dp_setup(device, W2V_F32_BATCH * ranks)
    spec = None
    if flat_opt:
        spec = flat.FlatSpec(model)
        spec.bind(model)
        opt = flat.wav2vec2_optimizer(spec, W2V_LR)
    else:
        opt = dp.wav2vec2_optimizer(model.parameters(), W2V_LR)
    step = dp.make_train_step(loss_fn, opt, hardened=True, flat_spec=spec)
    norms, adam_step = [], opt.step

    def record():
        norms.append(torch.linalg.vector_norm(torch.stack(
            [p.grad.norm() for p in model.parameters()
             if p.grad is not None])).item())
        adam_step()

    opt.step = record
    state, losses_seen = dp.TrainState(model, opt), []
    rows = slice(rank * W2V_F32_BATCH, (rank + 1) * W2V_F32_BATCH)
    for i, (audio, negatives) in enumerate(batches):
        state, loss = step(state, (audio[rows], negatives[rows]),
                           dp.step_generator(SEED, i, rank))
        losses_seen.append(loss.item())
    grads = ([spec.param.grad] if flat_opt else
             [p.grad for p in model.parameters() if p.grad is not None])
    return step, losses_seen, norms, {
        n: p.detach().to("cpu", copy=True) for n, p in
        model.named_parameters()}, grads


@contextlib.contextmanager
def torchrun_env(world: int, rank: int, port: int):
    """torchrun's env for one process of a world on 127.0.0.1."""
    before = {k: os.environ.get(k) for k in DP_ENV}
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def deterministic_cudnn():
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags


def run_dist_identity() -> None:
    """Phase 18(a'): f32 b2, 2 hardened steps, rates 0: under an NCCL group
    of one the step (buckets, a SUM over one rank) equals the step without
    a group bit for bit.  Both run with cuDNN's deterministic algorithms:
    its default ones need not give the same bits twice (two runs without
    a group under them are compared and logged first)."""
    from tethys_tpu_torch.parallel import mesh
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    runs = [w2v_dp_steps(dev)[3] for _ in range(2)]
    gap = max(max_err(runs[0][n], p) for n, p in runs[1].items())
    log(f"  cuDNN's default algorithms, two runs without a group: "
        f"parameters bitwise equal {gap == 0.0} (max difference {gap:.3e})")
    del runs
    with deterministic_cudnn():
        alone, want_losses, want_norms, want, _ = w2v_dp_steps(dev)
        require(alone.reducer is None, "a step without a group reduces")
        with torchrun_env(1, 0, free_port()):
            mesh.initialize_distributed()
            try:
                backend = torch.distributed.get_backend()
                grouped, losses_seen, norms, got, grads = w2v_dp_steps(dev)
                reducer_times(grouped.reducer, grads)
            finally:
                mesh.shutdown_distributed()
    require(backend == "nccl", f"backend {backend}")
    log(f"  without a group: losses {want_losses}, summed-gradient norms "
        f"{want_norms}; nccl world of one: {losses_seen}, {norms}; "
        f"{grouped.reducer.bytes_per_step} bytes a step to all_reduce")
    require(losses_seen == want_losses and norms == want_norms,
            "the nccl world of one changed the losses or gradients")
    differ = [n for n, p in want.items() if not torch.equal(got[n], p)]
    require(not differ, f"parameters differ after the steps: {differ[:5]}")
    log(f"  18(a'): {len(want)} parameters bitwise equal")


def reducer_times(reducer, grads) -> None:
    """The all-reduce layer alone on wav2vec2-base's gradients (an NCCL
    world of one), median of 30 calls: the host ms to queue one call and
    its device ms by CUDA events.  Each call is queued behind a ~10 ms
    device spin, so the events time the device's work and not the host's
    queueing."""
    loss = torch.zeros((), device=grads[0].device)
    reducer(grads, loss)
    host, device = [], []
    for _ in range(TIMING_REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        t0 = time.perf_counter()
        reducer(grads, loss)
        host.append((time.perf_counter() - t0) * 1e3)
        end.record()
        end.synchronize()
        device.append(start.elapsed_time(end))
    log(f"  the gradient all-reduce alone ({len(reducer.buckets(grads))} "
        f"buckets, {reducer.bytes_per_step} bytes, nccl world of one): "
        f"device {statistics.median(device):.4f} ms, host "
        f"{statistics.median(host):.4f} ms to queue it")


def gloo_rank(rank: str, port: str, out_dir: str) -> int:
    """A rank of phase 18(b) (``chip_smoke.py --gloo_rank R PORT DIR``)."""
    sys.path.insert(0, ROOT)
    from tethys_tpu_torch.parallel import mesh
    from tethys_tpu_torch.utils import kernel_lib
    from tethys_tpu_torch.utils.device import require_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torchrun_env(DP_RANKS, int(rank), int(port)):
        mesh.initialize_distributed(backend="gloo")
        try:
            require(torch.distributed.get_backend() == "gloo", "backend")
            _, losses_seen, norms, params, _ = w2v_dp_steps(
                require_cuda(), int(rank), DP_RANKS)
        finally:
            mesh.shutdown_distributed()
    torch.save({"losses": losses_seen, "norms": norms, "params": params,
                "launches": kernel_lib.launch_counts()},
               os.path.join(out_dir, f"rank_{rank}.pt"))
    return 0


def run_gloo_two_ranks(child: dict) -> None:
    """Phase 18(b): two ranks on the one card over gloo against one process
    that sums both replicas' clipped, 1/N-scaled gradients; phase 8's
    tolerances (losses 1e-4 relative, the gradient 1e-3 of its norm,
    parameters 2 * lr * steps)."""
    from tethys_tpu_torch.parallel import dp
    from tethys_tpu_torch.utils.device import require_cuda

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gloo_rank",
             str(r), port, tmp], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(DP_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=600)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        require(all(p.returncode == 0 for p in procs),
                "a gloo rank failed:\n" + "\n".join(o[-3000:] for o in outs))
        ranks = [torch.load(os.path.join(tmp, f"rank_{r}.pt"))
                 for r in range(DP_RANKS)]
    for r in ranks:
        add_counts(child, r["launches"])
    differ = [n for n, p in ranks[0]["params"].items()
              if not torch.equal(ranks[1]["params"][n], p)]
    require(not differ and ranks[0]["losses"] == ranks[1]["losses"],
            f"the two ranks differ: {differ[:5]}")
    log(f"  the two ranks: identical parameters; losses "
        f"{ranks[0]['losses']}, summed-gradient norms {ranks[0]['norms']}")

    # One process: each replica's loss scrubbed and /N, its gradient
    # clipped to a global norm of 1, the two summed, then the optimizer.
    dev = require_cuda()
    model, batches, loss_fn = w2v_dp_setup(dev, W2V_F32_BATCH * DP_RANKS)
    opt = dp.wav2vec2_optimizer(model.parameters(), W2V_LR)
    want_losses, want_norms = [], []
    for i, (audio, negatives) in enumerate(batches):
        total, summed = 0.0, {}
        for r in range(DP_RANKS):
            rows = slice(r * W2V_F32_BATCH, (r + 1) * W2V_F32_BATCH)
            opt.zero_grad(set_to_none=True)
            loss, _ = loss_fn(model, (audio[rows], negatives[rows]),
                              dp.step_generator(SEED, i, r))
            loss = torch.where(torch.isnan(loss), torch.zeros_like(loss),
                               loss) / DP_RANKS
            loss.backward()
            params = [p for p in model.parameters() if p.grad is not None]
            dp.clip_by_global_norm([p.grad for p in params], 1.0)
            for p in params:
                summed[p] = summed[p] + p.grad if p in summed else p.grad
            total += loss.item()
        for p in model.parameters():
            p.grad = summed.get(p)
        want_norms.append(torch.linalg.vector_norm(torch.stack(
            [g.norm() for g in summed.values()])).item())
        opt.step()
        want_losses.append(total)
    log(f"  one process: losses {want_losses}, summed-gradient norms "
        f"{want_norms}")
    check("18(b) losses, gloo ranks vs one process (relative)",
          max(abs(a - b) / abs(b) for a, b in zip(ranks[0]["losses"],
                                                   want_losses)), 1e-4)
    check("18(b) summed-gradient norms (relative)",
          max(abs(a - b) / b for a, b in zip(ranks[0]["norms"], want_norms)),
          1e-3)
    want = {n: p.detach().cpu() for n, p in model.named_parameters()}
    check("18(b) parameters after the last step, gloo ranks vs one process",
          max(max_err(ranks[0]["params"][n], p) for n, p in want.items()),
          2 * W2V_LR * W2V_F32_STEPS)


# Phase 19: the two tensorsize jobs, each in a process of its own, under the
# NVML monitor daemon.  (label, module, flags, log dir, census)
TS_STEPS = 8
TS_WHISPER_BATCH = 4
TS_JOBS = (
    ("whisper-small", "tethys_tpu_torch.jobs.whisper_dist_tensorsize",
     ("--batch_size", str(TS_WHISPER_BATCH), "--num_batches", str(TS_STEPS),
      "--dtype", "bfloat16"), "tensor_logs"),
    ("wav2vec2-base", "tethys_tpu_torch.jobs.wav2vec2_dist_tensorsize",
     ("--model_size", W2V_MODEL, "--batch_size", str(W2V_BATCH),
      "--num_batches", str(TS_STEPS), "--dtype", "bfloat16"),
     f"tensor_logs_{W2V_MODEL}"),
)
TS_FILES = ("tensor_sizes.txt", "memory_usage.txt", "summary.txt",
            "tiresias_tensorsize.txt", "skewness_analysis.txt",
            "skewness_analysis.json", "final_summary.json",
            "tiresias_result.json", "legacy_skewness_result.txt")
TS_COPIES = ("tensor_summary", "tiresias", "skewness", "combined")
# Runs ``python -m <module> <flags>`` (the module is the first argument),
# then prints the process's launch counts on a line of their own; a run
# past 240 s prints every thread's stack and exits.
RUN_MODULE = (
    "import faulthandler, json, runpy, sys\n"
    "faulthandler.dump_traceback_later(240, exit=True)\n"
    "sys.argv[0] = sys.argv.pop(1)\n"
    "runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
    "from tethys_tpu_torch.utils import kernel_lib\n"
    "print('LAUNCHES ' + json.dumps(kernel_lib.launch_counts()))\n")
MONITOR_RE = re.compile(r"^\s*\d+:\d+:\d+:\d+  Device (\d+): (.+?)  GPU Util: "
                        r"(\d+)  Mem Util: (\d+) Mem Usage: (\d+)$")


def monitor_lines(path: str) -> list:
    """The daemon's lines so far (each ends in "\n ", as the reference's
    printf: the blank remainder is not a line)."""
    with open(path) as fh:
        return [line for line in fh.read().splitlines() if line.strip()]


def run_module(ws: str, module: str, *flags: str) -> dict:
    """``module``'s CLI in a process of its own, in the workspace ``ws``:
    its lines, launch counts and ms/step over steps 3-7 (the loop's
    elapsed column, from step 2's line to step 7's, over 5)."""
    with open(os.path.join(ws, "model.txt"), "w") as fh:
        fh.write("chip_smoke")
    os.makedirs(os.path.join(ws, "chip_smoke"), exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
    env.update(TETHYS_WORKSPACE=ws, TETHYS_RESULT=ws, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    log(f"  {time.strftime('%H:%M:%S')} python -m {module} {' '.join(flags)}")
    proc = subprocess.run([sys.executable, "-c", RUN_MODULE, module, *flags],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    require(proc.returncode == 0, f"{module} exited {proc.returncode}:\n"
            + proc.stdout[-3000:] + proc.stderr[-3000:])
    out = proc.stdout.splitlines()
    require("Error at step" not in proc.stdout, f"a step failed in {module}")
    steps = [ELAPSED_RE.match(line) for line in out]
    steps = [(int(m[1]), float(m[2]), float(m[3])) for m in steps if m]
    require([i for i, _, _ in steps] == list(range(TS_STEPS))
            and all(np.isfinite(loss) for _, loss, _ in steps),
            f"{module}'s step lines {steps}")
    counts = json.loads(next(line for line in out
                             if line.startswith("LAUNCHES "))[9:])
    ms = (steps[7][2] - steps[2][2]) / 5 * 1e3
    return {"out": out, "counts": counts, "ms": ms,
            "seconds": time.perf_counter() - t0}


def read_csv(path: str) -> list:
    import csv

    with open(path) as fh:
        return list(csv.DictReader(fh))


def census_mb(inventories) -> tuple:
    """(rows, MB as the profiler writes it) of a step's static rows."""
    rows = [row for inventory, _ in inventories for row in inventory]
    return len(rows), f"{sum(row[3] for row in rows) / (1024 * 1024):.4f}"


def check_tensorsize_logs(label: str, ws: str, log_dir: str,
                          want_rows: int, want_mb: str) -> dict:
    """Every file of the JAX job's list exists and parses; each step logged
    the census's rows and total (phase 19(b)); gpu_memory_mb > 0."""
    logs = os.path.join(ws, log_dir)
    for name in TS_FILES:
        require(os.path.exists(os.path.join(logs, name)),
                f"{label}: no {log_dir}/{name}")
    sizes = read_csv(os.path.join(logs, "tensor_sizes.txt"))
    tiresias = read_csv(os.path.join(logs, "tiresias_tensorsize.txt"))
    memory = read_csv(os.path.join(logs, "memory_usage.txt"))
    summary = read_csv(os.path.join(logs, "summary.txt"))
    per_step = {}
    for row in sizes:
        if row["tensor_type"] != "parameter":
            per_step[row["step"]] = per_step.get(row["step"], 0) + 1
    require([r["step"] for r in tiresias] == [str(i) for i in range(TS_STEPS)]
            and len(summary) == len(memory) == TS_STEPS,
            f"{label}: steps logged {[r['step'] for r in tiresias]}")
    require(all(r["tensorsize_mb"] == want_mb for r in tiresias),
            f"{label}: step totals {[r['tensorsize_mb'] for r in tiresias]}"
            f" MB, the CPU census {want_mb} MB")
    require(set(per_step.values()) == {want_rows},
            f"{label}: rows a step {per_step}, the CPU census {want_rows}")
    gpu_mb = [float(r["gpu_memory_mb"]) for r in memory]
    require(all(mb > 0 for mb in gpu_mb), f"{label}: gpu_memory_mb {gpu_mb}")
    docs = {}
    for name in ("skewness_analysis.json", "final_summary.json",
                 "tiresias_result.json"):
        with open(os.path.join(logs, name)) as fh:
            docs[name] = json.load(fh)
    for name in ("skewness_analysis.txt", "legacy_skewness_result.txt"):
        with open(os.path.join(logs, name)) as fh:
            docs[name] = fh.read()
    require(docs["skewness_analysis.txt"].startswith(
        "=== Tensor Skewness Analysis ===") and docs[
        "legacy_skewness_result.txt"].startswith("model,skewness\n"),
        f"{label}: skewness_analysis.txt / legacy_skewness_result.txt")
    result = docs["tiresias_result.json"]
    require(result["total_steps"] == TS_STEPS
            and f"{result['tensorsize_mb']:.4f}" == want_mb,
            f"{label}: tiresias_result.json {result}")
    for suffix in TS_COPIES:
        path = os.path.join(ws, "chip_smoke", f"worker_0_{suffix}.txt")
        require(os.path.exists(path), f"{label}: no /result copy {path}")
        with open(path) as fh:
            require(len(fh.read().splitlines()) >= 2, f"{label}: {path}")
    log(f"  {label}: {TS_STEPS} steps of {want_rows} rows, {want_mb} MB a "
        f"step (Tiresias {result['tensorsize_mb']:.2f} MB, model skewness "
        f"{result['skewness']:.2f}); gpu_memory_mb {min(gpu_mb):.2f}-"
        f"{max(gpu_mb):.2f}")
    return docs


def skew_times() -> None:
    """Phase 19: the value skews of wav2vec2-base's ~200 gradients, as
    tree_value_skewness takes them (all at once) and one value_skewness a
    tensor, by CUDA events."""
    from tethys_tpu_torch.configs import Wav2Vec2Config
    from tethys_tpu_torch.models import wav2vec2
    from tethys_tpu_torch.profiling import tensorsize

    with torch.device("meta"):
        model = wav2vec2.Wav2Vec2ForPreTraining(Wav2Vec2Config.from_size(
            W2V_MODEL))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = {name: torch.randn(p.shape, generator=gen, device="cuda")
             for name, p in model.named_parameters()}
    batched = tensorsize.tree_value_skewness(grads, "g")
    each = {f"g/{n}": tensorsize.value_skewness(g)
            for n, g in grads.items() if g.numel() > 1}
    check("19 batched gradient skews against one value_skewness a tensor",
          max(abs(batched[k].item() - v.item()) for k, v in each.items()),
          1e-4)
    ms = event_ms(lambda: tensorsize.tree_value_skewness(grads, "g"), 10)
    loop_ms = event_ms(lambda: [tensorsize.value_skewness(g)
                                for g in grads.values() if g.numel() > 1], 10)
    n = sum(p.numel() for p in grads.values())
    log(f"  19 value skews of {len(each)} gradients ({n} f32): "
        f"tree_value_skewness {ms:.4f} ms, one value_skewness a tensor "
        f"{loop_ms:.4f} ms (device time, CUDA events)")


def profiler_cost() -> dict:
    """Phase 19: what the profiler costs a step, in this process: each
    tensorsize job's train call at the jobs' shapes, 10 steps, without and
    then with a TensorProfiler; the median of steps 3-9 of the loop's step
    times, {flavor: {profiled: ms}}."""
    from tethys_tpu_torch.profiling.tensorsize import TensorProfiler
    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    common = dict(num_batches=TRAIN_STEPS, compute_dtype="bfloat16",
                  device=dev, seed=SEED, checkpointing=False)
    runs = {
        "whisper": lambda **kw: jobs.train_whisper(
            model_type="small", batch_size_per_replica=TS_WHISPER_BATCH,
            **common, **kw),
        "wav2vec2": lambda **kw: jobs.train_wav2vec2(
            model_type="pretraining", model_size=W2V_MODEL,
            batch_size_per_replica=W2V_BATCH, audio_length=W2V_SAMPLES,
            **common, **kw),
    }
    out = {}
    for flavor, train in runs.items():
        ms = out[flavor] = {}
        for on in (False, True):
            times = []
            with tempfile.TemporaryDirectory(prefix="chip_smoke_") as logs:
                profiler = (TensorProfiler(log_dir=logs, flavor=flavor,
                                           device=dev) if on else None)
                train(profiler=profiler, step_hooks=(
                    lambda i, loss, dur, aux: times.append(dur),))
                if profiler is not None:
                    profiler.close()
            ms[on] = round(statistics.median(times[3:]) * 1e3, 2)
        log(f"  19 {flavor} in this process, ms/step (median of steps "
            f"3-{TRAIN_STEPS - 1}), off/on: {ms[False]}, {ms[True]}")
    return out


def run_tensorsize(measured: dict, child: dict) -> None:
    """Phase 19: (a) the NVML monitor daemon, then the two tensorsize jobs,
    each in a process of its own: exit 0, every artifact present and
    parsed, the Wav2Vec2 value skews finite, ms/step beside phases 7 and 9
    and phase 18(a)'s CLI, and each job's train call without and with the
    profiler in this process;
    (b) each step's rows and total equal the census computed here on the
    CPU at the same shapes; (c) the daemon's lines name the card, with a
    nonzero Mem Usage, and a nonzero GPU Util while a job ran."""
    from tethys_tpu_torch.configs import Wav2Vec2Config, WhisperConfig
    from tethys_tpu_torch.monitor import daemon
    from tethys_tpu_torch.train import jobs

    census = {
        "whisper-small": census_mb(jobs.whisper_inventories(
            WhisperConfig.from_size("small", compute_dtype="bfloat16"),
            TS_WHISPER_BATCH)),
        "wav2vec2-base": census_mb(jobs.wav2vec2_inventories(
            Wav2Vec2Config.from_size(W2V_MODEL, compute_dtype="bfloat16"),
            W2V_BATCH, W2V_SAMPLES)),
    }
    log(f"  19(b) the CPU census of a step (rows, MB): {census}")
    skew_times()

    binary = daemon.build()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as mon_dir:
        mon_path = os.path.join(mon_dir, "gpu.txt")
        with open(mon_path, "w") as mon_out:
            monitor = subprocess.Popen([str(binary)], stdout=mon_out,
                                       stderr=subprocess.PIPE, text=True)
        try:
            time.sleep(0.5)
            if monitor.poll() is not None:
                raise AssertionError("the monitor daemon exited: "
                                     + monitor.stderr.read())
            runs, spans = {}, {}
            for label, module, flags, log_dir in TS_JOBS:
                with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
                    before = len(monitor_lines(mon_path))
                    runs[label] = run_module(ws, module, *flags)
                    spans[label] = (before, len(monitor_lines(mon_path)))
                    docs = check_tensorsize_logs(label, ws, log_dir,
                                                 *census[label])
                if label.startswith("wav2vec2"):
                    skews = docs["skewness_analysis.json"]["value_skewness"]
                    require(len(skews) > 100 and all(
                        np.isfinite(v) for v in skews.values()),
                        f"wav2vec2 value skews {skews}")
                    log(f"  {len(skews)} value skews, all finite: "
                        f"input {skews['input/input_values']:.4f}, logits "
                        f"{skews['output/logits']:.4f}")
                add_counts(child, runs[label]["counts"])
                log(f"  {label}: {runs[label]['ms']:.2f} ms/step over steps "
                    f"3-7, {runs[label]['seconds']:.1f} s in its process")
            in_process = profiler_cost()
        finally:
            monitor.terminate()
            monitor.wait(timeout=30)
        lines = monitor_lines(mon_path)
    name = torch.cuda.get_device_name(0)
    samples = [MONITOR_RE.match(line) for line in lines]
    require(all(samples), "monitor lines that are not the reference's: "
            + repr([ln for ln, m in zip(lines, samples) if not m][:3]))
    card = [m for m in samples if m[1] == "0"]
    require(card and all(m[2] == name for m in card),
            f"the daemon names {sorted({m[2] for m in card})}, torch {name}")
    require(max(int(m[5]) for m in card) > 0, "Mem Usage 0 on every line")
    during = [int(MONITOR_RE.match(lines[i])[3]) for a, b in spans.values()
              for i in range(a, b) if MONITOR_RE.match(lines[i])[1] == "0"]
    require(during and max(during) > 0,
            f"GPU Util 0 on every line while a job ran ({len(during)})")
    log(f"  19(c) the daemon: {len(lines)} lines, e.g. {lines[len(lines) // 2]!r};"
        f" GPU Util while the jobs ran: max {max(during)}, median "
        f"{statistics.median(during)} over {len(during)} samples")
    phase9 = measured["w2v_step_ms"][3:8]
    log(f"  19 ms/step over steps 3-7, bf16: whisper-small b"
        f"{TS_WHISPER_BATCH} profiled {runs['whisper-small']['ms']:.2f} "
        f"(its train call in this process, off/on: "
        f"{in_process['whisper'][False]}, {in_process['whisper'][True]}); "
        f"wav2vec2-base b{W2V_BATCH} profiled "
        f"{runs['wav2vec2-base']['ms']:.2f}, unprofiled: phase 18(a)'s CLI "
        f"alone {measured['w2v_cli_ms']}, phase 9 (in this process) "
        f"{statistics.mean(phase9):.2f}; phase 7 (whisper-base b"
        f"{TRAIN_BATCH}) {statistics.mean(measured['whisper_step_ms'][3:8]):.2f}")


# Phase 20: the single-card capacity modes.
CAP_MODES = (
    ("plain", {}, {}),
    ("remat_layers save_flash", {"remat_layers": True}, {}),
    ("remat_layers none", {"remat_layers": True, "remat_policy": "none"}, {}),
    ("remat (whole loss)", {}, {"remat": True}),
)
CAP_V3_BATCH = 8
CAP_V3_STEPS = 6
# 20(c)'s depth: 8 + 8 of large-v3's 32 + 32 layers at its full width (the
# model's making, its checkpoints and the steps scale with the depth).
CAP_V3_DEPTH = 8
CAP_V3_BENCH_BATCH = 4
CAP_W2V_STEPS = 4
CAP_CONVERGENCE_STEPS = 20


def bench_whisper_batch(batch: int, n_mels: int, device):
    """The training bench's fixed Whisper batch (30 s of features, 100
    labels in 3..99, so no pad token): numpy seed 0."""
    rng = np.random.default_rng(0)
    features = rng.standard_normal((batch, n_mels, 3000), dtype=np.float32)
    labels = rng.integers(3, 100, size=(batch, 100)).astype(np.int32)
    return (torch.from_numpy(features).to(device),
            torch.from_numpy(labels).to(device))


def one_step(job, batch) -> dict:
    """One step of ``job`` on ``batch`` with step 0's generator: its loss,
    its gradients (on the host, taken before the optimizer runs), its
    launch counts, its peak memory over what was allocated before it, and
    the wall ms of 3 more steps."""
    from tethys_tpu_torch.parallel import dp

    grads = {}
    optimizer = job.state.optimizer
    real_step = optimizer.step

    def spy():
        grads.update({n: p.grad.detach().float().cpu() for n, p in
                      job.state.model.named_parameters() if p.grad is not None})
        real_step()

    optimizer.step = spy
    out = {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out["counts"] = counts_around(lambda: out.update(loss=job.step_fn(
        job.state, batch, dp.step_generator(SEED, 0))[1].item()))
    out["peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    optimizer.step = real_step
    out["grads"] = grads
    out["ms"] = wall_ms(lambda: job.step_fn(job.state, batch,
                                            dp.step_generator(SEED, 1)), 3)
    return out


def check_grads_close(name: str, got: dict, want: dict) -> float:
    """Every gradient within the bf16 limit of the reference's, relative
    to its largest magnitude, but the ones that are zero up to rounding
    (ROUNDING_ONLY), which must be finite."""
    require(set(got) == set(want), f"{name}: gradients of {set(got) ^ set(want)}")
    worst, worst_name = 0.0, None
    for n, g in want.items():
        require(bool(torch.isfinite(got[n]).all()), f"{name}: {n} not finite")
        if n.endswith(ROUNDING_ONLY):
            continue
        rel = rel_err(got[n], g)
        require(rel <= BF16_REL_LIMIT, f"{name}: gradient of {n} {rel:.3e} "
                                       f"from the reference's")
        if rel >= worst:
            worst, worst_name = rel, n
    log(f"  {name}: {len(want)} gradients, worst max_abs_err / max|ref| "
        f"{worst:.3e} ({worst_name}; limit {BF16_REL_LIMIT})")
    return worst


def run_capacity_modes(gpu: str) -> None:
    """Phase 20(a): whisper-base b16 bf16, dropout on, one step of each
    mode from the same weights and generator: plain, remat_layers under
    save_flash and none, the whole-loss remat.  The flash forward
    (flash_fwd + flash_fwd_dropout) launches once a site a step under
    plain and save_flash, twice under none and the whole-loss remat;
    flash_bwd once a site throughout; loss and every gradient within the
    bf16 limit of plain's (flash_bwd adds dq by atomics, so not bitwise)."""
    import gc

    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    runs = {}
    for name, overrides, kw in CAP_MODES:
        job = jobs.make_whisper_job(MODEL, 1, 1e-4, "bfloat16", seed=SEED,
                                    device=dev, config_overrides=overrides,
                                    **kw)
        cfg = job.config
        runs[name] = one_step(job, bench_whisper_batch(
            TRAIN_BATCH, cfg.n_mels, dev))
        del job
        gc.collect()
    sites = cfg.encoder_layers + cfg.decoder_layers
    plain = runs["plain"]
    for (name, _, _), forwards in zip(CAP_MODES, (1, 1, 2, 2)):
        run = runs[name]
        fwd = run["counts"]["flash_fwd"] + run["counts"]["flash_fwd_dropout"]
        log(f"  {name}: loss {run['loss']:.6f}, flash forward {fwd} "
            f"launches, flash_bwd {run['counts']['flash_bwd']}, peak "
            f"{run['peak_gib']:.3f} GiB over the weights, {run['ms']:.2f} "
            f"ms/step (whisper-base b{TRAIN_BATCH} bf16, {gpu})")
        require(fwd == forwards * sites and run["counts"]["flash_bwd"] == sites,
                f"{name}: flash forward {fwd}, backward "
                f"{run['counts']['flash_bwd']}, want {forwards * sites} and "
                f"{sites} ({sites} sites)")
        if name != "plain":
            check_rel(f"{name} loss against plain", torch.tensor(run["loss"]),
                      torch.tensor(plain["loss"]))
            check_grads_close(f"{name} against plain", run["grads"],
                              plain["grads"])
    log("  capacity_modes " + json.dumps({
        name: {k: run[k] for k in ("loss", "peak_gib", "ms")}
        | {"flash_fwd": run["counts"]["flash_fwd"]
           + run["counts"]["flash_fwd_dropout"],
           "flash_bwd": run["counts"]["flash_bwd"]}
        for name, run in runs.items()} | {"sites": sites, "gpu": gpu}))


def run_grad_accum() -> None:
    """Phase 20(b): grad_accum 2 at b16 against the unaccumulated step,
    every dropout rate 0 and f32 compute, so that the two differ only in
    the order of the sums (in bf16 each microbatch's gradient is rounded
    to bf16 before the f32 sum, which in a gradient that cancels across
    the batch comes near the bf16 limit): loss and every gradient within
    the bf16 limit."""
    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    runs = {}
    for accum in (1, 2):
        job = jobs.make_whisper_job(MODEL, 1, 1e-4, "float32", seed=SEED,
                                    device=dev, config_overrides=NO_DROPOUT,
                                    grad_accum=accum)
        runs[accum] = one_step(job, bench_whisper_batch(
            TRAIN_BATCH, job.config.n_mels, dev))
        log(f"  grad_accum {accum}: loss {runs[accum]['loss']:.6f}, peak "
            f"{runs[accum]['peak_gib']:.3f} GiB over the weights, "
            f"{runs[accum]['ms']:.2f} ms/step (f32)")
        del job
    check_rel("grad_accum 2 loss against 1", torch.tensor(runs[2]["loss"]),
              torch.tensor(runs[1]["loss"]))
    check_grads_close("grad_accum 2 against 1", runs[2]["grads"],
                      runs[1]["grads"])


def run_job_cli(module, argv, ws: str = None) -> dict:
    """A job CLI's main(argv) in this process, in the workspace ``ws`` (a
    fresh one by default): its stdout lines, step lines (index, loss,
    elapsed s), peak memory over what was allocated before it, and ms/step
    from the elapsed column over steps 2 .. last-1."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    tee = Tee(sys.stdout)
    with contextlib.ExitStack() as stack:
        if ws is None:
            ws = stack.enter_context(
                tempfile.TemporaryDirectory(prefix="chip_smoke_"))
        os.environ["TETHYS_WORKSPACE"] = ws
        os.environ["TETHYS_RESULT"] = ws
        with open(os.path.join(ws, "model.txt"), "w") as fh:
            fh.write("chip_smoke")
        os.makedirs(os.path.join(ws, "chip_smoke"), exist_ok=True)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        log(f"  {time.strftime('%H:%M:%S')} python -m {module.__name__} "
            + " ".join(argv))
        t0 = time.perf_counter()
        sys.stdout = tee
        try:
            module.main(argv)
        finally:
            sys.stdout = tee.out
        seconds = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    text = "".join(tee.text)
    require("Error at step" not in text, f"a step failed in {module.__name__}")
    steps = [ELAPSED_RE.match(line) for line in text.splitlines()]
    steps = [(int(m[1]), float(m[2]), float(m[3])) for m in steps if m]
    n = int(argv[argv.index("--num_batches") + 1])
    require([i for i, _, _ in steps] == list(range(n))
            and all(np.isfinite(loss) for _, loss, _ in steps),
            f"{module.__name__}'s step lines {steps}")
    ms = ((steps[-2][2] - steps[1][2]) / (n - 3) * 1e3 if n > 3
          else float("nan"))
    return {"losses": [loss for _, loss, _ in steps], "peak_gib": peak,
            "ms": ms, "seconds": seconds, "out": text.splitlines()}


def run_resume(tag: str, module, ws: str, flags, checkpoint: str,
               depth: int = 0) -> None:
    """The job CLI ``module`` with ``flags``, --num_batches 1 and --resume
    in this process (one replica, no group), in the workspace ``ws`` of a
    parallel run, Whisper cut to ``depth`` layers (0: its own): it must
    resume that run's whole checkpoint ``checkpoint`` and log one finite
    loss."""
    with whisper_depth(depth) if depth else contextlib.nullcontext():
        run = run_job_cli(module, [*flags, "--num_batches", "1", "--resume"],
                          ws)
    require(f"Resumed from checkpoint {checkpoint}" in run["out"],
            f"{tag}: the one-process run did not resume rank 0's checkpoint")
    require(len(run["losses"]) == 1 and np.isfinite(run["losses"]).all(),
            f"{tag}: resumed losses {run['losses']}")
    log(f"  {tag} --resume in one process, without the parallel flag: loss "
        f"{run['losses']}, peak {run['peak_gib']:.3f} GiB, "
        f"{run['seconds']:.1f} s")


@contextlib.contextmanager
def whisper_depth(depth: int):
    """``WhisperConfig.from_size`` gives ``depth`` encoder and decoder
    layers (the size's own width) for the duration."""
    from tethys_tpu_torch.configs import WhisperConfig

    own = WhisperConfig.__dict__["from_size"]
    sized = WhisperConfig.from_size
    WhisperConfig.from_size = lambda model_type="small", **kw: sized(
        model_type, **{"encoder_layers": depth, "decoder_layers": depth,
                       **kw})
    try:
        yield
    finally:
        WhisperConfig.from_size = own


def run_large_v3_cli(gpu: str) -> None:
    """Phase 20(c): the whisper_dist CLI at whisper-large-v3 (full width,
    CAP_V3_DEPTH + CAP_V3_DEPTH layers) b8, bf16 compute on bf16 master
    weights, gradients accumulated over 2 microbatches of 4, every layer
    checkpointed under save_flash: every loss finite, ms/step, peak
    memory; then the same batch without --remat_layers for its peak."""
    from tethys_tpu_torch.jobs import whisper_dist

    flags = ["--model_size", "large-v3", "--batch_size", str(CAP_V3_BATCH),
             "--dtype", "bfloat16", "--master_dtype", "bfloat16",
             "--grad_accum", "2"]
    with whisper_depth(CAP_V3_DEPTH):
        remat = run_job_cli(whisper_dist, flags + [
            "--remat_layers", "--num_batches", str(CAP_V3_STEPS)])
        plain = run_job_cli(whisper_dist, flags + ["--num_batches", "2"])
    log(f"  whisper-large-v3 ({CAP_V3_DEPTH} + {CAP_V3_DEPTH} layers) "
        f"b{CAP_V3_BATCH} bf16 master, grad_accum 2, "
        f"--remat_layers: {remat['ms']:.2f} ms/step (steps 2-"
        f"{CAP_V3_STEPS - 2}), peak {remat['peak_gib']:.3f} GiB; without "
        f"--remat_layers: peak {plain['peak_gib']:.3f} GiB; losses "
        f"{remat['losses']} ({gpu})")
    log("  large_v3_cli " + json.dumps({
        "remat_layers": {k: v for k, v in remat.items() if k != "out"},
        "no_remat_layers": {k: v for k, v in plain.items() if k != "out"},
        "gpu": gpu}))
    require(remat["peak_gib"] < plain["peak_gib"],
            "--remat_layers did not lower the peak")


def run_large_v3_bench(gpu: str) -> None:
    """Phase 20(d): the training bench's twin at whisper-large-v3 b4
    --remat_layers --master_dtype bfloat16: ms/step, FLOPs (the recompute
    included) and mfu in (0, 1]."""
    from tethys_tpu_torch.scripts import bench

    (row,) = bench.main(["--family", "whisper", "--model", "large-v3",
                         "--batch_size", str(CAP_V3_BENCH_BATCH),
                         "--remat_layers", "--master_dtype", "bfloat16",
                         "--steps", "5", "--warmup", "2"])
    require(np.isfinite(row["value"]) and row["mfu"] is not None
            and 0 < row["mfu"] <= 1, f"bench row {row}")
    log(f"  train_bench {row['metric']} b{CAP_V3_BENCH_BATCH} --remat_layers "
        f"--master_dtype bfloat16: {row['step_time_s'] * 1e3:.2f} ms/step, "
        f"{row['flops_per_step']:.6e} FLOPs/step, mfu {row['mfu']} on {gpu}")
    log("  train_bench " + json.dumps(row))


def run_w2v_capacity(gpu: str) -> None:
    """Phase 20(e): the wav2vec2_dist CLI at base b32 bf16 with --remat
    --grad_accum 2, then the bench's Wav2Vec2 with --master_dtype bfloat16,
    whose GroupNorm kernels must launch with bf16 gamma and beta."""
    from tethys_tpu_torch.jobs import wav2vec2_dist
    from tethys_tpu_torch.scripts import bench
    from tethys_tpu_torch.train import jobs

    cli = run_job_cli(wav2vec2_dist, [
        "--model_size", W2V_MODEL, "--batch_size", str(W2V_BATCH), "--dtype",
        "bfloat16", "--remat", "--grad_accum", "2", "--num_batches",
        str(CAP_W2V_STEPS)])
    log(f"  wav2vec2_dist --remat --grad_accum 2, base b{W2V_BATCH}: "
        f"losses {cli['losses']}, {cli['ms']:.2f} ms/step, peak "
        f"{cli['peak_gib']:.3f} GiB ({gpu})")
    built = []
    real = jobs.make_wav2vec2_job

    def spy(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    jobs.make_wav2vec2_job = spy
    try:
        rows = []
        counts = counts_around(lambda: rows.extend(bench.main([
            "--family", "wav2vec2", "--master_dtype", "bfloat16", "--steps",
            "5", "--warmup", "2"])))
    finally:
        jobs.make_wav2vec2_job = real
    gn = built[0].state.model.wav2vec2.feature_extractor.norm_0
    require(gn.gamma.dtype == gn.beta.dtype == torch.bfloat16,
            f"GroupNorm parameters {gn.gamma.dtype}")
    gn_counts = {k: counts[k] for k in ("gn_stats", "gn_apply",
                                        "gn_grad_sums", "gn_apply_bwd")}
    require(all(gn_counts.values()), f"GroupNorm launches {gn_counts}")
    (row,) = rows
    log(f"  train_bench {row['metric']} --master_dtype bfloat16: "
        f"{row['step_time_s'] * 1e3:.2f} ms/step, mfu {row['mfu']}, "
        f"GroupNorm launches with bf16 weights {gn_counts} on {gpu}")
    log("  train_bench " + json.dumps(row))


def run_convergence() -> None:
    """Phase 20(f): the convergence twin, whisper-base b16, 20 steps under
    each master dtype: both curves finite and falling."""
    from tethys_tpu_torch.scripts import convergence_check

    record = convergence_check.main(["--steps", str(CAP_CONVERGENCE_STEPS)])
    curves = (record["f32_first_last"], record["bf16_first_last"])
    require(all(np.isfinite(v) for c in curves for v in c)
            and all(last < first for first, last in curves),
            f"convergence {record}")
    log(f"  convergence: f32 {curves[0]}, bf16 {curves[1]}, max relative "
        f"gap over the back half {record['max_rel_gap_back_half']}, verdict "
        f"{record['verdict']}")


# Phase 21: Whisper's tensor and sequence parallelism.  The machine has one
# card and NCCL refuses two ranks on one card, so each world is 2 ranks
# sharing it over gloo (which takes CUDA tensors): a proof of correctness,
# of the kernels at the sharded shapes and of each rank's memory, not of
# the collectives' speed.
PAR_RANKS = 2
PAR_V3_STEPS = 4
# 21(a)'s depth: 2 + 2 of large-v3's 32 + 32 layers at its full width,
# which keeps the whole script, phases 23 and 24 included, well inside its
# time limit (the model's making, its checkpoint and the resume scale with
# the depth).
PAR_V3_DEPTH = 2
PAR_SP_STEPS = 4
PAR_STEPS = 2
PAR_BATCH = 2           # rows a replica in (b), (c) and (e)
PAR_LR = 1e-4
PAR_DECODE_STEPS = 32
# (kv_quant, TETHYS_FUSED_QKV) of 21(e): JAX's fused projections run under a
# TP mesh (its Pallas call has no partitioning rule, so GSPMD runs it on
# gathered weights); here csrc/qkv_proj.cu runs on each rank's heads.
PAR_DECODES = (("none", False), ("int8", False), ("int8", True))
# The rates of 21(b)'s second TP run: fc1's columns take activation
# dropout on their window (whisper's rate is 0, so 21(a) draws none); the
# flash mask keeps local coordinates (heads), as JAX's does, so attention's
# is 0.
PAR_TP_DROPOUT = {"attention_dropout": 0.0, "activation_dropout": DROPOUT_RATE}
PAR_ADAM_SHARE = 0.55   # one rank's params + Adam over the unsharded total


class ProfiledStep:
    """A train step whose call number ``at`` (from 0) runs under
    torch.profiler: ``counts`` holds that step's kernel launches (counted
    as profiling/step_profile.py counts them), those of Adam and the
    clips, and their device ms; every attribute but these is the step's
    own (its ``collective_bytes``, ``reducer``)."""

    def __init__(self, step, at: int):
        self.step, self.at, self.calls, self.counts = step, at, 0, None

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, *args, **kwargs):
        self.calls += 1
        if self.calls - 1 != self.at:
            return self.step(*args, **kwargs)
        from tethys_tpu_torch.profiling import step_profile

        activities = [torch.profiler.ProfilerActivity.CPU,
                      torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            out = self.step(*args, **kwargs)
            torch.cuda.synchronize()
        kernels = step_profile.kernel_times(prof)
        adam = [us for name, us, chain in kernels
                if step_profile.categorise(name, chain) == "optimizer + clips"]
        self.counts = {
            "launches": sum(1 for evt in prof.events()
                            if evt.name in step_profile.LAUNCH_EVENTS),
            "adam_launches": len(adam),
            "device_ms": sum(us for _, us, _ in kernels) / 1e3,
            "adam_ms": sum(adam) / 1e3}
        return out
# Runs ``python -m <module> <flags>`` (the module is the first argument),
# Whisper cut to $CHIP_SMOKE_DEPTH encoder and decoder layers where it is
# set, then prints the process's launch counts, the collectives it made by
# (backend, device, op), and, from the job's final state, its peak memory,
# the bytes of its parameters and Adam's moments and a digest of each of
# its replicated parameters' bytes, with the seconds it took to make the
# job, save and restore checkpoints, reach the final save and end, and,
# where $CHIP_SMOKE_PROFILE_STEP names a step of a Wav2Vec2 job, that
# step's launches (``ProfiledStep``); a run past 600 s prints every
# thread's stack and exits.
PAR_CLI = (
    "import contextlib, faulthandler, hashlib, json, os, runpy, sys, time\n"
    "import torch\n"
    "t0 = time.perf_counter()\n"
    "faulthandler.dump_traceback_later(600, exit=True)\n"
    "from tethys_tpu_torch.ops import sharding\n"
    "from tethys_tpu_torch.train import jobs\n"
    "from tethys_tpu_torch.utils import kernel_lib\n"
    "from tethys_tpu_torch import checkpoint\n"
    "from chip_smoke import ProfiledStep, whisper_depth\n"
    "depth = int(os.environ.get('CHIP_SMOKE_DEPTH', '0'))\n"
    "seen, real = {}, jobs.finalize_job\n"
    "def timed(name, fn):\n"
    "    def run(*args, **kwargs):\n"
    "        t = time.perf_counter()\n"
    "        out = fn(*args, **kwargs)\n"
    "        seen[name] = seen.get(name, 0) + time.perf_counter() - t\n"
    "        return out\n"
    "    return run\n"
    "cm = checkpoint.CheckpointManager\n"
    "cm.save = timed('s_checkpoint_save', cm.save)\n"
    "cm.restore_like = timed('s_checkpoint_restore', cm.restore_like)\n"
    "jobs.make_whisper_job = timed('s_make_job', jobs.make_whisper_job)\n"
    "jobs.make_wav2vec2_job = timed('s_make_job', jobs.make_wav2vec2_job)\n"
    "profile_at = int(os.environ.get('CHIP_SMOKE_PROFILE_STEP', '-1'))\n"
    "profiled, made = [], jobs.make_wav2vec2_job\n"
    "def with_profile(*args, **kwargs):\n"
    "    job = made(*args, **kwargs)\n"
    "    if profile_at < 0:\n"
    "        return job\n"
    "    profiled.append(ProfiledStep(job.step_fn, profile_at))\n"
    "    return job._replace(step_fn=profiled[-1])\n"
    "jobs.make_wav2vec2_job = with_profile\n"
    "def finalize(result, *args, **kwargs):\n"
    "    st = result.state\n"
    "    seen['param_bytes'] = sum(p.numel() * p.element_size()\n"
    "                              for p in st.model.parameters())\n"
    "    seen['adam_bytes'] = sum(t.numel() * t.element_size()\n"
    "                             for s in st.optimizer.state.values()\n"
    "                             for t in s.values()\n"
    "                             if torch.is_tensor(t) and t.dim())\n"
    "    seen['peak_bytes'] = torch.cuda.max_memory_allocated()\n"
    "    if profiled:\n"
    "        seen['profiled_step'] = profiled[-1].counts\n"
    "    sharded = getattr(st.model, '_tp_full_sizes', {})\n"
    "    seen['replicated'] = {n: hashlib.sha256(p.detach().cpu().contiguous()\n"
    "        .view(torch.uint8).numpy().tobytes()).hexdigest()\n"
    "        for n, p in st.model.named_parameters() if n not in sharded}\n"
    "    seen['s_to_finalize'] = time.perf_counter() - t0\n"
    "    real(result, *args, **kwargs)\n"
    "    seen['s_to_end'] = time.perf_counter() - t0\n"
    "jobs.finalize_job = finalize\n"
    "sys.argv[0] = sys.argv.pop(1)\n"
    "with whisper_depth(depth) if depth else contextlib.nullcontext():\n"
    "    runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)\n"
    "print('LAUNCHES ' + json.dumps(kernel_lib.launch_counts()))\n"
    "print('TRANSPORTS ' + json.dumps({' '.join(k): n for k, n in\n"
    "                                  sharding.TRANSPORTS.items()}))\n"
    "print('MEMORY ' + json.dumps(seen))\n")
PAR_WHISPER = "tethys_tpu_torch.jobs.whisper_dist"
# The collectives every process of the phase made, by "backend device op".
PAR_TRANSPORTS: dict = {}


def wait_all(procs, timeout: int) -> list:
    """The processes' stdouts (stderr merged), killing any left running."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def par_cli(ws: str, ranks: int, *flags: str, module: str = PAR_WHISPER,
            depth: int = 0, profile_step: int = -1) -> list:
    """``module`` (whisper_dist by default) with ``flags`` in ``ranks``
    processes of their own on the card (torchrun's env, every rank on
    cuda:0; ``ranks`` 1: no env, no group), in the workspace ``ws``,
    Whisper cut to ``depth`` encoder and decoder layers (0: its own), a
    Wav2Vec2 job's step ``profile_step`` profiled (-1: none): per rank its
    lines, step losses, launch counts, transports and memory."""
    with open(os.path.join(ws, "model.txt"), "w") as fh:
        fh.write("chip_smoke")
    os.makedirs(os.path.join(ws, "chip_smoke"), exist_ok=True)
    port = free_port()
    log(f"  {time.strftime('%H:%M:%S')} {ranks} x python -m {module} "
        + " ".join(flags))
    procs = []
    for r in range(ranks):
        env = {k: v for k, v in os.environ.items() if k not in DP_ENV}
        env.update(TETHYS_WORKSPACE=ws, TETHYS_RESULT=ws, PYTHONPATH=ROOT,
                   CHIP_SMOKE_DEPTH=str(depth),
                   CHIP_SMOKE_PROFILE_STEP=str(profile_step))
        if ranks > 1:
            env.update(WORLD_SIZE=str(ranks), RANK=str(r), LOCAL_RANK="0",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PAR_CLI, module, *flags], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    outs = wait_all(procs, 900)
    require(all(p.returncode == 0 for p in procs), "a rank failed:\n"
            + "\n----\n".join(out[-4000:] for out in outs))
    runs = []
    for out in outs:
        lines = out.splitlines()
        require("Error at step" not in out, "a step failed")
        steps = [ELAPSED_RE.match(line) for line in lines]
        steps = [(int(m[1]), float(m[2]), float(m[3])) for m in steps if m]

        def tagged(tag):
            return json.loads(next(line for line in lines
                                   if line.startswith(tag + " "))
                              [len(tag) + 1:])

        runs.append({"out": lines, "steps": steps,
                     "losses": [loss for _, loss, _ in steps],
                     "counts": tagged("LAUNCHES"),
                     "transports": tagged("TRANSPORTS"),
                     "memory": tagged("MEMORY")})
        add_counts(PAR_TRANSPORTS, runs[-1]["transports"])
    return runs


def whisper_numel(model_type: str, **overrides) -> int:
    """The parameters of a whole Whisper of ``model_type`` (no memory)."""
    from tethys_tpu_torch.configs import WhisperConfig
    from tethys_tpu_torch.models.whisper import WhisperForConditionalGeneration

    with torch.device("meta"):
        model = WhisperForConditionalGeneration(
            WhisperConfig.from_size(model_type, **overrides))
    return sum(p.numel() for p in model.parameters())


def run_tp_large_v3(gpu: str, child: dict) -> None:
    """Phase 21(a): whisper_dist --model_size large-v3 --tp 2
    --remat_layers --batch_size 1 --num_batches 4 --dtype bfloat16 in a
    world of 2 gloo ranks on the card, at PAR_V3_DEPTH layers: both exit 0
    with one finite loss a step, launch the training kernels and keep at
    most PAR_ADAM_SHARE of the unsharded f32 parameters and Adam moments;
    rank 0's checkpoint then restores with --resume into a one-process run
    (``run_resume``)."""
    import shutil

    from tethys_tpu_torch.jobs import whisper_dist

    whole = whisper_numel("large-v3", encoder_layers=PAR_V3_DEPTH,
                          decoder_layers=PAR_V3_DEPTH) * 4 * 3  # params, m, v
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        log(f"  workspace {ws}: {shutil.disk_usage(ws).free / 2 ** 30:.1f} "
            "GiB free")
        flags = ("--model_size", "large-v3", "--remat_layers", "--batch_size",
                 "1", "--dtype", "bfloat16")
        t0 = time.perf_counter()
        runs = par_cli(ws, PAR_RANKS, *flags, "--tp", "2", "--num_batches",
                       str(PAR_V3_STEPS), "--backend", "gloo",
                       depth=PAR_V3_DEPTH)
        seconds = time.perf_counter() - t0
        for r, run in enumerate(runs):
            add_counts(child, run["counts"])
            mem = run["memory"]
            share = (mem["param_bytes"] + mem["adam_bytes"]) / whole
            steps = [i for i, _, _ in run["steps"]]
            ms = ((run["steps"][-2][2] - run["steps"][0][2])
                  / (PAR_V3_STEPS - 2) * 1e3)
            seconds_by = {k: round(v, 1) for k, v in mem.items()
                          if k.startswith("s_")}
            log(f"  21(a) rank {r} seconds: {seconds_by}, the loop "
                f"{run['steps'][-1][2]:.1f} to its last step's line")
            log(f"  21(a) rank {r}: losses {run['losses']}, "
                f"{ms:.2f} ms/step over steps 1-{PAR_V3_STEPS - 2} (gloo), "
                f"peak {mem['peak_bytes'] / 2 ** 30:.3f} GiB, params + Adam "
                f"{(mem['param_bytes'] + mem['adam_bytes']) / 2 ** 30:.3f} "
                f"GiB = {share:.4f} of the unsharded {whole / 2 ** 30:.3f} "
                f"GiB; launches {run['counts']}; collectives "
                f"{run['transports']} ({gpu})")
            require(steps == list(range(PAR_V3_STEPS))
                    and all(np.isfinite(run["losses"])),
                    f"rank {r}'s step lines {run['steps']}")
            require(f"process group: gloo, rank {r} of {PAR_RANKS}"
                    in run["out"], f"rank {r} joined no gloo group")
            require(share <= PAR_ADAM_SHARE, f"rank {r} holds {share:.4f} of "
                    "the unsharded params and Adam moments")
            # Not dropout_window: whisper's activation_dropout is 0, so the
            # TP path drops whole tensors only (21(b) runs fc1's columns).
            rose = ("flash_fwd_dropout", "flash_bwd", "split_heads",
                    "merge_heads", "dropout")
            require(all(run["counts"][k] for k in rose), f"rank {r} launched "
                    f"no {[k for k in rose if not run['counts'][k]]}")
        require(runs[0]["losses"] == runs[1]["losses"],
                "the two ranks logged other losses")
        log(f"  21(a) the TP world took {seconds:.1f} s (two processes: "
            "model made on the CPU, sharded, 4 steps, the whole checkpoint "
            "and final weights gathered and written by rank 0)")
        run_resume("21(a)", whisper_dist, ws, flags,
                   "whisper_large-v3_epoch_1", depth=PAR_V3_DEPTH)


def par_rank(mode: str, rank: str, port: str, out_dir: str) -> int:
    """A rank of phase 21(b, c, e), 22(c, e) or 23(b) (``chip_smoke.py
    --par_rank MODE R PORT DIR``): "tp" whisper-base f32 over (data 1,
    model 2): 2 Keras-Adam steps, rates 0, then greedy decoding (kv_quant
    none and int8), then whisper-small f32 over (data 1, seq 2) in the
    same world, the config's dropout and activation_dropout, attention's
    0 (21(c)); "w2v" wav2vec2-base f32 over (data 1, model 2), then over
    (data 1, seq 2) in the same world: 2 hardened steps at rate 0, then
    at the config's dropout, unrolled and then on the stacked layout
    (22(e), with the stacked bf16 job's steps; ``w2v_world``); "pp"
    whisper-base f32 over (data 1, stage 2): one PP step (``pp_steps``),
    every rank's results saved."""
    sys.path.insert(0, ROOT)
    from tethys_tpu_torch.ops import flash_attention
    from tethys_tpu_torch.ops import sharding
    from tethys_tpu_torch.parallel import mesh
    from tethys_tpu_torch.utils import kernel_lib
    from tethys_tpu_torch.utils.device import require_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    shapes = []
    real = flash_attention.flash_fwd_cuda

    def spy(q, k, *args):
        shapes.append((q.shape[1], k.shape[1]))
        return real(q, k, *args)

    flash_attention.flash_fwd_cuda = spy
    with torchrun_env(PAR_RANKS, int(rank), int(port)):
        mesh.initialize_distributed(backend="gloo")
        try:
            dev = require_cuda()
            if mode == "tp":
                layout = mesh.make_2d_mesh(model_parallel=PAR_RANKS)
                window = kernel_lib.DROPOUT_WINDOW.launches
                with deterministic_cudnn():
                    out = par_steps(dev, MODEL, layout, NO_DROPOUT)
                    out["dropout"] = par_steps(dev, MODEL, layout,
                                               PAR_TP_DROPOUT)
                out["dropout"]["window_launches"] = (
                    kernel_lib.DROPOUT_WINDOW.launches - window)
                out["decode"] = {v: par_decode(dev, *v, layout)
                                 for v in PAR_DECODES}
                # 21(c)'s SP steps in the same world, over (data 1, seq 2).
                layout = mesh.make_seq_mesh(seq_parallel=PAR_RANKS)
                window, start = kernel_lib.DROPOUT_WINDOW.launches, len(shapes)
                t0 = time.perf_counter()
                with deterministic_cudnn():
                    out["sp"] = par_steps(dev, "small", layout,
                                          {"attention_dropout": 0.0})
                out["sp"]["seconds"] = time.perf_counter() - t0
                out["sp"]["window_launches"] = (
                    kernel_lib.DROPOUT_WINDOW.launches - window)
                out["sp"]["flash_shapes"] = shapes[start:]
            elif mode == "pp":   # 23(b)
                layout = mesh.make_pp_mesh(PAR_RANKS)
                with deterministic_cudnn():
                    out = pp_steps(dev, layout)
            else:   # 22(c, e): Wav2Vec2 over (data 1, model 2), then over
                # (data 1, seq 2) in the same world
                out = {"w2v_tp": w2v_world(dev, "w2v_tp", mesh.make_2d_mesh(
                    model_parallel=PAR_RANKS))}
                out["w2v_sp"] = w2v_world(dev, "w2v_sp", mesh.make_seq_mesh(
                    seq_parallel=PAR_RANKS))
        finally:
            mesh.shutdown_distributed()
    out.update(launches=kernel_lib.launch_counts(), flash_shapes=shapes,
               transports={" ".join(k): n
                           for k, n in sharding.TRANSPORTS.items()})
    if rank == "0" or mode == "pp":
        torch.save(out, os.path.join(out_dir, f"rank_{rank}.pt"))
    return 0


def par_steps(device, model_type: str, layout, overrides: dict) -> dict:
    """PAR_STEPS Keras-Adam steps of ``model_type`` in f32 from SEED on
    PAR_BATCH rows of the synthetic dataset a replica, over ``layout`` (None:
    one process, no group): the losses, the whole gradients of the first
    step (what the optimizer takes) and the whole parameters after the
    last, on the host."""
    from tethys_tpu_torch import data
    from tethys_tpu_torch.models.whisper import create_whisper_model
    from tethys_tpu_torch.parallel import dp, tp

    model, _ = create_whisper_model(model_type, device="cpu", seed=SEED,
                                    param_dtype=torch.float32, **overrides)
    sharded = layout is not None and layout.axis == "model"
    if sharded:
        tp.shard_model(model, layout)
    model.to(device).train()
    opt = dp.whisper_optimizer(model.parameters(), PAR_LR)
    step = dp.make_train_step(
        lambda m, b, g: (m(b[0], labels=b[1], generator=g)["loss"], {}),
        opt, layout=layout)
    grads, adam_step = [], opt.step

    def whole(tensors):
        host = {n: t.detach() for n, t in tensors.items()}
        if sharded:
            host = tp.gather_named(host, model, layout)
        return {n: t.float().cpu() for n, t in host.items()}

    def record():
        if not grads:
            grads.append(whole({n: p.grad for n, p in model.named_parameters()
                                if p.grad is not None}))
        adam_step()

    opt.step = record
    batches = iter(data.create_whisper_dummy_dataset(PAR_BATCH))
    state, losses = dp.TrainState(model, opt, layout), []
    for i in range(PAR_STEPS):
        features, labels = next(batches)
        state, loss = step(state, (torch.from_numpy(features).to(device),
                                   torch.from_numpy(labels).to(device)),
                           dp.step_generator(SEED, i))
        losses.append(loss.item())
    return {"losses": losses, "grads": grads[0],
            "params": whole(dict(model.named_parameters()))}


def par_decode(device, kv_quant: str, fused: bool, layout) -> dict:
    """Greedy decoding of whisper-base f32 from SEED on PAR_BATCH seeded
    30 s clips, PAR_DECODE_STEPS steps, the projections fused
    (TETHYS_FUSED_QKV=1) or not, sharded over ``layout``'s model group
    (None: one process): tokens, length, the heads each decode kernel saw
    and the launch counts."""
    from tethys_tpu_torch.audio.frontend import prepare_input_features
    from tethys_tpu_torch.models.whisper import (
        create_whisper_model,
        greedy_generate,
    )
    from tethys_tpu_torch.parallel import tp

    model, _ = create_whisper_model(MODEL, device="cpu", seed=SEED,
                                    kv_quant=kv_quant)
    if layout is not None:
        tp.shard_model(model, layout)
    model.to(device)
    with torch.inference_mode():
        features = prepare_input_features(
            torch.from_numpy(seeded_audio(PAR_BATCH, SEED)).to(device),
            n_frames=3000)
    out = {}
    with fused_qkv(fused):
        out["counts"] = counts_around(lambda: out.update(zip(
            ("tokens", "length"), (t.cpu() for t in greedy_generate(
                model, features, max_length=PAR_DECODE_STEPS)))))
    out["heads"] = model.model.decoder.layers[0].self_attn.heads()
    return out


def par_world(mode: str) -> dict:
    """Rank 0's results of a 2-rank ``par_rank`` world on the card, with
    the other ranks' under "others" where they saved theirs, and both
    ranks' outputs logged when one fails."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--par_rank", mode,
             str(r), port, tmp], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(PAR_RANKS)]
        outs = wait_all(procs, 600)
        require(all(p.returncode == 0 for p in procs), f"a {mode} rank "
                "failed:\n" + "\n----\n".join(o[-3000:] for o in outs))
        out = torch.load(os.path.join(tmp, "rank_0.pt"))
        out["others"] = [torch.load(os.path.join(tmp, f"rank_{r}.pt"))
                         for r in range(1, PAR_RANKS)
                         if os.path.exists(os.path.join(tmp, f"rank_{r}.pt"))]
    for run in [out] + out["others"]:
        add_counts(PAR_TRANSPORTS, run["transports"])
    return out


def check_par_steps(name: str, got: dict, want: dict,
                    lr: float = PAR_LR, steps: int = PAR_STEPS,
                    loss_rel: float = 1e-4) -> None:
    """Phase 6's tolerances: losses 1e-4 relative (or ``loss_rel``), each
    gradient within 1e-3 of the reference's norm + 1e-6, parameters within
    2 * lr * steps (Keras Adam moves a weight by about lr * sign(g) a
    step)."""
    log(f"  {name}: losses {got['losses']}, one process {want['losses']}")
    check(f"{name} losses (relative)",
          max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   want["losses"])), loss_rel)
    require(set(got["grads"]) == set(want["grads"]),
            f"{name}: gradients of {set(got['grads']) ^ set(want['grads'])}")
    worst = 0.0
    for n, g in want["grads"].items():
        gap = (got["grads"][n] - g).norm().item()
        bound = 1e-3 * g.norm().item() + 1e-6
        require(gap <= bound, f"{name}: gradient of {n} {gap:.3e} > "
                              f"{bound:.3e}")
        worst = max(worst, gap / bound)
    norms = [torch.linalg.vector_norm(torch.stack(
        [g.norm() for g in run["grads"].values()])).item()
        for run in (got, want)]
    log(f"  {name}: summed gradient norm {norms[0]:.6e}, one process "
        f"{norms[1]:.6e}; worst gradient gap {worst:.3f} of its bound")
    check(f"{name} summed gradient norm (relative)",
          abs(norms[0] - norms[1]) / norms[1], 1e-3)
    check(f"{name} parameters after the last step",
          max(max_err(got["params"][n], p)
              for n, p in want["params"].items()), 2 * lr * steps)


# 21(c)'s SP steps, which run in 21(b)'s world after its TP cases.
PAR_SP_WORLD: dict = {}


def run_tp_equality(child: dict) -> None:
    """Phase 21(b) and (e): a 2-rank TP world of whisper-base on the card
    (f32, rates 0, cuDNN deterministic; then greedy decoding) against one
    process without a group.  The world then runs 21(c)'s SP steps, which
    ``run_sp`` checks."""
    from tethys_tpu_torch.utils.device import require_cuda

    got = par_world("tp")
    add_counts(child, got["launches"])
    PAR_SP_WORLD.update(got.pop("sp"))
    dev = require_cuda()
    with deterministic_cudnn():
        want = par_steps(dev, MODEL, None, NO_DROPOUT)
    check_par_steps("21(b) TP whisper-base f32", got, want)
    with deterministic_cudnn():
        want = par_steps(dev, MODEL, None, PAR_TP_DROPOUT)
    check_par_steps("21(b) TP whisper-base f32, dropout and "
                    "activation_dropout on", got["dropout"], want)
    log(f"  21(b) rank 0's dropouts on fc1's columns: "
        f"{got['dropout']['window_launches']} launches")
    require(got["dropout"]["window_launches"] > 0, "21(b) the TP steps with "
            "activation_dropout launched no dropout on a shard")
    log(f"  21(b) rank 0's collectives {got['transports']}")
    for (kv_quant, fused), run in got["decode"].items():
        ref = par_decode(dev, kv_quant, fused, None)
        kernels = ["decode_self"] + (["q8_cross"] if kv_quant == "int8"
                                     else []) + (["proj_split", "merge_proj"]
                                                 if fused else [])
        name = f"kv_quant {kv_quant}" + (", fused projections" if fused
                                         else "")
        log(f"  21(e) {name}: TP tokens {run['tokens'].tolist()}, length "
            f"{int(run['length'])}; {run['heads']} of {ref['heads']} heads a "
            f"rank; launches {({k: run['counts'][k] for k in kernels})}")
        require(torch.equal(run["tokens"], ref["tokens"])
                and int(run["length"]) == int(ref["length"]),
                f"21(e) {name}: TP tokens differ from one process's "
                f"{ref['tokens'].tolist()}")
        require(run["heads"] * PAR_RANKS == ref["heads"]
                and all(run["counts"][k] for k in kernels),
                f"21(e) {name}: heads {run['heads']}, launches "
                f"{run['counts']}")


def run_sp(child: dict) -> None:
    """Phase 21(c): whisper_dist --model_size small --sp 2 --batch_size 2
    --num_batches 4 --dtype bfloat16 in a 2-rank gloo world, then the SP
    steps of whisper-small f32 with the config's dropout (attention's 0)
    that 21(b)'s world ran, against one process: the dropout window holds
    the unsharded mask through whole steps."""
    from tethys_tpu_torch.utils.device import require_cuda

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        runs = par_cli(ws, PAR_RANKS, "--model_size", "small", "--sp", "2",
                       "--batch_size", "2", "--num_batches",
                       str(PAR_SP_STEPS), "--dtype", "bfloat16",
                       "--backend", "gloo")
    for r, run in enumerate(runs):
        add_counts(child, run["counts"])
        require([i for i, _, _ in run["steps"]] == list(range(PAR_SP_STEPS))
                and all(np.isfinite(run["losses"])),
                f"21(c) rank {r}'s step lines {run['steps']}")
        # The encoder layers' dropouts draw the rank's rows of the mask.
        require(run["counts"]["dropout_window"] > 0, f"21(c) rank {r} "
                f"launched no dropout on a shard: {run['counts']}")
    require(runs[0]["losses"] == runs[1]["losses"],
            "the two SP ranks logged other losses")
    log(f"  21(c) whisper_dist --sp 2, small b2 bf16: losses "
        f"{runs[0]['losses']}, peak "
        f"{runs[0]['memory']['peak_bytes'] / 2 ** 30:.3f} GiB a rank; "
        f"collectives {runs[0]['transports']}")
    got = PAR_SP_WORLD
    require(got["window_launches"] > 0, "21(c) the SP steps launched no "
            "dropout on a shard")
    want = par_steps(require_cuda(), "small", None,
                     {"attention_dropout": 0.0})
    check_par_steps("21(c) SP whisper-small f32, dropout on", got, want)
    encoder = sorted({s for s in got["flash_shapes"] if s[0] != s[1]})
    log(f"  21(c) rank 0's flash forward launches at (Tq, Tk): "
        f"{ {s: got['flash_shapes'].count(s) for s in set(got['flash_shapes'])} }"
        f"; dropout_window {got['window_launches']}; the SP steps took "
        f"{got['seconds']:.1f} s in 21(b)'s world")
    require((750, 1500) in encoder, f"no flash launch at Tq 750, Tk 1500: "
            f"{got['flash_shapes']}")


def run_dropout_window(gpu: str, results: dict) -> None:
    """Phase 21(d): csrc/dropout.cu on a shard of [16, 1500, 512] (the last
    750 rows; the last 256 columns), f32 and bf16, forward and backward,
    equals its plain version and the slice of the whole tensor's launch,
    bit for bit; the bf16 shards' times beside the whole's and F.dropout's
    on the shard.  The bf16 row shard is the kernel table's dropout_window
    entry."""
    from tethys_tpu_torch.ops import dropout

    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(16, 1500, 512, device="cuda").to(dtype)
        tag = str(dtype)[6:]
        whole, _ = check_dropout_launch(f"21(d) dropout {tag} [16, 1500, 512]",
                                        x, 4321)
        shards = {
            "rows 750-1499 of 1500": (x[:, 750:].contiguous(),
                                      dropout.Window(row0=750, rows=1500),
                                      whole[:, 750:]),
            "columns 256-511 of 512": (x[..., 256:].contiguous(),
                                       dropout.Window(col0=256, cols=512),
                                       whole[..., 256:]),
        }
        if dtype == torch.bfloat16:
            whole_ms = event_ms(lambda: dropout.dropout_cuda(
                x, DROPOUT_RATE, 4321))
            log(f"  dropout.cu [16, 1500, 512] bf16 whole: {whole_ms:.4f} ms "
                f"({gpu})")
        for name, (shard, window, want) in shards.items():
            label = f"21(d) dropout_window {tag} [16, 1500, 512], {name}"
            got, err = check_dropout_launch(label, shard, 4321, window, want)
            log_dropout_plan(label, shard, window)
            if dtype != torch.bfloat16:
                continue
            ms, bound_ms, plain_ms, library = dropout_times(shard, window)
            log_row("dropout_window", f"[16, 1500, 512] bf16, {name}", ms,
                    bound_ms, plain_ms, library_ms=library)
            if "rows" in name:
                results["dropout_window"] = {
                    "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
                    "library_ms": library}


# Phase 22: Wav2Vec2's tensor and sequence parallelism, 2 gloo ranks
# sharing the card, as phase 21 runs Whisper's.
W2V_DIST = "tethys_tpu_torch.jobs.wav2vec2_dist"
W2V_PAR_BATCH = 8        # rows a replica in 22(a, b): gloo copies each
W2V_PAR_STEPS = 4        # conv's gathered channels through the host
W2V_NO_DROPOUT = dict(hidden_dropout=0.0, activation_dropout=0.0,
                      attention_dropout=0.0)
# 22(a, b) and 22(e)(ii) profile this step of W2V_PAR_STEPS (the last).
W2V_PROFILED_STEP = W2V_PAR_STEPS - 1
# 22(a, b)'s rank 0 by flag: ms/step, params + Adam share and the profiled
# step's launches, which 22(e)(ii) logs beside the stacked layout's.
W2V_UNROLLED: dict = {}
# The kernels each rank of 22(a) and (b) must launch: GroupNorm's four on
# the channel shards (TP) or the whole channels (SP), and dropout on the
# shards' windows (TP: heads and the FFN's columns; SP: rows).
W2V_PAR_KERNELS = ("gn_stats", "gn_grad_sums", "gn_apply", "gn_apply_bwd",
                   "dropout", "dropout_window")
# 22(d): conv_0's output at b32 on 2 s clips over 2 ranks, [32, 6400, 256]
# in 8 of the 16 groups, and the attention probabilities of 22(a)'s b8:
# [8, 12, 99, 99], 6 heads a rank under TP, 50 or 49 query rows under SP.
GN_SHARD = (32, 6400, 256, 8)
PROBS = (W2V_PAR_BATCH, 12, 99, 99)


def w2v_par_steps(device, layout, overrides: dict, scan_layers: bool = False,
                  clip_grads: bool = False) -> dict:
    """W2V_F32_STEPS hardened wav2vec2_optimizer steps of wav2vec2-base in
    f32 from SEED on W2V_F32_BATCH 2 s clips with fixed negatives, over
    ``layout`` (None: one process, no group) with ``overrides`` of the
    config's dropout rates, on the stacked encoder layout with
    ``scan_layers``: the losses, the whole gradients of the first
    step (what Adam takes, after both clips' inputs: the summed, clipped
    gradients), the whole parameters after the last, and the quantizer's
    first indices and distances, on the host; with ``clip_grads`` also
    the first step's whole gradients as the global clip takes them (after
    the model or seq group's sums), unstacked ("clip_grads")."""
    from tethys_tpu_torch import data, losses
    from tethys_tpu_torch.models import wav2vec2
    from tethys_tpu_torch.parallel import dp, tp

    sharded = layout is not None and layout.axis == "model"
    model, config = wav2vec2.create_full_model(
        "pretraining", W2V_MODEL, device="cpu" if sharded else device,
        seed=SEED, scan_layers=scan_layers, **overrides)
    if sharded:
        tp.shard_model(model, layout)
    model.to(device).train()
    opt = dp.wav2vec2_optimizer(model.parameters(), W2V_LR)
    codes = []

    def loss_fn(mod, batch, generator):
        audio, negatives = batch
        out = mod(audio, generator=generator)
        if not codes:
            codes.append((out["codevector_indices"].cpu(),
                          out["codevector_distances"].float().cpu()))
        return wav2vec2.pretraining_loss(config, out,
                                         negative_indices=negatives)

    step = dp.make_train_step(loss_fn, opt, hardened=True, layout=layout)
    grads, adam_step = [], opt.step

    def whole(tensors):
        host = {n: t.detach() for n, t in tensors.items()}
        if sharded:
            host = tp.gather_named(host, model, layout)
        return {n: t.float().cpu() for n, t in host.items()}

    def record():
        if not grads:
            grads.append(whole({n: p.grad for n, p in model.named_parameters()
                                if p.grad is not None}))
        adam_step()

    opt.step = record
    at_clip, real_clip = [], dp.clip_by_global_norm

    def snapshot(tensors, *args):
        if not at_clip:
            at_clip.append(wav2vec2.unstack_layer_params(whole(
                {n: p.grad for n, p in model.named_parameters()
                 if p.grad is not None})))
        return real_clip(tensors, *args)

    if clip_grads:
        dp.clip_by_global_norm = snapshot
    clips = iter(data.create_wav2vec2_dummy_dataset(W2V_F32_BATCH,
                                                    W2V_SAMPLES))
    frames = config.downsampled_length(W2V_SAMPLES)
    state, losses_seen = dp.TrainState(model, opt, layout), []
    try:
        for i in range(W2V_F32_STEPS):
            audio = torch.from_numpy(next(clips)[0]).to(device)
            negatives = losses.sample_negative_indices(
                torch.Generator().manual_seed(200 + i), W2V_F32_BATCH, frames,
                config.num_negatives)
            state, loss = step(state, (audio, negatives),
                               dp.step_generator(SEED, i))
            losses_seen.append(loss.item())
    finally:
        dp.clip_by_global_norm = real_clip
    out = {"losses": losses_seen, "grads": grads[0],
           "params": whole(dict(model.named_parameters())),
           "indices": codes[0][0], "distances": codes[0][1]}
    if clip_grads:
        out["clip_grads"] = at_clip[0]
    return out


def w2v_world(device, mode: str, layout) -> dict:
    """Phase 22(c, e) in a rank of the "w2v" world over ``layout``: the
    hardened f32 steps at rate 0 (with the first gradients at the clip)
    and at the config's dropout, unrolled, then on the stacked layout
    ("scan"), then the stacked bf16 job (``w2v_scan_job``); the launches
    of the whole and of the stacked runs ("scan_launches")."""
    from tethys_tpu_torch.utils import kernel_lib

    torch.cuda.synchronize()
    start = kernel_lib.launch_counts()
    with deterministic_cudnn():
        out = w2v_par_steps(device, layout, W2V_NO_DROPOUT, clip_grads=True)
        out["dropout"] = w2v_par_steps(device, layout, {})
        torch.cuda.synchronize()
        before = kernel_lib.launch_counts()
        out["scan"] = w2v_par_steps(device, layout, W2V_NO_DROPOUT,
                                    scan_layers=True, clip_grads=True)
        out["scan"]["dropout"] = w2v_par_steps(device, layout, {},
                                               scan_layers=True)
    out["scan_job"] = w2v_scan_job(device, mode)
    torch.cuda.synchronize()
    after = kernel_lib.launch_counts()
    out["launches"] = {k: n - start[k] for k, n in after.items()}
    out["scan_launches"] = {k: n - before[k] for k, n in after.items()}
    return out


def w2v_scan_job(device, mode: str) -> dict:
    """Phase 22(e)(ii), in a rank of the "w2v_tp" or "w2v_sp" world:
    ``make_wav2vec2_job(scan_layers=True)`` at 22(a, b)'s shape
    (wav2vec2-base b8 a replica, bf16 on f32 masters, the config's
    dropout) under ``tensor_parallel`` or ``seq_parallel`` 2, W2V_PAR_STEPS
    steps of its synthetic data, the last profiled (``ProfiledStep``):
    the losses, ms/step over the unprofiled steps after the first (two
    gloo ranks on one card: no speed claim), the profiled step's
    launches, the bytes of the parameters and Adam's moments, and the
    collectives the steps made by op and the bytes of the last one's."""
    import gc

    from tethys_tpu_torch.ops import sharding
    from tethys_tpu_torch.parallel import dp
    from tethys_tpu_torch.train import jobs

    par = ({"tensor_parallel": PAR_RANKS} if mode == "w2v_tp"
           else {"seq_parallel": PAR_RANKS})
    job = jobs.make_wav2vec2_job(
        "pretraining", W2V_MODEL, W2V_PAR_BATCH, compute_dtype="bfloat16",
        audio_length=W2V_SAMPLES, device=device, seed=SEED,
        scan_layers=True, **par)
    step = ProfiledStep(job.step_fn, W2V_PROFILED_STEP)
    state, batches = job.state, iter(job.dataset)
    before = dict(sharding.TRANSPORTS)
    losses, seconds = [], []
    for i in range(W2V_PAR_STEPS):
        batch = job.prepare_batch(next(batches))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch, dp.step_generator(
            SEED, i, state.layout.data_rank))
        losses.append(loss.item())
        seconds.append(time.perf_counter() - t0)
    out = {
        "losses": losses,
        "ms": statistics.mean(seconds[1:W2V_PROFILED_STEP]) * 1e3,
        **step.counts,
        "param_bytes": sum(p.numel() * p.element_size()
                           for p in state.model.parameters()),
        "adam_bytes": sum(t.numel() * t.element_size()
                          for s in state.optimizer.state.values()
                          for t in s.values()
                          if torch.is_tensor(t) and t.dim()),
        "transports": {" ".join(k): n - before.get(k, 0)
                       for k, n in sharding.TRANSPORTS.items()
                       if n > before.get(k, 0)},
        "collective_bytes": dict(step.collective_bytes)}
    del job, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def argmin_flips(name: str, got, want, distances) -> int:
    """Phase 8's rule: the quantizer's indices of a run against the
    reference's, a flip only at a tie of the reference's distances (1e-5
    relative); returns the flips."""
    diff = got != want
    if diff.any():
        d = distances.gather(-1, got[..., None])[..., 0][diff]
        d_min = distances.gather(-1, want[..., None])[..., 0][diff]
        gap = ((d - d_min).abs() / d_min.abs().clamp_min(1e-6)).max()
        require(gap.item() <= 1e-5, f"{name}: argmin differs off a tie: {gap}")
    return int(diff.sum())


def run_w2v_par_cli(gpu: str, child: dict, flag: str) -> None:
    """Phase 22(a) (``flag`` "--tp") and (b) ("--sp"): wav2vec2_dist
    --model_size base <flag> 2 --batch_size 8 --num_batches 4 --dtype
    bfloat16 --backend gloo from torchrun's env, two ranks on the card:
    both exit 0 with the same finite losses, launch W2V_PAR_KERNELS and
    end with their replicated parameters bitwise equal; under TP each
    holds at most PAR_ADAM_SHARE of the unsharded f32 parameters and Adam
    moments, and rank 0's whole checkpoint then restores with --resume into
    a one-process run (``run_resume``)."""
    from tethys_tpu_torch.configs import Wav2Vec2Config
    from tethys_tpu_torch.jobs import wav2vec2_dist
    from tethys_tpu_torch.models.wav2vec2 import Wav2Vec2ForPreTraining

    tag = {"--tp": "22(a)", "--sp": "22(b)"}[flag]
    with torch.device("meta"):
        numel = sum(p.numel() for p in Wav2Vec2ForPreTraining(
            Wav2Vec2Config.from_size(W2V_MODEL)).parameters())
    whole = numel * 4 * 3                              # f32 params, m and v
    flags = ("--model_size", W2V_MODEL, "--batch_size", str(W2V_PAR_BATCH),
             "--dtype", "bfloat16")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        t0 = time.perf_counter()
        runs = par_cli(ws, PAR_RANKS, *flags, flag, str(PAR_RANKS),
                       "--num_batches", str(W2V_PAR_STEPS), "--backend",
                       "gloo", module=W2V_DIST,
                       profile_step=W2V_PROFILED_STEP)
        seconds = time.perf_counter() - t0
        for r, run in enumerate(runs):
            add_counts(child, run["counts"])
            mem = run["memory"]
            share = (mem["param_bytes"] + mem["adam_bytes"]) / whole
            # Step 1's line comes once step 2 is queued: one whole step
            # (the profiled last step comes after step 2's line).
            ms = (run["steps"][1][2] - run["steps"][0][2]) * 1e3
            if r == 0:
                W2V_UNROLLED[flag] = {"ms": ms, "share": share,
                                      **mem["profiled_step"]}
            log(f"  {tag} rank {r}: losses {run['losses']}, {ms:.2f} ms/step "
                f"over step 1 (two gloo ranks sharing "
                f"one card: not NVLink's speed), peak "
                f"{mem['peak_bytes'] / 2 ** 30:.3f} GiB, params + Adam "
                f"{(mem['param_bytes'] + mem['adam_bytes']) / 2 ** 30:.3f} "
                f"GiB = {share:.4f} of the unsharded {whole / 2 ** 30:.3f} "
                f"GiB; seconds "
                f"{ {k: round(v, 1) for k, v in mem.items() if k.startswith('s_')} }; "
                f"launches {run['counts']}; step {W2V_PROFILED_STEP} "
                f"profiled: {mem['profiled_step']}; collectives "
                f"{run['transports']} ({gpu})")
            require([i for i, _, _ in run["steps"]]
                    == list(range(W2V_PAR_STEPS))
                    and all(np.isfinite(run["losses"])),
                    f"{tag} rank {r}'s step lines {run['steps']}")
            require(f"process group: gloo, rank {r} of {PAR_RANKS}"
                    in run["out"], f"{tag} rank {r} joined no gloo group")
            missing = [k for k in W2V_PAR_KERNELS if not run["counts"][k]]
            require(not missing, f"{tag} rank {r} launched no {missing}")
            if flag == "--tp":
                require(share <= PAR_ADAM_SHARE, f"{tag} rank {r} holds "
                        f"{share:.4f} of the unsharded params and Adam moments")
        require(runs[0]["losses"] == runs[1]["losses"],
                f"{tag}: the two ranks logged other losses")
        digests = [run["memory"]["replicated"] for run in runs]
        differ = [n for n, d in digests[0].items() if digests[1][n] != d]
        require(not differ, f"{tag}: replicated parameters differ across "
                f"the ranks: {differ[:5]}")
        log(f"  {tag} {len(digests[0])} replicated parameters bitwise equal "
            f"on both ranks; the world took {seconds:.1f} s")
        if flag != "--tp":
            return
        run_resume(tag, wav2vec2_dist, ws, flags, "model_epoch_1")


def run_w2v_par_equality(child: dict) -> None:
    """Phase 22(c) and (e): wav2vec2-base f32 b2, 2 hardened steps over
    (data 1, model 2), then over (data 1, seq 2), in one world of two gloo
    ranks on the card (cuDNN deterministic), at rate 0 and at the config's dropout, unrolled
    and on the stacked layout, each against one process of its layout
    within phase 8's tolerances; the quantizer's indices flip only at ties
    (and a flip leaves the run's losses unheld, as in phase 8); then the
    stacked layout's own checks under each layout (``check_scan_world``)."""
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    with deterministic_cudnn():
        want = {"rates 0": w2v_par_steps(dev, None, W2V_NO_DROPOUT),
                "dropout on": w2v_par_steps(dev, None, {})}
        want_scan = {
            "rates 0": w2v_par_steps(dev, None, W2V_NO_DROPOUT,
                                     scan_layers=True),
            "dropout on": w2v_par_steps(dev, None, {}, scan_layers=True)}
    world = par_world("w2v")
    add_counts(child, world["launches"])
    log(f"  22(c, e): rank 0's collectives {world['transports']}")
    for mode, name in (("w2v_tp", "TP (data 1, model 2)"),
                       ("w2v_sp", "SP (data 1, seq 2)")):
        got = world[mode]
        require(got["launches"]["dropout_window"] > 0, f"22(c) {name}: no "
                f"dropout on a shard: {got['launches']}")
        for tag, runs, refs in (("22(c)", got, want),
                                ("22(e) stacked", got["scan"], want_scan)):
            for rates, run in (("rates 0", runs),
                               ("dropout on", runs["dropout"])):
                label = f"{tag} {name} wav2vec2-base f32, {rates}"
                flips = argmin_flips(label, run["indices"],
                                     refs[rates]["indices"],
                                     refs[rates]["distances"])
                log(f"  {label}: {flips} quantizer indices flip at ties")
                if flips:
                    log(f"  {label}: not held (a flip at a tie changes the "
                        "targets by design)")
                    continue
                check_par_steps(label, run, refs[rates], lr=W2V_LR)
        check_scan_world(name, mode, got)


def check_scan_world(name: str, mode: str, got: dict) -> None:
    """Phase 22(e)'s checks of rank 0's runs under one layout (its f32
    steps are held to one process by ``run_w2v_par_equality``): the
    stacked layout's first gradients as the global clip takes them,
    unstacked, against the same layout's unrolled run (each within phase 6's bound, the bitwise ones
    counted); the kernels its runs launched (``dropout_window``; under TP
    GroupNorm's four on the channel shard); the bf16 job's steps beside
    22(a, b)'s unrolled run of the same shape: ms/step, params + Adam a
    rank (TP), the profiled step's launches, Adam's and the clips' among
    them, and the collectives by op."""
    from tethys_tpu_torch.configs import Wav2Vec2Config
    from tethys_tpu_torch.models.wav2vec2 import Wav2Vec2ForPreTraining

    unrolled, stacked = got["clip_grads"], got["scan"]["clip_grads"]
    require(list(stacked) == list(unrolled),
            f"22(e) {name}: the gradients' names differ")
    same, worst = 0, 0.0
    for n, g in unrolled.items():
        gap = (stacked[n] - g).norm().item()
        bound = 1e-3 * g.norm().item() + 1e-6
        require(gap <= bound, f"22(e) {name}: stacked gradient of {n} "
                f"{gap:.3e} from the unrolled one's (> {bound:.3e})")
        same += torch.equal(stacked[n], g)
        worst = max(worst, (stacked[n] - g).abs().max().item())
    log(f"  22(e) {name}: the first gradients at the global clip, stacked "
        f"and unstacked against unrolled in the same world: {same} of "
        f"{len(unrolled)} tensors bit for bit, largest difference "
        f"{worst:.3e}")
    counts = got["scan_launches"]
    need = ("dropout_window",) + (("gn_stats", "gn_grad_sums", "gn_apply",
                                   "gn_apply_bwd") if mode == "w2v_tp"
                                  else ())
    log(f"  22(e) {name}: rank 0's launches on the stacked layout {counts}")
    missing = [k for k in need if not counts[k]]
    require(not missing, f"22(e) {name}: the stacked layout launched no "
            f"{missing}")
    job = got["scan_job"]
    flag = "--tp" if mode == "w2v_tp" else "--sp"
    unrolled_job = W2V_UNROLLED[flag]
    require(len(job["losses"]) == W2V_PAR_STEPS
            and all(np.isfinite(job["losses"])),
            f"22(e) {name}: bf16 losses {job['losses']}")
    with torch.device("meta"):
        numel = sum(p.numel() for p in Wav2Vec2ForPreTraining(
            Wav2Vec2Config.from_size(W2V_MODEL)).parameters())
    share = (job["param_bytes"] + job["adam_bytes"]) / (numel * 4 * 3)
    if mode == "w2v_tp":
        require(share <= PAR_ADAM_SHARE, f"22(e) {name}: rank 0 holds "
                f"{share:.4f} of the unsharded params and Adam moments")
    log(f"  22(e) {name} make_wav2vec2_job(scan_layers=True) base "
        f"b{W2V_PAR_BATCH} bf16, rank 0: losses {job['losses']}, "
        f"{job['ms']:.2f} ms/step (gloo on one card: no speed claim; "
        f"unrolled {flag} 2: {unrolled_job['ms']:.2f}); params + Adam "
        f"{share:.4f} of the unsharded f32 (unrolled "
        f"{unrolled_job['share']:.4f}); step {W2V_PROFILED_STEP}: "
        f"{job['launches']} launches, {job['adam_launches']} of them Adam "
        f"and the clips ({job['adam_ms']:.3f} device ms), device "
        f"{job['device_ms']:.2f} ms; unrolled {unrolled_job['launches']}, "
        f"{unrolled_job['adam_launches']} ({unrolled_job['adam_ms']:.3f} "
        f"ms), device {unrolled_job['device_ms']:.2f} ms; collectives by op "
        f"{job['transports']}, the last step's bytes "
        f"{job['collective_bytes']}")


def run_w2v_shard_kernels(gpu: str) -> None:
    """Phase 22(d), outside the path's counts: the GroupNorm kernels on the
    channel shard GN_SHARD in bf16 against their plain versions (phase 3's
    tolerances), with their times and bounds beside F.group_norm; then
    dropout.cu on the probabilities' windows (run_probs_windows)."""
    from tethys_tpu_torch.ops import group_norm as gn

    gen = torch.Generator(device="cuda").manual_seed(22)
    b, t, c, groups = GN_SHARD
    x = (torch.randn(b, t, c, device="cuda", generator=gen) + 3.0).bfloat16()
    dy = torch.randn(b, t, c, device="cuda", generator=gen).bfloat16()
    gamma = torch.randn(c, device="cuda", generator=gen)
    beta = torch.randn(c, device="cuda", generator=gen)
    tag = f"bf16 {list(GN_SHARD[:3])}, {groups} groups"
    mu, _, rstd = gn.group_moments_cuda(x, groups)
    want = gn.plain_group_moments(x, groups)
    check(f"22(d) gn_stats mean {tag}", max_err(mu, want[0]), 1e-5 * 4.0)
    check(f"22(d) gn_stats rstd (relative) {tag}",
          ((rstd - want[2]).abs() / want[2]).max().item(), 1e-4)
    check_pass(f"22(d) gn_apply {tag}",
               gn.apply_cuda(x, gamma, beta, mu, rstd, groups),
               gn.plain_apply(x, gamma, beta, mu, rstd, groups), 1e-5)
    sums, s = gn.grad_sums_cuda(x, dy, mu, rstd, gamma, groups)
    want_sums, want_s = gn.plain_grad_sums(x, dy, mu, rstd, gamma, groups)
    check(f"22(d) gn_grad_sums (of max) {tag}",
          max(rel_err(sums, want_sums), rel_err(s, want_s)), 1e-4)
    check_pass(f"22(d) gn_apply_bwd {tag}",
               gn.apply_bwd_cuda(x, dy, gamma, mu, rstd, s, groups),
               gn.plain_apply_bwd(x, dy, gamma, mu, rstd, s, groups), 1e-4)
    for bwd in (False, True):
        plan = gn.stats_launch(x, groups, gn.pack_elems(x), bwd)[0]
        log(f"  22(d) {'gn_grad_sums' if bwd else 'gn_stats'} {tag}: "
            f"{plan[0]} channel tiles, clusters of {plan[1]}, {plan[2]} "
            "clusters")
    gn_times(gn, x, dy, gamma, beta, groups)
    del x, dy

    run_probs_windows(gpu)


def run_probs_windows(gpu: str) -> None:
    """Phase 22(d)'s dropout: dropout.cu on the probabilities PROBS' head
    window (6 of 12) and query-row window (rows 50-98 of 99), f32 and bf16,
    forward and backward, each bit for bit against its plain version and
    the slice of the whole tensor's launch; the bf16 windows timed beside
    their bound and F.dropout on the shard.  T = 99 puts every segment of
    both windows off a multiple of 4 (the head window's base 6 * 99 * 99 is
    2 mod 4; the row window's segments start 2 or 0 mod 4)."""
    from tethys_tpu_torch.ops import dropout
    from tethys_tpu_torch.ops.attention import ProbsWindow, probs_dropout

    gen = torch.Generator(device="cuda").manual_seed(23)
    seed, heads, rows = 4321, PROBS[1], PROBS[2]
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        probs = torch.softmax(torch.randn(*PROBS, device="cuda",
                                          generator=gen), -1).to(dtype)
        whole = probs_dropout(probs, DROPOUT_RATE, seed)
        shards = {
            f"heads {heads // 2}-{heads - 1} of {heads}": (
                probs[:, heads // 2:].contiguous(),
                ProbsWindow(head0=heads // 2, heads=heads),
                whole[:, heads // 2:]),
            f"query rows {-(-rows // 2)}-{rows - 1} of {rows}": (
                probs[:, :, -(-rows // 2):].contiguous(),
                ProbsWindow(row0=-(-rows // 2), rows=rows),
                whole[:, :, -(-rows // 2):]),
        }
        for name, (shard, window, want_slice) in shards.items():
            got = probs_dropout(shard, DROPOUT_RATE, seed, window)
            require(torch.equal(got, want_slice), f"22(d) dropout on the "
                    f"probabilities' {name} is not the slice of the whole "
                    "launch")
            flat = shard.flatten(1, 2) if window.heads else shard
            mask = (dropout.Window(row0=window.head0 * rows, rows=heads * rows)
                    if window.heads else
                    dropout.Window(row0=window.row0, rows=rows))
            label = f"22(d) dropout_window {tag} {list(PROBS)} {name}"
            check_dropout_launch(label, flat, seed, mask,
                                 want_slice.reshape(flat.shape))
            log_dropout_plan(label, flat, mask)
            if dtype == torch.bfloat16:
                log_row("dropout_window", f"{list(PROBS)} bf16 probabilities, "
                        f"{name}", *dropout_times(flat, mask, shard))
    log(f"  22(d) ({gpu})")


# Phase 23: Whisper's pipeline parallelism, 2 gloo ranks sharing the card
# as in phases 21-22: correctness, each rank's memory and the hops' bytes,
# not a hop's speed over NVLink.
PP_STEPS = 4
PP_BATCH = 4            # 23(a): rows a replica, 2 microbatches of 2
PP_EQ_MICRO = 4         # 23(b): whisper-base b4, 4 microbatches, remat
# 23(a)'s hops a step: 2 directions x 2 microbatches x [2, 1500, 768] bf16.
PP_PERMUTE_BYTES = 2 * 2 * (2 * 1500 * 768 * 2)
# One rank's params + Adam over the whole: whisper-small's 4 encoder
# layers are 28,351,488 of its 147,781,632 parameters, half of them a
# rank.
PP_SHARE = (0.90, 0.91)


def read_collectives(path: str) -> dict:
    """A collective report (profiling/comm.py): {kind: bytes a step}."""
    with open(path) as fh:
        rows = [line.strip().split(",") for line in fh if line.strip()]
    return {kind: int(n) for kind, n in rows[1:]}


def run_pp_cli(gpu: str, child: dict) -> None:
    """Phase 23(a): whisper_dist --pp 2 --microbatches 2 --batch_size 4
    --dtype bfloat16 --num_batches 4 --backend gloo (whisper-small, f32
    masters, dropout on) from torchrun's env, two ranks on the card: both
    exit 0 with the same finite losses, launch PATH_KERNELS["pipeline"],
    hold PP_SHARE of the whole f32 parameters and Adam moments, report
    PP_PERMUTE_BYTES of "collective-permute" a step and end with their
    replicated parameters bitwise equal; rank 0's whole checkpoint then
    restores with --resume into a one-process run (``run_resume``)."""
    from tethys_tpu_torch.jobs import whisper_dist

    whole = whisper_numel("small") * 4 * 3              # f32 params, m, v
    flags = ("--batch_size", str(PP_BATCH), "--dtype", "bfloat16")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as ws:
        t0 = time.perf_counter()
        runs = par_cli(ws, PAR_RANKS, *flags, "--pp", "2", "--microbatches",
                       "2", "--num_batches", str(PP_STEPS), "--backend",
                       "gloo")
        seconds = time.perf_counter() - t0
        for r, run in enumerate(runs):
            add_counts(child, run["counts"])
            mem = run["memory"]
            share = (mem["param_bytes"] + mem["adam_bytes"]) / whole
            ms = ((run["steps"][-2][2] - run["steps"][0][2])
                  / (PP_STEPS - 2) * 1e3)
            report = read_collectives(os.path.join(
                ws, "chip_smoke", f"worker_{r}_collectives.txt"))
            log(f"  23(a) rank {r}: losses {run['losses']}, {ms:.2f} ms/step "
                f"over steps 1-{PP_STEPS - 2} (two gloo ranks sharing one "
                f"card: not NVLink's speed), peak "
                f"{mem['peak_bytes'] / 2 ** 30:.3f} GiB, params + Adam "
                f"{(mem['param_bytes'] + mem['adam_bytes']) / 2 ** 30:.3f} "
                f"GiB = {share:.4f} of the whole {whole / 2 ** 30:.3f} GiB; "
                f"collective report {report}; seconds "
                f"{ {k: round(v, 1) for k, v in mem.items() if k.startswith('s_')} }; "
                f"launches {run['counts']}; collectives {run['transports']} "
                f"({gpu})")
            require([i for i, _, _ in run["steps"]] == list(range(PP_STEPS))
                    and all(np.isfinite(run["losses"])),
                    f"23(a) rank {r}'s step lines {run['steps']}")
            require(f"process group: gloo, rank {r} of {PAR_RANKS}"
                    in run["out"], f"23(a) rank {r} joined no gloo group")
            require(PP_SHARE[0] <= share <= PP_SHARE[1], f"23(a) rank {r} "
                    f"holds {share:.4f} of the whole params and Adam moments")
            missing = [k for k in PATH_KERNELS["pipeline"]
                       if not run["counts"][k]]
            require(not missing, f"23(a) rank {r} launched no {missing}")
            require(report.get("collective-permute") == PP_PERMUTE_BYTES,
                    f"23(a) rank {r}'s hops moved {report} a step, not "
                    f"{PP_PERMUTE_BYTES} bytes")
        require(runs[0]["losses"] == runs[1]["losses"],
                "23(a): the two ranks logged other losses")
        digests = [{n: d for n, d in run["memory"]["replicated"].items()
                    if not n.startswith("model.encoder.layers.")}
                   for run in runs]
        differ = [n for n, d in digests[0].items() if digests[1][n] != d]
        require(not differ, f"23(a): replicated parameters differ across "
                f"the ranks: {differ[:5]}")
        log(f"  23(a) {len(digests[0])} replicated parameters bitwise equal "
            f"on both ranks; the world took {seconds:.1f} s")
        run_resume("23(a)", whisper_dist, ws, flags, "whisper_small_epoch_1")


def pp_steps(device, layout) -> dict:
    """One Keras-Adam step of whisper-base in f32, rates 0, from SEED on
    PP_BATCH rows of the synthetic dataset: over ``layout`` the PP step
    with PP_EQ_MICRO microbatches and remat, without one (None) the plain
    step in one process.  The loss, the whole gradients the optimizer
    takes and the whole parameters after the step (on the host), the
    replicated parameters and the step's collective bytes."""
    from tethys_tpu_torch import data
    from tethys_tpu_torch.models.whisper import create_whisper_model
    from tethys_tpu_torch.parallel import dp, pp

    model, _ = create_whisper_model(MODEL, device="cpu", seed=SEED,
                                    param_dtype=torch.float32, **NO_DROPOUT)
    if layout is not None:
        pp.split_stages(model, layout)
    model.to(device).train()
    opt = dp.whisper_optimizer(model.parameters(), PAR_LR)
    if layout is None:
        step = dp.make_train_step(
            lambda m, b, g: (m(b[0], labels=b[1], generator=g)["loss"], {}),
            opt)
    else:
        step = pp.make_pp_train_step(model, opt, layout, PP_EQ_MICRO,
                                     remat=True)

    def whole(tensors):
        host = {n: t.detach() for n, t in tensors.items()}
        if layout is not None:
            host = pp.gather_named(host, model, layout)
        return {n: t.float().cpu() for n, t in host.items()}

    grads, adam_step = [], opt.step

    def record():
        grads.append(whole({n: p.grad for n, p in model.named_parameters()
                            if p.grad is not None}))
        adam_step()

    opt.step = record
    features, labels = next(iter(data.create_whisper_dummy_dataset(
        PP_BATCH)))
    _, loss = step(dp.TrainState(model, opt, layout),
                   (torch.from_numpy(features).to(device),
                    torch.from_numpy(labels).to(device)),
                   dp.step_generator(SEED, 0))
    return {"losses": [loss.item()], "grads": grads[0],
            "params": whole(dict(model.named_parameters())),
            "replicated": {n: p.detach().cpu()
                           for n, p in model.named_parameters()
                           if not n.startswith(pp.LAYERS)},
            "collective_bytes": dict(step.collective_bytes)}


def run_pp_equality(child: dict) -> None:
    """Phase 23(b): one PP step of whisper-base f32 over (data 1, stage
    2), 3 layers a stage, M = 4 with remat, two gloo ranks on the card
    (cuDNN deterministic), against the plain step in one process on the
    same weights and batch: the loss within 1e-5 relative, gradients and
    parameters within phase 6's bounds (as 21(b)); the replicated
    parameters bitwise equal on both ranks; the encoder's flash forward
    launched at the microbatch shape, twice a layer (remat's replay)."""
    from tethys_tpu_torch.utils.device import require_cuda

    got = par_world("pp")
    ranks = [got] + got["others"]
    require(len(ranks) == PAR_RANKS, "23(b): a rank saved no results")
    for r, run in enumerate(ranks):
        add_counts(child, run["launches"])
        log(f"  23(b) rank {r}: collective bytes {run['collective_bytes']}, "
            f"flash launches at (Tq, Tk) "
            f"{ {sh: run['flash_shapes'].count(sh) for sh in set(run['flash_shapes'])} }")
        encoder = run["flash_shapes"].count((1500, 1500))
        require(encoder == 2 * 3 * PP_EQ_MICRO, f"23(b) rank {r}: "
                f"{encoder} encoder flash launches, not one a microbatch a "
                "layer and its replay")
    with deterministic_cudnn():
        want = pp_steps(require_cuda(), None)
    check_par_steps(f"23(b) PP whisper-base f32, M {PP_EQ_MICRO} with remat",
                    got, want, steps=1, loss_rel=1e-5)
    other = got["others"][0]["replicated"]
    differ = [n for n, p in got["replicated"].items()
              if not torch.equal(p, other[n])]
    require(not differ, f"23(b): replicated parameters differ across the "
            f"ranks: {differ[:5]}")
    log(f"  23(b) {len(other)} replicated parameters bitwise equal on both "
        "ranks")


# Phase 24: the last modules of the port (scan_layers, the flat optimizer,
# the decode floor), A/B'd on the bench's steps.
AB_WARMUP = 3
AB_STEPS = 3
LOSS_STEPS = 5
# Deterministic runs (cuDNN's and torch's deterministic algorithms): a
# Wav2Vec2 step scanned or on the flat buffer takes the per-tensor step's
# gradients bit for bit, but its global clip sums the squares of 56
# stacked tensors or one flat vector where per tensor it sums 232, so the
# clip's scale, then Adam's update, may differ in their last bits, and the
# quantizer's argmin turns a last-bit change of the features into another
# code at a near-tie: on an H100 the scanned losses part at step 3 by
# 3e-5 and at step 4 by 3e-3 (PERF.md).  Held: the first loss and the
# first gradients bitwise, every loss within W2V_LOSS_REL.
W2V_LOSS_REL = 1e-2
# Whisper's flash backward adds dq by atomics, so two runs of the same
# step differ in dq's last bits from the first backward on: the flat step
# is held to FLAT_LOSS_SPREAD times the gap of two per-tensor runs, and
# at least to WHISPER_LOSS_REL.
FLAT_LOSS_SPREAD = 10.0
WHISPER_LOSS_REL = 1e-4


def profile_bench_step(family: str, *flags: str) -> dict:
    """step_profile (profiling/step_profile.py) of the bench's step:
    wav2vec2-base b32 or whisper-base b16, bf16 on f32 masters, AB_WARMUP
    steps, AB_STEPS timed and AB_STEPS traced, ``flags`` added; the card's
    memory freed after."""
    import gc

    from tethys_tpu_torch.profiling import step_profile

    result = step_profile.main(["--model", family, "--warmup",
                                str(AB_WARMUP), "--steps", str(AB_STEPS),
                                *flags])
    gc.collect()
    torch.cuda.empty_cache()
    return result


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms and torch's deterministic
    implementations (a warning where an op has none)."""
    with deterministic_cudnn():
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(False)


def bench_losses(family: str, *flags: str):
    """LOSS_STEPS losses of the bench twin's step (its job, weights, batch
    and generators; scripts/bench.build_family_step) with ``flags``, under
    ``deterministic()``, and the first step's gradients before the global
    clip by parameter name, unstacked (Wav2Vec2's hardened step; None for
    Whisper's, which has no clip)."""
    import gc
    import warnings

    from tethys_tpu_torch.models import wav2vec2
    from tethys_tpu_torch.parallel import dp
    from tethys_tpu_torch.scripts import bench
    from tethys_tpu_torch.utils.device import require_cuda

    args = bench.parse_args(["--family", family, *flags])
    first, real_clip = {}, dp.clip_by_global_norm

    def snapshot(grads, *clip_args):
        if not first:
            spec = job.step_fn.flat_spec
            if spec is not None:
                named = spec.unflatten(grads[0])
            else:
                named = dict(zip([n for n, p in
                                  job.state.model.named_parameters()
                                  if p.grad is not None], grads))
            first.update(wav2vec2.unstack_layer_params(
                {n: g.detach().clone() for n, g in named.items()}))
        return real_clip(grads, *clip_args)

    dp.clip_by_global_norm = snapshot
    try:
        with deterministic(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            job, batch, *_ = bench.build_family_step(args, family,
                                                     require_cuda())
            state, losses = job.state, []
            for i in range(LOSS_STEPS):
                state, loss = job.step_fn(
                    state, batch, dp.step_generator(bench.STEP_SEED, i))
                losses.append(loss.item())
    finally:
        dp.clip_by_global_norm = real_clip
    del job, state
    gc.collect()
    torch.cuda.empty_cache()
    return losses, first or None


def log_profile(label: str, r: dict, gpu: str) -> None:
    opt = "optimizer + clips"
    log(f"  24 {label}: wall {r['wall_ms_per_step']:.2f} ms/step, device "
        f"{r['device_ms_per_step']:.2f}, idle {r['idle_share']:.4f}, "
        f"{r['launches_per_step']:.1f} launches a step, "
        f"{r['launches_per_step_by_category'].get(opt, 0):.1f} of them "
        f"Adam and the clips ({r['ms_per_step_by_category'].get(opt, 0):.3f}"
        f" ms); host ms {r['host_ms_per_step']} ({gpu})")
    log("  24 " + json.dumps({k: v for k, v in r.items() if k != "losses"}))


def loss_gap(got: list, want: list) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def run_scan_flat_ab(gpu: str) -> None:
    """Phase 24(a, b): the bench's steps, wav2vec2-base b32 unrolled,
    --scan_layers and --flat_opt, then whisper-base b16 per tensor and
    --flat_opt, each through step_profile
    (wall and device ms a step, idle share, launches, Adam's launches);
    then their losses under ``deterministic()``: Wav2Vec2's scanned and
    flat steps take the first gradients of unrolled per tensor bit for bit
    and their losses stay within W2V_LOSS_REL; Whisper's flat step's
    within FLAT_LOSS_SPREAD times the gap of two per-tensor runs."""
    runs = (("wav2vec2",), ("wav2vec2", "--scan_layers"),
            ("wav2vec2", "--flat_opt"), ("whisper",),
            ("whisper", "--flat_opt"))
    for key in runs:
        log_profile(" ".join(key), profile_bench_step(*key), gpu)
    want, want_grads = bench_losses("wav2vec2")
    log(f"  24(a) wav2vec2 per tensor, unrolled: losses {want}")
    for flags in (("--scan_layers",), ("--flat_opt",),
                  ("--scan_layers", "--flat_opt")):
        got, grads = bench_losses("wav2vec2", *flags)
        gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
        differ = [n for n, g in want_grads.items()
                  if not torch.equal(grads[n], g)]
        extra = [n for n in grads if n not in want_grads and grads[n].any()]
        log(f"  24(a) wav2vec2 {' '.join(flags)}: losses {got}, relative "
            f"gaps {[f'{g:.3e}' for g in gaps]} (limit {W2V_LOSS_REL}); "
            f"first gradients bitwise equal in {len(want_grads) - len(differ)}"
            f" of {len(want_grads)} tensors")
        require(not differ and not extra, f"24(a) {flags}: the first "
                f"gradients differ in {differ[:5]}, nonzero in {extra[:5]}")
        require(got[0] == want[0] and max(gaps) <= W2V_LOSS_REL,
                f"24(a) {flags}: losses {got} against {want}")
    del want_grads, grads
    (want, _), (again, _) = bench_losses("whisper"), bench_losses("whisper")
    got, _ = bench_losses("whisper", "--flat_opt")
    spread = loss_gap(again, want)
    limit = max(FLAT_LOSS_SPREAD * spread, WHISPER_LOSS_REL)
    gap = loss_gap(got, want)
    log(f"  24(b) whisper per tensor: losses {want} and {again} (gap "
        f"{spread:.3e}); --flat_opt {got}: gap {gap:.3e} (limit "
        f"{limit:.3e})")
    require(got[0] == want[0], "24(b): whisper's first losses differ")
    require(gap <= limit, f"24(b): whisper --flat_opt losses {gap:.3e} off")


def run_bench_flags() -> None:
    """Phase 24(b'): the bench twin with --scan_layers --flat_opt
    (wav2vec2-base b32), and with --flat_opt --remat (whisper-base b16),
    which must print bench.py's note and run without remat."""
    import io

    from tethys_tpu_torch.scripts import bench

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rows = bench.main(["--family", "wav2vec2", "--scan_layers",
                           "--flat_opt", "--steps", str(AB_STEPS),
                           "--warmup", "2"])
        rows += bench.main(["--family", "whisper", "--flat_opt", "--remat",
                            "--steps", str(AB_STEPS), "--warmup", "2"])
    for row in rows:
        log(f"  24(b') bench {row['metric']}: "
            f"{row['step_time_s'] * 1e3:.2f} ms/step, mfu {row['mfu']}")
        require(np.isfinite(row["value"]) and 0 < row["mfu"] <= 1,
                f"24(b') bench row {row}")
    require("--flat_opt ignores --remat" in err.getvalue(),
            f"24(b'): no --remat note on stderr: {err.getvalue()!r}")
    log(f"  24(b') the bench's note: {err.getvalue().strip()}")


def run_flat_nccl() -> None:
    """Phase 24(c): phase 18(a')'s f32 b2 hardened steps (rates 0, cuDNN
    deterministic) in an NCCL world of one, per tensor and on the flat
    buffer: each flat step hands all_reduce exactly two tensors, the flat
    gradient itself in place (4 x total bytes) and the loss (4); the flat
    step's losses and parameters equal the per-tensor step's within the
    clips' f32 order (the first loss bitwise, the others within 1e-5
    relative, parameters within 1e-6 but the two whose gradient is
    rounding alone); each reducer timed alone."""
    from tethys_tpu_torch.parallel import mesh
    from tethys_tpu_torch.utils.device import require_cuda

    dev = require_cuda()
    real_all_reduce, calls = torch.distributed.all_reduce, []

    def counting(tensor, *args, **kwargs):
        calls.append((tensor.numel() * tensor.element_size(),
                      tensor.data_ptr()))
        return real_all_reduce(tensor, *args, **kwargs)

    with deterministic_cudnn(), torchrun_env(1, 0, free_port()):
        mesh.initialize_distributed()
        try:
            backend = torch.distributed.get_backend()
            per_tensor = w2v_dp_steps(dev)
            reducer_times(per_tensor[0].reducer, per_tensor[4])
            torch.distributed.all_reduce = counting
            try:
                flat = w2v_dp_steps(dev, flat_opt=True)
            finally:
                torch.distributed.all_reduce = real_all_reduce
            reducer_times(flat[0].reducer, flat[4])
        finally:
            mesh.shutdown_distributed()
    require(backend == "nccl", f"backend {backend}")
    spec = flat[0].flat_spec
    want_calls = [(4 * spec.total, spec.param.grad.data_ptr())]
    log(f"  24(c) flat: all_reduce calls (bytes) "
        f"{[n for n, _ in calls]}, {W2V_F32_STEPS} steps; collective bytes "
        f"{flat[0].collective_bytes}; per tensor "
        f"{per_tensor[0].collective_bytes} in "
        f"{len(per_tensor[0].reducer.buckets(per_tensor[4]))} buckets")
    require([c for c in calls if c[0] != 4] == want_calls * W2V_F32_STEPS
            and len(calls) == 2 * W2V_F32_STEPS,
            f"24(c): the flat step's all_reduce calls {calls}")
    require(flat[0].collective_bytes == {"all-reduce": 4 * spec.total + 4},
            f"24(c): collective bytes {flat[0].collective_bytes}")
    gap = loss_gap(flat[1], per_tensor[1])
    worst = max(max_err(flat[3][n], p) for n, p in per_tensor[3].items()
                if not n.endswith(ROUNDING_ONLY))
    log(f"  24(c) losses flat {flat[1]}, per tensor {per_tensor[1]} "
        f"(gap {gap:.3e}); summed-gradient norms {flat[2]} / "
        f"{per_tensor[2]}; parameters within {worst:.3e}")
    require(flat[1][0] == per_tensor[1][0] and gap <= 1e-5,
            f"24(c): flat losses {gap:.3e} off")
    require(worst <= 1e-6, f"24(c): flat parameters {worst:.3e} off")


def run_decode_floor(gpu: str) -> None:
    """Phase 24(d): the decode-floor twin's whisper-base b16 row (3.35
    TB/s) beside phase 13's measured ms a decode step."""
    from tethys_tpu_torch.scripts import decode_floor

    row = decode_floor.floor_row(MODEL, BENCH_BATCH, decode_floor.H100_HBM_GBPS,
                                 length=BENCH_STEPS)
    log("  24(d) " + json.dumps(row))
    for (kv_quant, fused), ms in DECODE_MS.items():
        floor = (row["int8_cross_floor_ms"] if kv_quant == "int8"
                 else row["floor_ms_per_token"])
        log(f"  24(d) kv_quant {kv_quant}{' fused' if fused else ''}: "
            f"{ms:.4f} ms a decode step (phase 13) against the floor "
            f"{floor} ms: {ms / floor:.1f}x ({gpu})")
    require(DECODE_MS, "24(d): phase 13 recorded no decode step")


# Phase 25's shapes: wav2vec2-base's features at 2 s clips, whisper-base's
# encoder positions.
MASK_SHAPE = (W2V_BATCH, 100, 768)
POSENC_SHAPE = (BENCH_BATCH, 1500, 512)
# (B, L, prob, run_length) of the fixed-starts masks.
MASK_CASES = ((32, 100, 0.05, 10), (32, 768, 0.2, 1), (4, 6, 0.5, 10),
              (8, 50, 0.0, 10), (2, 1500, 0.3, 64))


def check_masks_posenc() -> None:
    """Phase 25's checks (see run_masks_posenc)."""
    from tethys_tpu_torch.ops import masks, posenc

    rng = np.random.default_rng(SEED)
    for b, length, prob, run in MASK_CASES:
        starts = torch.from_numpy(rng.random((b, length)) < prob)
        want = masks.run_mask_from_starts(starts, run)
        got = masks.run_mask_from_starts(starts.cuda(), run)
        require(torch.equal(got.cpu(), want),
                f"25: run mask ({b}, {length}, {prob}, {run}) differs from "
                "the CPU's")
    log(f"  25: run masks from fixed starts equal the CPU's, {MASK_CASES}")

    base = rng.standard_normal(MASK_SHAPE).astype(np.float32)
    base = torch.from_numpy(np.where(base >= 0, base + 0.5, base - 0.5))
    for dtype in (torch.float32, torch.bfloat16):
        x = base.to("cuda", dtype)
        for name, fn, prob, whole in (
                ("apply_time_mask", masks.apply_time_mask, 0.05, 2),
                ("apply_feature_mask", masks.apply_feature_mask, 0.1, 1)):
            gen = torch.Generator(device="cuda")
            out = fn(gen.manual_seed(SEED), x, mask_prob=prob)
            again = fn(gen.manual_seed(SEED), x, mask_prob=prob)
            require(out.dtype == dtype and out.is_cuda,
                    f"25: {name} gave {out.dtype} on {out.device}")
            require(torch.equal(out, again),
                    f"25: {name}: one generator state gave two masks")
            zero = out == 0
            lines = zero.all(dim=whole, keepdim=True)
            require(torch.equal(zero, lines.expand_as(zero)),
                    f"25: {name} zeroed a part of a line")
            require(torch.equal(out[~zero], x[~zero]),
                    f"25: {name} changed an unmasked value")
            log(f"  25: {name} {str(dtype)[6:]} masked share "
                f"{lines.float().mean().item():.4f}")
        require(torch.equal(masks.apply_feature_mask(
            torch.Generator(device="cuda"), x), x),
            "25: apply_feature_mask at its default 0.0 changed its input")

    # The CUDA generator's starts over a large draw: the interior's masked
    # share within 4 sigma of 1 - (1 - p)^run (neighbours closer than run
    # share starts: covariance a (1 - p)^d - a^2 at distance d, a = 1 - want).
    rows, length, prob, run = 512, 2000, 0.05, 10
    mask = masks._run_mask(torch.Generator(device="cuda").manual_seed(SEED),
                           rows, length, prob, run, "cuda")
    share = mask[:, run - 1:].double().mean().item()
    a, n = (1 - prob) ** run, length - run + 1
    var = n * a * (1 - a) + sum(2 * (n - d) * (a * (1 - prob) ** d - a * a)
                                for d in range(1, run))
    sigma = (rows * var) ** 0.5 / (rows * n)
    log(f"  25: CUDA generator, [{rows}, {length}] p {prob} run {run}: "
        f"interior masked share {share:.5f}, want {1 - a:.5f} +- {sigma:.5f}")
    require(abs(share - (1 - a)) < 4 * sigma,
            f"25: masked share {share} off {1 - a} by more than 4 sigma")

    x = torch.from_numpy(rng.standard_normal(POSENC_SHAPE).astype(np.float32))
    for dtype in (torch.float32, torch.bfloat16):
        enc = posenc.SinusoidalPositionalEncoding(POSENC_SHAPE[2], dtype=dtype)
        want = enc(x.to(dtype))
        got = enc.cuda()(x.to("cuda", dtype))
        require(got.dtype == dtype and torch.equal(got.cpu(), want),
                f"25: SinusoidalPositionalEncoding {dtype} differs from the "
                f"CPU's by {max_err(got.cpu(), want):.3e}")
    rel = posenc.RelativePositionalEncoding(MASK_SHAPE[2])
    length = MASK_SHAPE[1]
    want = rel(length).detach()
    rel.cuda()
    got = rel(length)
    got.sum().backward()
    grad = torch.zeros_like(rel.pos_embedding)
    grad[:length] = 1
    require(torch.equal(got.detach().cpu(), want)
            and torch.equal(rel.pos_embedding.grad, grad),
            "25: RelativePositionalEncoding or its gradient differs")
    log("  25: SinusoidalPositionalEncoding f32 and bf16 at "
        f"{list(POSENC_SHAPE)} and RelativePositionalEncoding "
        f"[{length}, {MASK_SHAPE[2]}] equal the CPU's")


def run_masks_posenc() -> None:
    """Phase 25: the masks, the positional encodings and JCTTimer on the
    card; no kernel launches."""
    from tethys_tpu_torch.utils import kernel_lib
    from tethys_tpu_torch.utils.artifacts import JCTTimer

    kernel_lib.reset_launch_counts()
    with JCTTimer() as timer:
        check_masks_posenc()
        torch.cuda.synchronize()
    launched = {k: n for k, n in kernel_lib.launch_counts().items() if n}
    require(not launched, f"25: kernels launched: {launched}")
    require(timer.jct > 0, f"25: JCTTimer read {timer.jct}")
    log(f"  25: JCTTimer {timer.jct:.3f} s over the checks")


# Seconds each phase took, by its tag ("3", "18a", "22c, e").
PHASE_SECONDS: dict = {}


def timed_phase(title: str, fn, *args) -> None:
    """fn(*args), its seconds logged and kept under the title's tag."""
    t0 = time.perf_counter()
    fn(*args)
    seconds = time.perf_counter() - t0
    PHASE_SECONDS[title[1:title.index("]")]] = seconds
    log(f"  ({seconds:.1f} s)")


def drive_path(name: str, phases, child_counts: dict = None) -> dict:
    """Runs a path's phases, (title, fn, *args) each, with the launch counts
    set to 0 just before and read just after; raises unless each of the
    path's kernels launched.  ``child_counts``: launches the phases' own
    processes reported (their counts start at 0 in each process), added in."""
    from tethys_tpu_torch.utils import kernel_lib

    torch.cuda.synchronize()
    kernel_lib.reset_launch_counts()
    for title, fn, *args in phases:
        log(title)
        timed_phase(title, fn, *args)
    torch.cuda.synchronize()
    counts = kernel_lib.launch_counts()
    if child_counts:
        log(f"  launches in this process: {counts}; in the processes it "
            f"started: {child_counts}")
        counts = {k: n + child_counts.get(k, 0) for k, n in counts.items()}
    log(f"  launches during the {name} path: {counts}")
    missing = [k for k in PATH_KERNELS[name] if counts[k] == 0]
    require(not missing, f"{name}: kernels never launched: {missing}")
    if name in WGMMA_PATHS:
        routes = {k: {r: counts[f"{k}.{r}"] for r in kernel_lib.FLASH_ROUTES}
                  for k in FLASH_KERNELS}
        log(f"  flash launches by route during the {name} path: {routes}")
        require(sum(r["wgmma"] for r in routes.values()) > 0,
                f"{name}: the flash kernels never took the wgmma route")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing was run", file=sys.stderr)
        return 1
    started = time.perf_counter()
    # Where Python writes no bytecode (PYTHONDONTWRITEBYTECODE) and the
    # packages ship none, each process the script starts compiles torch's
    # modules anew (3 s or more a process): their bytecode is kept in the
    # checkout's build directory for the run.
    pycache = os.path.join(ROOT, "tethys_tpu_torch", "_build", "pycache")
    os.environ["PYTHONPYCACHEPREFIX"] = pycache
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    sys.pycache_prefix, sys.dont_write_bytecode = pycache, False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tethys_tpu_torch.utils import kernel_lib, tracing
    from tethys_tpu_torch.utils.device import card_name_and_power

    gpu = card_name_and_power()
    log(gpu)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")

    t0 = time.perf_counter()
    with tracing.recording() as rec:
        kernel_lib.library()
    nvcc_ms = rec.summary()["spans"].get("tethys.kernels.build",
                                         {}).get("host_ms", 0.0)
    log(f"[2] kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {nvcc_ms / 1e3:.1f} s)")
    for line in kernel_lib.build_log.splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("    " + line.strip())

    log("[3] kernels against their plain versions on the card")
    results, measured = {}, {}
    timed_phase("[3]", check_kernels, results)
    torch.cuda.synchronize()

    serving = drive_path("serving", (
        ("[4] whisper-base f32 serving, card against cpu", run_slice_f32),
        ("[5] whisper-base bf16 serving", run_slice_bf16, gpu)))
    training = drive_path("training", (
        ("[6] whisper-base f32 training, card against cpu", run_train_f32),
        ("[7] whisper-base bf16 training job", run_train_bf16, gpu,
         measured)))
    w2v = drive_path("wav2vec2", (
        ("[8] wav2vec2-base f32 pretraining, card against cpu", run_w2v_f32),
        ("[9] wav2vec2-base bf16 pretraining job", run_w2v_bf16, gpu,
         measured)))
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
    train_bench = drive_path("train_bench", (
        ("[16] the training bench's twin at its defaults", run_train_bench,
         gpu),))
    resume = drive_path("resume", (
        ("[17a] FLOPs of phase 6's step, card against cpu",
         run_flops_card_vs_cpu),
        ("[17b] resume equals uninterrupted, whisper-base f32 b2",
         run_resume_equals_straight),
        ("[17c] the wav2vec2_dist CLI with --resume", run_resume_cli)))
    child = {}
    data_parallel = drive_path("data_parallel", (
        ("[18a] the wav2vec2_dist CLI in an nccl world of one, base b32 bf16",
         run_dist_cli, measured, child),
        ("[18a'] an nccl world of one equals no group, bit for bit",
         run_dist_identity),
        ("[18b] two ranks on the card over gloo against one process",
         run_gloo_two_ranks, child)), child_counts=child)
    child = {}
    tensorsize = drive_path("tensorsize", (
        ("[19] the tensorsize jobs under the NVML monitor, whisper-small b"
         f"{TS_WHISPER_BATCH} and wav2vec2-base b{W2V_BATCH} bf16",
         run_tensorsize, measured, child),), child_counts=child)
    capacity = drive_path("capacity", (
        ("[20a] whisper-base b16 bf16: plain, remat_layers save_flash and "
         "none, whole-loss remat", run_capacity_modes, gpu),
        ("[20b] grad_accum 2 against 1, whisper-base b16 f32, rates 0",
         run_grad_accum),
        (f"[20c] the whisper_dist CLI at whisper-large-v3 ({CAP_V3_DEPTH} + "
         f"{CAP_V3_DEPTH} layers) b8, remat_layers, "
         "bf16 master, grad_accum 2", run_large_v3_cli, gpu),
        ("[20d] the training bench's twin at whisper-large-v3 b4, "
         "remat_layers, bf16 master", run_large_v3_bench, gpu),
        ("[20e] wav2vec2_dist --remat --grad_accum 2, and the bench's "
         "wav2vec2-base with bf16 master", run_w2v_capacity, gpu),
        ("[20f] the convergence twin, whisper-base, f32 against bf16 master",
         run_convergence)))
    log("[21d] dropout.cu on a shard against the slice of the whole")
    timed_phase("[21d]", run_dropout_window, gpu, results)
    child = {}
    parallel = drive_path("parallel", (
        (f"[21a] whisper_dist --tp 2 at whisper-large-v3 ({PAR_V3_DEPTH} + "
         f"{PAR_V3_DEPTH} layers), "
         "remat_layers, b1 "
         "bf16, two gloo ranks on the card", run_tp_large_v3, gpu, child),
        ("[21b, e] TP whisper-base f32 steps and greedy decoding, two gloo "
         "ranks against one process", run_tp_equality, child),
        ("[21c] whisper_dist --sp 2 at whisper-small, and SP whisper-small "
         "f32 steps with dropout against one process", run_sp, child)),
        child_counts=child)
    log("[22d] GroupNorm's kernels on a channel shard, dropout.cu on the "
        "probabilities' head and row windows")
    timed_phase("[22d]", run_w2v_shard_kernels, gpu)
    child = {}
    w2v_parallel = drive_path("w2v_parallel", (
        ("[22a] wav2vec2_dist --tp 2 at wav2vec2-base b8 bf16, two gloo "
         "ranks on the card, then --resume at --tp 1", run_w2v_par_cli, gpu,
         child, "--tp"),
        ("[22b] wav2vec2_dist --sp 2 at wav2vec2-base b8 bf16, two gloo "
         "ranks on the card", run_w2v_par_cli, gpu, child, "--sp"),
        ("[22c, e] TP and SP wav2vec2-base f32 hardened steps, rates 0 and "
         "dropout on, unrolled and stacked (scan_layers), against one "
         "process; the stacked bf16 job's steps", run_w2v_par_equality,
         child)),
        child_counts=child)
    child = {}
    pipeline = drive_path("pipeline", (
        ("[23a] whisper_dist --pp 2 --microbatches 2 at whisper-small b4 "
         "bf16, two gloo ranks on the card, then --resume at --pp 1",
         run_pp_cli, gpu, child),
        ("[23b] a PP whisper-base f32 step, M 4 with remat, two gloo ranks "
         "against one process", run_pp_equality, child)),
        child_counts=child)
    scan_flat = drive_path("scan_flat", (
        ("[24a, b] the bench's steps scanned and on the flat buffer "
         "against per tensor, wav2vec2-base b32 and whisper-base b16",
         run_scan_flat_ab, gpu),
        ("[24b'] the bench twin with --scan_layers --flat_opt, and with "
         "--flat_opt --remat", run_bench_flags),
        ("[24c] the flat step in an nccl world of one: one all-reduce",
         run_flat_nccl),
        ("[24d] the decode floor beside phase 13", run_decode_floor, gpu)))
    log("[25] the SpecAugment masks, the positional encodings and JCTTimer "
        "on the card against the CPU")
    timed_phase("[25]", run_masks_posenc)
    log(f"  21-23: the collectives of their processes (rank 0 of each TP "
        f"and SP world, both ranks of the PP world, every rank of each CLI) "
        f"by backend, device and op: {PAR_TRANSPORTS}")
    require(PAR_TRANSPORTS and all(k.startswith("gloo cuda ")
                                   for k in PAR_TRANSPORTS),
            "a collective of phases 21-23 ran off the card or not over gloo")
    counts = {k: serving[k] + training[k] + w2v[k] + long_audio[k]
              + flash_bench[k] + frontend[k] + train_bench[k] + resume[k]
              + data_parallel[k] + tensorsize[k] + capacity[k] + parallel[k]
              + w2v_parallel[k] + pipeline[k] + scan_flat[k] for k in serving}
    log(f"[10] launches on the paths: {counts}")
    missing = [k.name for k in kernel_lib.KERNELS if counts[k.name] == 0]
    require(not missing, f"kernels never launched on the main path: {missing}")

    slowest = sorted(PHASE_SECONDS.items(), key=lambda kv: -kv[1])[:5]
    log(f"the run took {time.perf_counter() - started:.1f} s (nvcc "
        f"{nvcc_ms / 1e3:.1f} s of it); the five slowest phases: "
        + ", ".join(f"{tag} {sec:.1f} s" for tag, sec in slowest))
    log(gpu)
    log(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces, "launches": counts[k.name],
         **results[k.name],
         **({"routes": {r: counts[f"{k.name}.{r}"] for r in k.routes}}
            if k.routes else {})} for k in kernel_lib.KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo_rank"]:
        sys.exit(gloo_rank(*sys.argv[2:]))
    if sys.argv[1:2] == ["--par_rank"]:
        sys.exit(par_rank(*sys.argv[2:]))
    sys.exit(main())
