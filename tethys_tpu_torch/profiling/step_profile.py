"""Where a training step's device time goes, on the card.

    python -m tethys_tpu_torch.profiling.step_profile --model_size base \
        --batch_size 32 --dtype bfloat16
    python -m tethys_tpu_torch.profiling.step_profile --model whisper \
        --model_size base --batch_size 16 --dtype bfloat16
    python -m tethys_tpu_torch.profiling.step_profile --model whisper \
        --model_size large-v3 --batch_size 4 --remat_layers \
        --master_dtype bfloat16
    python -m tethys_tpu_torch.profiling.step_profile [--model whisper] \
        --flat_opt [--scan_layers]

Builds the job's step (train/jobs.make_wav2vec2_job: the hardened step on
2 s clips by default; make_whisper_job: the plain step on 30 s inputs; the
config's dropout; the capacity modes of the jobs' CLIs: --remat,
--grad_accum and --master_dtype, and Whisper's --remat_layers with
--remat_policy; the bench's --flat_opt, the flat-buffer optimizer of
parallel/flat.py (scripts/profile_step.py's flag), and Wav2Vec2's
--scan_layers), runs warm-up steps through the training loop
(train/loop.run_training, which prints its step lines), then:
- times ``--steps`` more steps of the loop, pipelined as it runs them (the
  host fetches step i-1's loss while the device runs step i), host clock,
  no profiler, with the program's recording on (utils/tracing): wall ms
  per step; the host's ms per step inside the loop's spans
  ``tethys.loop.input`` (taking and uploading the batch), ``.dispatch``
  (queueing the step) and ``.fetch`` (waiting for the previous loss, near 0
  when the host, not the device, sets the pace; the last step's fetch,
  which waits for its whole step, left out); each span's host, self and
  device ms per step; the device's turn from one step to the next (the
  end of a step's ``tethys.step.optimizer`` to the start of the next
  one's ``tethys.step.forward``, on CUDA events); the counters;
- traces the same number of steps with ``torch.profiler`` (CPU and CUDA)
  and adds up the device time of every kernel, by the category of the
  operation that launched it: the kernel's own name for the port's kernels,
  else the nearest enclosing operation (conv, GroupNorm, attention,
  dense GEMMs, LayerNorm, GELU, the optimizer and its clips).  It also
  counts the kernel launches a step makes, in all and by category.

Prints the top kernels and one JSON line: wall and device ms per step, the
host ms and spans above, the device's idle share (1 - device / wall), ms
and launches per category and the loss of every step in order (each call
of the loop draws from the same seeds, for every flag, so two runs' losses
compare).  ``--out`` also writes the JSON there.  Needs a
CUDA device (no CPU fallback).
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import time

import torch

# (category, substrings of a kernel's or an enclosing operation's name),
# tried from the innermost operation outwards.
KERNEL_CATEGORIES = (
    ("gn_stats kernel (moments)", ("gn_moments_kernel",)),
    ("gn_grad_sums kernel", ("gn_grad_sums_kernel",)),
    ("gn_apply kernel", ("gn_apply_kernel",)),
    ("gn_apply_bwd kernel", ("gn_apply_bwd_kernel",)),
    ("dropout kernel", ("dropout_kernel",)),
    ("flash_bwd kernel", ("flash_bwd_",)),
    ("flash_fwd kernel", ("flash_fwd_",)),
    ("split/merge heads kernels", ("split_heads_kernel", "merge_heads_kernel")),
)
OP_CATEGORIES = (
    ("optimizer + clips", ("Optimizer.step", "_foreach_")),
    ("GroupNorm (torch around its kernels)", ("GroupNormFunction",)),
    ("conv (cuDNN)", ("convolution",)),
    ("cross-entropy loss", ("log_softmax", "LogSoftmax", "nll_loss",
                            "NllLoss")),
    ("attention (bmm, softmax)", ("bmm", "softmax", "Bmm", "Softmax")),
    ("dense GEMMs", ("addmm", "aten::mm", "MmBackward", "aten::linear")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("GELU", ("gelu", "Gelu")),
)


# The host calls that launch a kernel (one each).
LAUNCH_EVENTS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx")


def categorise(kernel_name: str, op_names) -> str:
    for category, keys in KERNEL_CATEGORIES:
        if any(k in kernel_name for k in keys):
            return category
    for name in op_names:
        for category, keys in OP_CATEGORIES:
            if any(k in name for k in keys):
                return category
    return "other (casts, copies, elementwise, loss)"


def kernel_times(prof) -> list:
    """[(kernel name, microseconds, [launching op, its parents ...])]."""
    out = []
    for evt in prof.events():
        if not evt.kernels:
            continue
        chain, parent = [evt.name], evt.cpu_parent
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        out.extend((k.name, k.duration, chain) for k in evt.kernels)
    return out


# The host stages of step_profile's output, by the loop's spans.
HOST_STAGES = (("batch", "tethys.loop.input"),
               ("queue_step", "tethys.loop.dispatch"),
               ("wait_previous_loss", "tethys.loop.fetch"))


def loop_host_ms(rec, steps: int):
    """({stage: host ms a step} of HOST_STAGES, the last step's fetch left
    out; {span: {"host", "self", "device"} ms a step}) of a recording of
    ``steps`` steps of the loop."""
    last = max((r.step for r in rec.records if r.step is not None),
               default=None)
    host = collections.Counter()
    for r in rec.records:
        if r.name == "tethys.loop.fetch" and r.step == last:
            continue
        host[r.name] += r.host_ms
    spans = {name: {"host": s["host_ms"] / steps, "self": s["self_ms"] / steps,
                    "device": (None if s["device_ms"] is None
                               else s["device_ms"] / steps)}
             for name, s in rec.summary()["spans"].items()}
    return {stage: host[name] / steps for stage, name in HOST_STAGES}, spans


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="wav2vec2",
                        choices=["wav2vec2", "whisper"])
    parser.add_argument("--model_size", default="base")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="default 32 (wav2vec2), 16 (whisper)")
    parser.add_argument("--audio_length", type=int, default=32000,
                        help="wav2vec2 samples a clip (whisper: 30 s)")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--warmup", type=int, default=3)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--out", default=None)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--grad_accum", type=int, default=1)
    parser.add_argument("--master_dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--remat_layers", action="store_true",
                        help="whisper only")
    parser.add_argument("--remat_policy", default="save_flash",
                        choices=["save_flash", "none"])
    parser.add_argument("--flat_opt", action="store_true",
                        help="profile the flat-buffer optimizer path")
    parser.add_argument("--scan_layers", action="store_true",
                        help="wav2vec2 only: the stacked encoder layout")
    args = parser.parse_args(argv)
    capacity = dict(remat=args.remat, grad_accum=args.grad_accum,
                    master_dtype=args.master_dtype, flat_opt=args.flat_opt)

    from tethys_tpu_torch.train.jobs import make_wav2vec2_job, make_whisper_job
    from tethys_tpu_torch.train.loop import run_training
    from tethys_tpu_torch.utils import tracing
    from tethys_tpu_torch.utils.device import require_cuda

    device = require_cuda()
    if args.model == "whisper":
        batch_size = args.batch_size or 16
        job = make_whisper_job(
            args.model_size, batch_size, compute_dtype=args.dtype,
            device=device, seed=0, config_overrides=dict(
                remat_layers=args.remat_layers,
                remat_policy=args.remat_policy), **capacity)
    else:
        batch_size = args.batch_size or 32
        job = make_wav2vec2_job(
            "pretraining", args.model_size, batch_size,
            compute_dtype=args.dtype, audio_length=args.audio_length,
            device=device, seed=0, scan_layers=args.scan_layers, **capacity)
    losses = []

    def run(n):
        result = run_training(job.step_fn, job.dataset, job.state, 0,
                              max_iterations=n,
                              prepare_batch=job.prepare_batch)
        losses.extend(result.losses)

    run(args.warmup)
    torch.cuda.synchronize()
    with tracing.recording() as rec:
        t0 = time.perf_counter()
        run(args.steps)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    host_ms, spans = loop_host_ms(rec, args.steps)
    turns = rec.turns("tethys.step.optimizer", "tethys.step.forward")

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run(args.steps)
        torch.cuda.synchronize()
    kernels = kernel_times(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    launches = sum(1 for evt in prof.events() if evt.name in LAUNCH_EVENTS)
    by_category = collections.Counter()
    launches_by_category = collections.Counter()
    by_kernel = collections.Counter()
    for name, us, chain in kernels:
        category = categorise(name, chain)
        by_category[category] += us / 1e3 / args.steps
        launches_by_category[category] += 1 / args.steps
        by_kernel[name] += us / 1e3 / args.steps
    device_ms = sum(by_category.values())
    for name, ms in by_kernel.most_common(25):
        print(f"  {ms:9.4f} ms/step  {ms / device_ms:6.1%}  {name[:110]}")
    result = {
        "model": f"{args.model}-{args.model_size}", "batch": batch_size,
        **({"audio_length": args.audio_length}
           if args.model == "wav2vec2" else {}),
        "dtype": args.dtype, **{k: v for k, v in vars(args).items()
                                if k in capacity or k.startswith("remat")
                                or k == "scan_layers"},
        "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "launches_per_step": launches / args.steps,
        "host_ms_per_step": host_ms,
        "spans_ms_per_step": spans,
        "step_turn_ms": statistics.median(turns) if turns else None,
        "counters_per_step": {k: v / args.steps
                              for k, v in rec.counters.items()},
        "idle_share": 1.0 - device_ms / wall_ms,
        "ms_per_step_by_category": dict(by_category.most_common()),
        "launches_per_step_by_category": dict(
            launches_by_category.most_common()),
        "losses": losses,
        "gpu": torch.cuda.get_device_name(0),
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main()
