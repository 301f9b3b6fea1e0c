"""Where a training step's device time goes, on the card.

    python -m tethys_tpu_torch.profiling.step_profile --model_size base \
        --batch_size 32 --dtype bfloat16
    python -m tethys_tpu_torch.profiling.step_profile --model whisper \
        --model_size base --batch_size 16 --dtype bfloat16

Builds the job's step (train/jobs.make_wav2vec2_job: the hardened step on
2 s clips by default; make_whisper_job: the plain step on 30 s inputs; the
config's dropout), runs warm-up steps, then:
- times ``--steps`` steps pipelined as the loop runs them (the host fetches
  step i-1's loss while the device runs step i), host clock, no profiler:
  wall ms per step, and the host's ms per step spent taking and uploading
  the batch, queueing the step, and waiting for the previous loss (near 0
  when the host, not the device, sets the pace);
- traces the same number of steps with ``torch.profiler`` (CPU and CUDA)
  and adds up the device time of every kernel, by the category of the
  operation that launched it: the kernel's own name for the port's kernels,
  else the nearest enclosing operation (conv, GroupNorm, attention,
  dense GEMMs, LayerNorm, GELU, the optimizer and its clips).  It also
  counts the kernel launches a step makes.

Prints the top kernels and one JSON line: wall and device ms per step, the
device's idle share (1 - device / wall) and ms per category.  ``--out``
also writes the JSON there.  Needs a CUDA device (no CPU fallback).
"""

from __future__ import annotations

import argparse
import collections
import json
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
    args = parser.parse_args(argv)

    from tethys_tpu_torch.parallel.dp import step_generator
    from tethys_tpu_torch.train.jobs import make_wav2vec2_job, make_whisper_job
    from tethys_tpu_torch.utils.device import require_cuda

    device = require_cuda()
    if args.model == "whisper":
        batch_size = args.batch_size or 16
        job = make_whisper_job(args.model_size, batch_size,
                               compute_dtype=args.dtype, device=device, seed=0)
    else:
        batch_size = args.batch_size or 32
        job = make_wav2vec2_job(
            "pretraining", args.model_size, batch_size,
            compute_dtype=args.dtype, audio_length=args.audio_length,
            device=device, seed=0)
    batches = iter(job.dataset)
    state, count = job.state, 0
    host = collections.Counter()  # seconds of host time by stage

    def run(n):
        nonlocal state, count
        pending = None
        for _ in range(n):
            t0 = time.perf_counter()
            batch = job.prepare_batch(next(batches))
            t1 = time.perf_counter()
            state, loss = job.step_fn(state, batch, step_generator(0, count))
            t2 = time.perf_counter()
            count += 1
            if pending is not None:
                pending.item()
            host["batch"] += t1 - t0
            host["queue_step"] += t2 - t1
            host["wait_previous_loss"] += time.perf_counter() - t2
            pending = loss
        pending.item()

    run(args.warmup)
    torch.cuda.synchronize()
    host.clear()
    t0 = time.perf_counter()
    run(args.steps)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    host_ms = {k: v * 1e3 / args.steps for k, v in host.items()}

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        run(args.steps)
        torch.cuda.synchronize()
    kernels = kernel_times(prof)
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    launches = sum(1 for evt in prof.events()
                   if evt.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                   "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    by_category = collections.Counter()
    by_kernel = collections.Counter()
    for name, us, chain in kernels:
        by_category[categorise(name, chain)] += us / 1e3 / args.steps
        by_kernel[name] += us / 1e3 / args.steps
    device_ms = sum(by_category.values())
    for name, ms in by_kernel.most_common(25):
        print(f"  {ms:9.4f} ms/step  {ms / device_ms:6.1%}  {name[:110]}")
    result = {
        "model": f"{args.model}-{args.model_size}", "batch": batch_size,
        **({"audio_length": args.audio_length}
           if args.model == "wav2vec2" else {}),
        "dtype": args.dtype, "steps": args.steps, "wall_ms_per_step": wall_ms,
        "device_ms_per_step": device_ms,
        "launches_per_step": launches / args.steps,
        "host_ms_per_step": host_ms,
        "idle_share": 1.0 - device_ms / wall_ms,
        "ms_per_step_by_category": dict(by_category.most_common()),
        "gpu": torch.cuda.get_device_name(0),
    }
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(result, fh, indent=1)
    return result


if __name__ == "__main__":
    main()
