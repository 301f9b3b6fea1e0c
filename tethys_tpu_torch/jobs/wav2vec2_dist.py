"""Wav2Vec2 distributed pretraining job (jobs/wav2vec2_dist.py).

    python -m tethys_tpu_torch.jobs.wav2vec2_dist --model_size base \
        --batch_size 32 --num_batches 10 --dtype bfloat16
    torchrun --nproc_per_node 4 -m tethys_tpu_torch.jobs.wav2vec2_dist ...

One process per replica, from torchrun's env or a TF_CONFIG that names
several processes (a TFJob's CHIEF + WORKERs), else one process alone
(jobs/_common.start_distributed); the gradients are summed over the
replicas and each writes its JCT file and its collective report.

The reference CLI: the hardened step (NaN scrub, 1/N loss scaling, double
clipping), the 50-step and per-epoch checkpoints, the JCT contract.
``--resume`` restores the newest ``model_*`` checkpoint, ``--jax_profile
DIR`` writes a profiler trace, ``--device cpu`` runs the plain versions
(small runs); ``--remat`` checkpoints the whole loss and ``--grad_accum N``
accumulates N microbatches a step, as the JAX CLI's.

Tensor and sequence parallelism (the JAX CLI's --tp N and --sp N, mutually
exclusive): the world of processes is laid out (data, model) or (data,
seq), one replica a model or seq group running the hardened step on its
shards (parallel/dp.py), the global batch the per-replica batch times the
data replicas; on one card the ranks share it over gloo:

    torchrun --nproc_per_node 2 -m tethys_tpu_torch.jobs.wav2vec2_dist \
        --model_size base --tp 2 --batch_size 8 --num_batches 4 \
        --dtype bfloat16 --backend gloo
"""

from __future__ import annotations

import argparse
import time

from tethys_tpu_torch.jobs._common import (
    add_common_flags,
    job_device,
    parse,
    start_distributed,
)
from tethys_tpu_torch.utils.tracing import maybe_profiler_trace


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="wav2vec2 Distributed Speech Recognition")
    add_common_flags(parser, num_batches_default=5, batch_size_default=1,
                     capacity=("grad_accum",), parallel=("tp", "sp"))
    parser.add_argument("--remat", action="store_true",
                        help="checkpoint the forward pass (large-model HBM)")
    parser.add_argument(
        "--model_size", type=str, default="small",
        choices=["tiny", "small", "base"],
        help="Model size: tiny (~15-20M params), small (~30-40M params), "
             "base (~95M params)")
    return parser


def main(argv=None) -> None:
    args = parse(build_parser(), argv)

    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils import artifacts

    # One replica a model or seq group (a world they do not divide is
    # refused when the job lays it out).
    n_replicas = start_distributed(args) // max(args.tp, args.sp)
    device = job_device(args)
    print(f"selected model size: {args.model_size}")
    print(f"batch size per replica: {args.batch_size}, "
          f"global batch size: {args.batch_size * n_replicas}")
    print(f"num_batches: {args.num_batches}")
    print("Wav2Vec2 distributed training starting...")
    artifacts.start_side_captures()

    start = time.time()
    with maybe_profiler_trace(args.jax_profile):
        result, _model, _config = jobs.train_wav2vec2(
            model_type="pretraining",
            model_size=args.model_size,
            batch_size_per_replica=args.batch_size,
            num_batches=args.num_batches,
            compute_dtype=args.dtype,
            device=device,
            resume=args.resume,
            collective_report=True,
            remat=args.remat,
            grad_accum=args.grad_accum,
            tensor_parallel=args.tp,
            seq_parallel=args.sp,
        )
    jct = time.time() - start
    jobs.finalize_job(result, f"wav2vec2_{args.model_size}_model", jct)


if __name__ == "__main__":
    main()
