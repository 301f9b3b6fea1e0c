"""Whisper distributed training job (jobs/whisper_dist.py).

    python -m tethys_tpu_torch.jobs.whisper_dist --model_size base \
        --batch_size 16 --num_batches 10 --dtype bfloat16

One process per replica, as ``jobs.wav2vec2_dist`` runs.  The reference
CLI (``--num_batches``, ``--batch_size``) with the JAX job's ``--dtype``
and ``--model_size``, its stdout lines, JCT file and checkpoints;
``--resume`` restores the newest ``whisper_<size>_*`` checkpoint and
``--jax_profile DIR`` writes a profiler trace.  ``--device cpu`` runs the
plain versions of every kernel on the CPU (for small runs).  The JAX job's
single-card capacity flags are taken (jobs/_common.CAPACITY): --remat (the
whole loss checkpointed), --remat_layers (each layer checkpointed under
the save_flash policy), --grad_accum N and --master_dtype bfloat16; the
large-v3 capacity run:

    python -m tethys_tpu_torch.jobs.whisper_dist --model_size large-v3 \
        --batch_size 8 --dtype bfloat16 --remat_layers \
        --master_dtype bfloat16 --grad_accum 2

Tensor, sequence and pipeline parallelism (the JAX CLI's --tp N, --sp N
and --pp N with --microbatches M, mutually exclusive): the world of
processes is laid out (data, model), (data, seq) or (data, stage), one
replica a model, seq or stage group, the global batch the per-replica
batch times the data replicas; on one card the ranks share it over gloo:

    torchrun --nproc_per_node 2 -m tethys_tpu_torch.jobs.whisper_dist \
        --model_size large-v3 --tp 2 --remat_layers --batch_size 1 \
        --num_batches 4 --dtype bfloat16 --backend gloo
    torchrun --nproc_per_node 2 -m tethys_tpu_torch.jobs.whisper_dist \
        --pp 2 --microbatches 2 --batch_size 4 --num_batches 4 \
        --dtype bfloat16 --backend gloo
"""

from __future__ import annotations

import argparse
import time

from tethys_tpu_torch.jobs._common import (
    CAPACITY,
    PARALLEL,
    add_common_flags,
    job_device,
    parse,
    start_distributed,
)
from tethys_tpu_torch.utils.tracing import maybe_profiler_trace


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Whisper-small Distributed Speech Recognition")
    add_common_flags(parser, num_batches_default=40, batch_size_default=1,
                     capacity=tuple(CAPACITY), parallel=tuple(PARALLEL))
    parser.add_argument("--model_size", type=str, default="small",
                        choices=["tiny", "base", "small", "medium", "large",
                                 "large-v3"],
                        help="whisper size preset")
    return parser


def main(argv=None) -> None:
    args = parse(build_parser(), argv)

    from tethys_tpu_torch.parallel import mesh
    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils import artifacts

    start_distributed(args)
    device = job_device(args)
    # One replica a model, seq or stage group (a world they do not divide
    # is refused when the job lays it out).
    replicas = mesh.world_size() // max(args.tp, args.sp, args.pp)
    print(f"batch size per replica: {args.batch_size}, "
          f"global batch size: {args.batch_size * replicas}")
    print(f"num_batches: {args.num_batches}")
    print("Whisper-small distributed training starting...")
    artifacts.start_side_captures()

    start = time.time()
    with maybe_profiler_trace(args.jax_profile):
        result, _model, _config = jobs.train_whisper(
            model_type=args.model_size,
            batch_size_per_replica=args.batch_size,
            num_batches=args.num_batches,
            compute_dtype=args.dtype,
            device=device,
            resume=args.resume,
            collective_report=True,
            remat=args.remat,
            grad_accum=args.grad_accum,
            master_dtype=args.master_dtype,
            config_overrides=({"remat_layers": True} if args.remat_layers
                              else None),
            tensor_parallel=args.tp,
            seq_parallel=args.sp,
            pipeline_parallel=args.pp,
            num_microbatches=args.microbatches,
        )
    jct = time.time() - start
    jobs.finalize_job(result, f"whisper_{args.model_size}_model", jct)


if __name__ == "__main__":
    main()
