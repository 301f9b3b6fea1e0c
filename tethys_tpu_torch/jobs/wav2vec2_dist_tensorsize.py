"""Wav2Vec2 distributed job with tensor-size and per-value skewness
profiling (jobs/wav2vec2_dist_tensorsize.py).

    python -m tethys_tpu_torch.jobs.wav2vec2_dist_tensorsize --model_size base \
        --batch_size 32 --num_batches 30 --dtype bfloat16

The job of ``jobs.wav2vec2_dist`` (one process per replica) with the
Wav2Vec2-flavor TensorProfiler (profiling/tensorsize.py): the rows of
every step, the skewness of the input, of the contrastive logits and of
every summed gradient, computed on the device and fetched with the step's
loss, the size-distribution skewness, the log dir ``tensor_logs_<size>``,
the comparison tables, and the per-task /result copies
(``*_tensor_summary``, ``*_tiresias``, ``*_skewness``, ``*_combined``).

The reference's epilogue crashes on an undefined ``weighted_avg_skewness``
(reference wav2vec2_dist_tensorsize.py:2172; SURVEY quirk #4); here, as in
the JAX job, the average is computed.  ``--log_tensor_freq`` is parsed and
left unused, as in the JAX job: every step is logged.  The shared flags of
jobs/_common.py are taken, and the unported ones refused.
"""

from __future__ import annotations

import argparse
import os
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
        description="wav2vec2 Distributed Speech Recognition "
                    "with Tensor Profiling")
    add_common_flags(parser, num_batches_default=5, batch_size_default=1,
                     refused=("tp", "sp"))
    parser.add_argument(
        "--model_size", type=str, default="small",
        choices=["tiny", "small", "base"])
    parser.add_argument(
        "--log_tensor_freq", type=int, default=1,
        help="log tensor sizes every N steps")
    return parser


def main(argv=None) -> None:
    args = parse(build_parser(), argv)

    from tethys_tpu_torch.parallel import mesh
    from tethys_tpu_torch.profiling.tensorsize import TensorProfiler
    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils import artifacts

    n_replicas = start_distributed(args)
    device = job_device(args)
    print(f"selected model size: {args.model_size}")
    print(f"batch size per replica: {args.batch_size}, "
          f"global batch size: {args.batch_size * n_replicas}")
    print(f"num_batches: {args.num_batches}")
    print("Wav2Vec2 distributed training with tensor profiling...")
    artifacts.start_side_captures()

    log_dir = os.path.join(
        artifacts.workspace_dir(), f"tensor_logs_{args.model_size}")
    profiler = TensorProfiler(
        log_dir=log_dir, model_name=f"wav2vec2_{args.model_size}",
        flavor="wav2vec2", device=device)

    start = time.time()
    with maybe_profiler_trace(args.jax_profile):
        result, _model, _config = jobs.train_wav2vec2(
            model_type="pretraining",
            model_size=args.model_size,
            batch_size_per_replica=args.batch_size,
            num_batches=args.num_batches,
            compute_dtype=args.dtype,
            device=device,
            profiler=profiler,
            resume=args.resume,
            collective_report=True,
        )
    jct = time.time() - start

    summary = profiler.save_final_results()
    profiler.print_comparison_tables()

    # The average value skewness over the logged tensors (the reference
    # meant to print it but named an undefined variable: quirk #4).
    skews = summary.get("skewness_analysis", {}).get("value_skewness", {})
    if skews:
        weighted_avg_skewness = sum(skews.values()) / len(skews)
        print(f"Weighted average value skewness: {weighted_avg_skewness:.4f}")
    profiler.close()
    print(f"Tiresias TensorSize: "
          f"{summary.get('tiresias_tensorsize_mb', 0.0):.2f} MB/iteration")
    print(f"Model Skewness: {summary.get('model_skewness', 0.0):.2f}")

    task_type, task_index = mesh.job_identity()
    jobs.finalize_job(result, f"wav2vec2_{args.model_size}_model", jct)
    profiler.write_result_copies(jct, task_type, task_index)


if __name__ == "__main__":
    main()
