"""Whisper distributed job with Tiresias tensor-size profiling
(jobs/whisper_dist_tensorsize.py).

    python -m tethys_tpu_torch.jobs.whisper_dist_tensorsize --batch_size 4 \
        --num_batches 30 --dtype bfloat16

The job of ``jobs.whisper_dist`` (whisper-small, one process per replica)
with the TensorProfiler (profiling/tensorsize.py): tensor_sizes.txt,
memory_usage.txt, summary.txt, tiresias_tensorsize.txt,
skewness_analysis.{txt,json}, final_summary.json, tiresias_result.json and
legacy_skewness_result.txt under ``<workspace>/tensor_logs``, the
comparison tables on stdout, and the per-task /result copies.  Every rank
profiles its own replica.  ``--log_tensor_freq`` is parsed and left
unused, as in the JAX job: every step is logged.  The shared flags of
jobs/_common.py are taken, and the unported ones refused.
"""

from __future__ import annotations

import argparse
import os
import time

from tethys_tpu_torch.jobs._common import (
    REFUSED,
    add_common_flags,
    job_device,
    parse,
    start_distributed,
)
from tethys_tpu_torch.utils.tracing import maybe_profiler_trace


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Whisper-small Distributed Speech Recognition "
                    "with Tensor Profiling")
    add_common_flags(parser, num_batches_default=40, batch_size_default=1,
                     refused=tuple(REFUSED))
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
    print(f"batch size per replica: {args.batch_size}, "
          f"global batch size: {args.batch_size * n_replicas}")
    print(f"num_batches: {args.num_batches}")
    print("Whisper-small distributed training with tensor profiling...")
    artifacts.start_side_captures()

    log_dir = os.path.join(artifacts.workspace_dir(), "tensor_logs")
    profiler = TensorProfiler(log_dir=log_dir, model_name="whisper_small",
                              flavor="whisper", device=device)

    start = time.time()
    with maybe_profiler_trace(args.jax_profile):
        result, _model, _config = jobs.train_whisper(
            model_type="small",
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
    profiler.close()
    print(f"Tiresias TensorSize: "
          f"{summary.get('tiresias_tensorsize_mb', 0.0):.2f} MB/iteration")
    print(f"Model Skewness: {summary.get('model_skewness', 0.0):.2f}")

    task_type, task_index = mesh.job_identity()
    jobs.finalize_job(result, "whisper_small_model", jct)
    profiler.write_result_copies(jct, task_type, task_index)


if __name__ == "__main__":
    main()
