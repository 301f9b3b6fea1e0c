"""Whisper distributed training job on one GPU (jobs/whisper_dist.py).

    python -m tethys_tpu_torch.jobs.whisper_dist --model_size base \
        --batch_size 16 --num_batches 10 --dtype bfloat16

The reference CLI (``--num_batches``, ``--batch_size``) with the JAX job's
``--dtype`` and ``--model_size``, its stdout lines, JCT file and
checkpoints.  ``--device cpu`` runs the plain versions of every kernel on
the CPU (for small runs).  The JAX job's parallel and capacity flags are
refused with an error that names where they wait in ROADMAP.md
(jobs/_common.py).
"""

from __future__ import annotations

import argparse
import time

from tethys_tpu_torch.jobs._common import (
    REFUSED,
    add_common_flags,
    job_device,
    parse,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Whisper-small Distributed Speech Recognition")
    add_common_flags(parser, num_batches_default=40, batch_size_default=1,
                     refused=tuple(REFUSED))
    parser.add_argument("--model_size", type=str, default="small",
                        choices=["tiny", "base", "small", "medium", "large",
                                 "large-v3"],
                        help="whisper size preset")
    return parser


def main(argv=None) -> None:
    args = parse(build_parser(), argv)

    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils import artifacts

    device = job_device(args)
    print(f"batch size per replica: {args.batch_size}, "
          f"global batch size: {args.batch_size}")
    print(f"num_batches: {args.num_batches}")
    print("Whisper-small distributed training starting...")
    artifacts.start_side_captures()

    start = time.time()
    result, _model, _config = jobs.train_whisper(
        model_type=args.model_size,
        batch_size_per_replica=args.batch_size,
        num_batches=args.num_batches,
        compute_dtype=args.dtype,
        device=device,
    )
    jct = time.time() - start
    jobs.finalize_job(result, f"whisper_{args.model_size}_model", jct)


if __name__ == "__main__":
    main()
