"""Wav2Vec2 distributed pretraining job on one GPU (jobs/wav2vec2_dist.py).

    python -m tethys_tpu_torch.jobs.wav2vec2_dist --model_size base \
        --batch_size 32 --num_batches 10 --dtype bfloat16

The reference CLI: the hardened step (NaN scrub, 1/N loss scaling, double
clipping), the 50-step and per-epoch checkpoints, the JCT contract.
``--device cpu`` runs the plain versions (small runs); ``--tp``, ``--sp``,
``--remat``, ``--grad_accum`` above 1 and ``--resume`` are refused with
their ROADMAP.md item (jobs/_common.py).
"""

from __future__ import annotations

import argparse
import time

from tethys_tpu_torch.jobs._common import add_common_flags, job_device, parse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="wav2vec2 Distributed Speech Recognition")
    add_common_flags(parser, num_batches_default=5, batch_size_default=1,
                     refused=("resume", "tp", "sp", "remat", "grad_accum"))
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

    device = job_device(args)
    print(f"selected model size: {args.model_size}")
    print(f"batch size per replica: {args.batch_size}, "
          f"global batch size: {args.batch_size}")
    print(f"num_batches: {args.num_batches}")
    print("Wav2Vec2 distributed training starting...")
    artifacts.start_side_captures()

    start = time.time()
    result, _model, _config = jobs.train_wav2vec2(
        model_type="pretraining",
        model_size=args.model_size,
        batch_size_per_replica=args.batch_size,
        num_batches=args.num_batches,
        compute_dtype=args.dtype,
        device=device,
    )
    jct = time.time() - start
    jobs.finalize_job(result, f"wav2vec2_{args.model_size}_model", jct)


if __name__ == "__main__":
    main()
