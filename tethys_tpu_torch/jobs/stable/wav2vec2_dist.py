"""Stable-tier Wav2Vec2 job, base only (jobs/stable/wav2vec2_dist.py).

    python -m tethys_tpu_torch.jobs.stable.wav2vec2_dist --batch_size 4 \
        --num_batches 30

The reference stable_jobs/wav2vec2_dist.py: the base model with the real
CTC loss on its ASR head (``real_ctc=True``; the pretraining head it trains
does not use it), one process per replica and the JCT contract of the
distributed jobs; ``--resume`` and ``--jax_profile DIR`` as in the other
jobs.
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

MODEL_SIZE = "base"


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="wav2vec2 Distributed Speech Recognition")
    add_common_flags(parser, num_batches_default=5, batch_size_default=1)
    return parser


def main(argv=None) -> None:
    args = parse(build_parser(), argv)

    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils import artifacts

    n_replicas = start_distributed(args)
    device = job_device(args)
    print(f"batch size per replica: {args.batch_size}, "
          f"global batch size: {args.batch_size * n_replicas}")
    print(f"num_batches: {args.num_batches}")
    print("Wav2Vec2-base distributed training starting...")
    artifacts.start_side_captures()

    start = time.time()
    with maybe_profiler_trace(args.jax_profile):
        result, _model, _config = jobs.train_wav2vec2(
            model_type="pretraining",
            model_size=MODEL_SIZE,
            batch_size_per_replica=args.batch_size,
            num_batches=args.num_batches,
            compute_dtype=args.dtype,
            real_ctc=True,
            device=device,
            resume=args.resume,
            collective_report=True,
        )
    jct = time.time() - start
    jobs.finalize_job(result, "wav2vec2_base_model", jct)


if __name__ == "__main__":
    main()
