"""Whisper distributed training job on one GPU (jobs/whisper_dist.py).

    python -m tethys_tpu_torch.jobs.whisper_dist --model_size base \
        --batch_size 16 --num_batches 10 --dtype bfloat16

The reference CLI (``--num_batches``, ``--batch_size``) with the JAX job's
``--dtype`` and ``--model_size``, its stdout lines, JCT file and
checkpoints.  ``--device cpu`` runs the plain versions of every kernel on
the CPU (for small runs).  The JAX job's parallel and capacity flags are
refused with an error that names where they wait in ROADMAP.md; none is
ignored.
"""

from __future__ import annotations

import argparse
import time

# flag -> (value that is supported, where the feature waits)
_REFUSED = {
    "tp": (1, "queue 1 item 7 (tensor parallelism)"),
    "sp": (1, "queue 1 item 7 (sequence parallelism)"),
    "pp": (1, "queue 1 item 7 (pipeline parallelism)"),
    "remat": (False, "queue 1 item 7 (activation checkpointing)"),
    "remat_layers": (False, "queue 1 item 7 (per-layer remat)"),
    "grad_accum": (1, "queue 1 item 7 (gradient accumulation)"),
    "resume": (False, "queue 1 item 4 (checkpoint restore)"),
    "master_dtype": ("float32", "queue 1 item 7 (bf16 master weights)"),
}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Whisper-small Distributed Speech Recognition")
    parser.add_argument("--num_batches", type=int, default=40,
                        help="num_batches per replica, default is set 40")
    parser.add_argument("--batch_size", type=int, default=1,
                        help="batch size per replica, default is set 1")
    parser.add_argument("--dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"],
                        help="compute dtype (master weights stay float32)")
    parser.add_argument("--model_size", type=str, default="small",
                        choices=["tiny", "base", "small", "medium", "large",
                                 "large-v3"],
                        help="whisper size preset")
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="cuda: the kernels on one GPU; cpu: the plain "
                             "versions")
    parser.add_argument("--tp", type=int, default=1)
    parser.add_argument("--sp", type=int, default=1)
    parser.add_argument("--pp", type=int, default=1)
    parser.add_argument("--remat", action="store_true")
    parser.add_argument("--remat_layers", action="store_true")
    parser.add_argument("--grad_accum", type=int, default=1)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--master_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    return parser


def main(argv=None) -> None:
    parser = build_parser()
    args = parser.parse_args(argv)
    for flag, (supported, where) in _REFUSED.items():
        if getattr(args, flag) != supported:
            parser.error(f"--{flag} {getattr(args, flag)} is not ported yet "
                         f"(ROADMAP.md, {where})")

    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils import artifacts
    from tethys_tpu_torch.utils.device import require_cuda

    device = require_cuda() if args.device == "cuda" else "cpu"
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
