"""Wav2Vec2 single-device job (jobs/wav2vec2_single.py).

    python -m tethys_tpu_torch.jobs.wav2vec2_single --batch_size 4 \
        --num_batches 30 --model_size small --model_type pretraining

The reference CLI (--model_size/--model_type/--learning_rate/--num_epochs),
2 s clips, the JCT printed and not written (the reference's behaviour), the
final weights saved into a relative ``./model_cache``.  ``--resume`` is
refused with its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import os
import time

from tethys_tpu_torch.jobs._common import add_common_flags, job_device, parse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Wav2Vec2 Single GPU Speech Recognition")
    add_common_flags(parser, num_batches_default=5, batch_size_default=1,
                     refused=("resume",))
    parser.add_argument(
        "--model_size", type=str, default="small",
        choices=["tiny", "small", "base"],
        help="Model size: tiny (~15-20M params), small (~30-40M params), "
             "base (~95M params)")
    parser.add_argument(
        "--model_type", type=str, default="pretraining",
        choices=["pretraining", "asr", "classification"],
        help="Model type for training")
    parser.add_argument("--learning_rate", type=float, default=3e-5,
                        help="Learning rate")
    parser.add_argument("--num_epochs", type=int, default=1,
                        help="Number of epochs")
    return parser


def main(argv=None) -> None:
    args = parse(build_parser(), argv)

    from tethys_tpu_torch.checkpoint import save_final_weights
    from tethys_tpu_torch.train import jobs

    device = job_device(args)
    print("Wav2Vec2 single-device training starting...")
    print(f"selected model size: {args.model_size}")
    print(f"selected model type: {args.model_type}")

    start = time.time()
    result, model, _config = jobs.train_wav2vec2(
        model_type=args.model_type,
        model_size=args.model_size,
        batch_size_per_replica=args.batch_size,
        num_batches=args.num_batches,
        num_epochs=args.num_epochs,
        learning_rate=args.learning_rate,
        compute_dtype=args.dtype,
        device=device,
    )
    jct = time.time() - start
    print("Training completed.")
    print("JCT:", jct)

    cache_dir = "./model_cache"  # relative: the reference's behaviour
    os.makedirs(cache_dir, exist_ok=True)
    try:
        save_final_weights(
            model, f"wav2vec2_{args.model_size}_{args.model_type}_model",
            cache_dir=cache_dir)
    except Exception as e:  # noqa: BLE001 - a missing volume must not
        # kill the job
        print(f"final weight save failed: {e}")


if __name__ == "__main__":
    main()
