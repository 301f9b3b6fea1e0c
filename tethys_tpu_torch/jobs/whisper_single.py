"""Single-device job that trains Wav2Vec2-base (jobs/whisper_single.py).

    python -m tethys_tpu_torch.jobs.whisper_single --batch_size 4 \
        --num_batches 40

The reference's quirk #1, kept: the file named ``whisper_single.py`` holds
Wav2Vec2-base and trains contrastive pretraining on 80000-sample (5 s)
clips (reference speech_jobs/whisper_single.py), and writes
``single_jct.txt``.  ``--resume`` is refused with its ROADMAP.md item.
"""

from __future__ import annotations

import argparse
import time

from tethys_tpu_torch.jobs._common import add_common_flags, job_device, parse

MODEL_SIZE = "base"
AUDIO_LENGTH = 80000   # 5 s clips (reference whisper_single.py:1102)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="wav2vec2 Single GPU Speech Recognition")
    add_common_flags(parser, num_batches_default=40, batch_size_default=4,
                     refused=("resume",))
    return parser


def main(argv=None) -> None:
    args = parse(build_parser(), argv)

    from tethys_tpu_torch.checkpoint import save_final_weights
    from tethys_tpu_torch.train import jobs
    from tethys_tpu_torch.utils import artifacts

    device = job_device(args)
    print(f"batch size: {args.batch_size}")
    print(f"num_batches: {args.num_batches}")
    print("Wav2Vec2 single-device training starting...")
    artifacts.start_side_captures()

    start = time.time()
    result, model, _config = jobs.train_wav2vec2(
        model_type="pretraining",
        model_size=MODEL_SIZE,
        batch_size_per_replica=args.batch_size,
        num_batches=args.num_batches,
        compute_dtype=args.dtype,
        audio_length=AUDIO_LENGTH,
        device=device,
    )
    jct = time.time() - start
    print("Training completed.")
    print("jct:", jct)
    artifacts.write_jct(jct, None, None, single=True)
    try:
        save_final_weights(model, "wav2vec2_model")
    except Exception as e:  # noqa: BLE001 - a missing volume must not
        # kill the job
        print(f"final weight save failed: {e}")


if __name__ == "__main__":
    main()
