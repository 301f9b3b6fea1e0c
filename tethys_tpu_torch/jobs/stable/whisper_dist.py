"""Stable-tier Whisper distributed job (jobs/stable/whisper_dist.py).

    python -m tethys_tpu_torch.jobs.stable.whisper_dist --batch_size 4 \
        --num_batches 30

The reference's stable_jobs/whisper_dist.py is byte-identical to
speech_jobs/whisper_dist.py (SURVEY quirk #2), so this entry point is
``jobs.whisper_dist``'s.
"""

from tethys_tpu_torch.jobs.whisper_dist import build_parser, main

__all__ = ["build_parser", "main"]

if __name__ == "__main__":
    main()
