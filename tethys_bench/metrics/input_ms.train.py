"""input_ms.train: host milliseconds a step inside the job's
``prepare_batch`` (the training loop's input: a pageable copy for
Whisper, ``utils/device.host_to_device`` for Wav2Vec2), from the
benchmark's wrapper around the callable it hands the loop; plain window
of the traced run.

Layer: training loop; source: program_span; moves: train_audio_s_per_s."""


def read(ctx):
    seconds = ctx.spans.get("prepare_batch")
    return None if seconds is None else seconds / ctx.steps * 1e3
