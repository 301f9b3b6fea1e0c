"""dispatch_ms.train: host milliseconds a step inside the job's step
function (``parallel/dp.make_train_step``: forward, backward, clips and
Adam queued on the device), from the benchmark's wrapper; plain window of
the traced run.

Layer: train step; source: program_span; moves: train_audio_s_per_s."""


def read(ctx):
    seconds = ctx.spans.get("step_fn")
    return None if seconds is None else seconds / ctx.steps * 1e3
