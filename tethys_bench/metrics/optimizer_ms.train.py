"""optimizer_ms.train: device milliseconds a step of the kernels launched
under Keras Adam's step and the clips (``parallel/dp.KerasAdam``,
``clip_by_global_norm``), by the frozen categories of trace.py.

Layer: train step; source: device_trace; moves: train_audio_s_per_s."""


def read(ctx):
    if ctx.reading is None:
        return None
    return ctx.reading.by_group_s["optimizer"] / ctx.steps * 1e3
